#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; a failing phase raises and the script
exits nonzero without printing a result:

  device    card name and count, nvidia-smi name and power limit
  build     nvcc build of every kernel source for sm_90a (ptxas report,
            seconds, shared memory per block for both dtypes of flash and
            SSD, bf16 SSD blocks per SM)
  kernels   each Hopper kernel against its plain PyTorch version on the
            same inputs, at its serving path's shape and around it, with
            kernel / plain (/ library) times and the bound (kernels and
            SDPA as CUDA-graph replays, device time only; the eager
            CUDA-event time, which includes the host's, beside them; the
            plain versions by CUDA events):
            flash_attention_fwd: o held per row, max|Δ| of a row over
              max|plain| of that row, at f32 2e-4 and bf16 3e-2 (the bounds
              of tests/test_kernels.py); lse, f32 on both sides for every
              input dtype, at 2e-4 absolute; SDPA as the library yardstick,
              and kernel_vs_library = kernel ms / SDPA ms;
            ssd_scan_fwd: y held at max|Δ| / max|plain| <= f32 2e-5, bf16
              3e-2, h_last at 2e-5 relative (tests/test_kernels.py:73);
            wkv6_fwd: y and S_last at 2e-5 relative (tests/test_kernels.py:88),
              the chunk kernels at S > 1 and the decode kernel at S = 1
  reference small llama (head dim 128), zamba2 (SSD scan, attention head dim
            112) and rwkv6 models served on the card and on the CPU from
            the same weights: f32 logits of prefill and 3 decode steps agree
            to 1e-4
  serve     llama2-7b, zamba2-7b and rwkv6-1.6b at full width (bf16 weights
            drawn on the card from a seed), one after the other, batch 4,
            prompt 512, 32 new tokens through ServeEngine.generate; kernel
            launches counted over that one run (llama2-7b: 32 flash per
            prefill; zamba2-7b: 81 SSD and 13 flash per prefill; rwkv6-1.6b:
            24 WKV6 per prefill and per decode step, 792 in all, 768 of
            them by the S = 1 decode kernel; 0 plain-
            version calls); repeatable greedy output; prefill ms, decode
            ms/token, tok/s, peak memory; decode-vs-prefill at full width
            (rel < 0.08, as tests/test_models_smoke.py)
  trace     per served model: torch.profiler over one prefill and 8 decode
            steps, device time by kernel (the top 8, and each port kernel
            with its share of the busy time) and the device's idle share

Then the kernel summary line, the nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
f32 matmuls and convolutions run without TF32 (both backends' allow_tf32 set
False) so the f32 comparisons hold full f32 precision.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # H100 SXM dense
PEAK_BYTES = 3.35e12                                           # H100 SXM HBM3
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}   # o: max|Δ| / max|plain| of each row
TOL_LSE = 2e-4                                       # lse (f32 for every dtype): absolute
TOL_SCAN = {torch.bfloat16: 3e-2, torch.float32: 2e-5}   # SSD y: max|Δ| / max|plain|
TOL_STATE = 2e-5                                     # WKV6 y, and every state: relative
SEED = 0


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2, warm_s: float = 0.05) -> float:
    """Mean device time of one call, by CUDA events around `reps` calls, after
    at least `warmup` calls and `warm_s` seconds of them (an idle card's
    clocks take a while to rise: without this the first case timed read 30%
    above its device time in the profiler trace)."""
    t0, n = time.perf_counter(), 0
    while n < warmup or time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
        n += 1
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int, warm_s: float = 0.05) -> float:
    """Mean device time of one call, by CUDA events around the replay of one
    CUDA graph of `reps` calls, so the host's cost per call (about 0.04 ms
    for the flash wrapper, as much for an SDPA call) is not timed: eager
    back-to-back calls of a 0.05 ms function measure the host."""
    for _ in range(2):
        fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        g.replay()
        torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    t1.synchronize()
    del g
    # cuBLAS keeps a workspace per stream: the capture stream's stayed
    # allocated and added 64 MiB to every served model's peak memory.
    torch._C._cuda_clearCublasWorkspaces()
    return t0.elapsed_time(t1) / reps


def bound_ms(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time the card needs: max(operations / peak, bytes / HBM rate)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def rel_err(got, want) -> float:
    """max|Δ| / max|want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def band_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the causal/window band."""
    qpos = (Sk - Sq) + np.arange(Sq, dtype=np.int64)
    hi = np.clip(qpos + 1, 0, Sk) if causal else np.full(Sq, Sk)
    lo = np.clip(qpos - window + 1, 0, Sk) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def bound(B, Sq, Sk, Hq, Hkv, d, causal, window, dtype):
    """Flash attention: least time for QK^T and PV over the band, q/k/v/o/lse bytes."""
    flops = 4.0 * B * Hq * d * band_pairs(Sq, Sk, causal, window)
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * B * d * (2 * Sq * Hq + 2 * Sk * Hkv) + 4 * B * Hq * Sq
    return (*bound_ms(flops, nbytes, dtype), flops, nbytes)


def band_mask(Sq: int, Sk: int, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Sk) bool, True where query row i (key position Sk - Sq + i) sees key j."""
    qpos = (Sk - Sq) + torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(Sk, device="cuda")[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        m &= kpos <= qpos
    if window:
        m &= qpos - kpos < window
    return m


def chunk_rows(S: int, Q: int):
    """Valid rows of each chunk of Q over S."""
    return [min(Q, S - c0) for c0 in range(0, S, Q)]


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return name, smi


def phase_build():
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    from repro_torch.kernels.ssd_scan import SHAPES
    from repro_torch.kernels.wkv6 import HEAD_DIMS as WKV_DIMS

    t0 = time.perf_counter()
    built = build.build()

    def int_fn(lib, fn_name, nargs):
        fn = getattr(build.load(lib), fn_name)
        fn.argtypes, fn.restype = [ctypes.c_int] * nargs, ctypes.c_int
        return fn

    fa = int_fn("flash_attention_fwd", "flash_attention_fwd_smem_bytes", 2)
    ssd = int_fn("ssd_scan_fwd", "ssd_scan_fwd_smem_bytes", 3)
    ssd_occ = int_fn("ssd_scan_fwd", "ssd_scan_fwd_bf16_blocks_per_sm", 0)
    wkv = int_fn("wkv6_fwd", "wkv6_fwd_smem_bytes", 2)
    wkv_occ = int_fn("wkv6_fwd", "wkv6_fwd_bf16_blocks_per_sm", 0)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         smem_bytes={"flash_attention_fwd": {dt: {d: fa(d, code) for d in HEAD_DIMS}
                                             for dt, code in (("bfloat16", 1),
                                                              ("float32", 0))},
                     "ssd_scan_fwd": {dt: {f"P={p},N={n}": ssd(p, n, code) for p, n in SHAPES}
                                      for dt, code in (("bfloat16", 1), ("float32", 0))},
                     "wkv6_fwd": {dt: {d: wkv(d, code) for d in WKV_DIMS}
                                  for dt, code in (("bfloat16", 1), ("float32", 0))}},
         ssd_bf16_blocks_per_sm=ssd_occ(), wkv6_bf16_blocks_per_sm=wkv_occ(),
         libs={n: {"path": str(b.path.relative_to(Path(__file__).resolve().parent)),
                   "nvcc_s": round(b.seconds, 3), "cached": b.cached,
                   "ptxas": [ln.strip() for ln in b.ptxas.splitlines()
                             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]}
               for n, b in built.items()})


# (label, B, Sq, Sk, Hq, Hkv, d, causal, window, dtype[, packed]); the first
# is the serving path's shape (llama2-7b prefill, batch 4, prompt 512).
# packed: q, k, v are strided views of one (B, S, 3, H, d) buffer.
CASES = [
    ("llama2-7b prefill", 4, 512, 512, 32, 32, 128, True, 0, torch.bfloat16),
    ("packed (B,S,3,H,d) views", 4, 512, 512, 32, 32, 128, True, 0, torch.bfloat16, True),
    ("qwen2-72b GQA 64:8", 4, 512, 512, 64, 8, 128, True, 0, torch.bfloat16),
    ("ragged S=17", 4, 17, 17, 32, 32, 128, True, 0, torch.bfloat16),
    ("llama2-7b S=2048", 4, 2048, 2048, 32, 32, 128, True, 0, torch.bfloat16),
    ("llama2-7b S=4096", 4, 4096, 4096, 32, 32, 128, True, 0, torch.bfloat16),
    ("gemma-2b MQA d=256", 4, 512, 512, 8, 1, 256, True, 0, torch.bfloat16),
    ("gpt2-1.5b d=64", 4, 512, 512, 25, 25, 64, True, 0, torch.bfloat16),
    ("starcoder2-3b window 4096, S=8192", 1, 8192, 8192, 24, 2, 128, True, 4096, torch.bfloat16),
    ("Sq < Sk (chunk 128 after 512)", 4, 128, 640, 32, 32, 128, True, 0, torch.bfloat16),
    ("ragged S=1000", 2, 1000, 1000, 32, 32, 128, True, 0, torch.bfloat16),
    ("bidirectional", 2, 512, 512, 32, 32, 128, False, 0, torch.bfloat16),
    ("llama2-7b prefill f32", 4, 512, 512, 32, 32, 128, True, 0, torch.float32),
    ("gemma-2b MQA d=256 f32", 2, 512, 512, 8, 1, 256, True, 0, torch.float32),
    ("gpt2-1.5b ragged S=300 f32", 2, 300, 300, 25, 25, 64, True, 0, torch.float32),
    ("zamba2-7b shared block d=112", 4, 512, 512, 32, 32, 112, True, 0, torch.bfloat16),
]


def phase_kernels():
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    for i, (label, B, Sq, Sk, Hq, Hkv, d, causal, window, dt, *packed) in enumerate(CASES):
        main = i == 0
        q = torch.randn((B, Sq, Hq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Sk, Hkv, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Sk, Hkv, d), generator=gen, device="cuda").to(dt)
        if packed:
            buf = torch.stack((q, k, v), dim=2)
            q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
            del buf
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        po, plse = flash_attention_plain(q, k, v, **kw)
        tol = TOL[dt]
        d_o = (o.float() - po.float()).abs()
        err_o = d_o.max().item()
        row_rel_o = (d_o.amax(-1) / po.float().abs().amax(-1).clamp_min(1e-30)).max().item()
        err_lse = (lse - plse).abs().max().item()
        ok = row_rel_o <= tol and err_lse <= TOL_LSE and finite(o, lse)
        del d_o
        reps = 50 if main else 10
        kernel_ms_eager = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw), reps)
        kernel_ms = graph_ms(lambda: flash_attention_fwd(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                           5 if main else 1, warmup=1)
        # SDPA on the same inputs, timed as a yardstick only: is_causal where
        # its top-left causal mask equals the offset one (Sq == Sk, no
        # window), else an explicit boolean mask of the band.
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        plain_mask = not window and (Sq == Sk or not causal)
        sdpa_kw = (dict(is_causal=causal) if plain_mask
                   else dict(attn_mask=band_mask(Sq, Sk, causal, window)))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=Hq != Hkv, **sdpa_kw), reps)
        bms, by, flops, nbytes = bound(B, Sq, Sk, Hq, Hkv, d, causal, window, dt)
        row = dict(case=label, B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, d=d, causal=causal,
                   window=window, dtype=str(dt).removeprefix("torch."), tol_o_row=tol,
                   tol_lse=TOL_LSE, row_rel_err_o=row_rel_o, max_abs_err_o=err_o,
                   max_abs_err_lse=err_lse, ok=ok, kernel_ms=kernel_ms,
                   kernel_ms_eager=kernel_ms_eager, plain_ms=plain_ms,
                   library_ms=library_ms, kernel_vs_library=kernel_ms / library_ms,
                   library="sdpa is_causal" if plain_mask else "sdpa attn_mask",
                   packed=bool(packed),
                   bound_ms=bms, bound_by=by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
                   tflops=flops / kernel_ms / 1e9)
        rows.append(row)
        if not ok:
            failed.append(label)
        del q, k, v, o, lse, po, plse
        torch.cuda.empty_cache()
    emit("kernels", kernel="flash_attention_fwd", cases=rows)
    if failed:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain version: {failed}")
    return rows[0]


# (label, B, S, H, P, N, h0, dtype); the first is the serving path's shape
# (zamba2-7b prefill: batch 4, prompt 512, 112 heads of 64, state 64).
SSD_CASES = [
    ("zamba2-7b prefill", 4, 512, 112, 64, 64, False, torch.bfloat16),
    ("zamba2-7b prefill f32", 4, 512, 112, 64, 64, False, torch.float32),
    ("ragged S=1000", 2, 1000, 112, 64, 64, False, torch.bfloat16),
    ("ragged S=300 f32", 2, 300, 112, 64, 64, False, torch.float32),
    ("h0 in, h_last out", 4, 512, 112, 64, 64, True, torch.bfloat16),
    ("h0 in, h_last out, ragged S=300 f32", 2, 300, 112, 64, 64, True, torch.float32),
    ("S=4096", 4, 4096, 112, 64, 64, False, torch.bfloat16),
]


def ssd_bound(B, S, H, P, N, h0, dtype, Q=64):
    """Bytes: x, B, C (dtype), dt (f32), A, h0 read once; y (dtype) and h_last
    (f32) written once.  Operations: the chunked products on the unmasked
    half (C B^T and G xdt over i >= j, C h and the state update), 2 per
    multiply-add."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (2 * B * S * H * P + 2 * B * S * N) + 4 * B * S * H + 4 * H
              + 4 * B * H * P * N * (2 if h0 else 1))
    mac = sum(n * (n + 1) // 2 * (N + P) + 2 * n * P * N for n in chunk_rows(S, Q))
    flops = 2.0 * B * H * mac
    return (*bound_ms(flops, nbytes, dtype), flops, nbytes)


def phase_ssd_kernels():
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    for i, (label, B, S, H, P, N, with_h0, dt) in enumerate(SSD_CASES):
        main = i == 0
        # x, B, C as views of one conv output, as mamba2_apply passes them
        conv = torch.randn((B, S, H * P + 2 * N), generator=gen, device="cuda").to(dt)
        x = conv[..., :H * P].view(B, S, H, P)
        Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
        dtv = 0.05 + 0.95 * torch.rand((B, S, H), generator=gen, device="cuda")
        A = -(0.3 + 1.7 * torch.rand((H,), generator=gen, device="cuda"))
        h0 = (torch.randn((B, H, P, N), generator=gen, device="cuda") if with_h0 else None)
        args = (x, dtv, A, Bm, Cm, h0)
        y, h = ssd_scan_fwd(*args)
        torch.cuda.synchronize()
        py, ph = ssd_scan_plain(*args)
        err_y, err_h = rel_err(y, py), rel_err(h, ph)
        ok = err_y <= TOL_SCAN[dt] and err_h <= TOL_STATE and finite(y, h)
        reps = 50 if main else 10
        kernel_ms_eager = cuda_ms(lambda: ssd_scan_fwd(*args), reps)
        kernel_ms = graph_ms(lambda: ssd_scan_fwd(*args), reps)
        plain_ms = cuda_ms(lambda: ssd_scan_plain(*args), 5 if main else 1, warmup=1)
        bms, by, flops, nbytes = ssd_bound(B, S, H, P, N, with_h0, dt)
        rows.append(dict(case=label, B=B, S=S, H=H, P=P, N=N, h0=with_h0,
                         dtype=str(dt).removeprefix("torch."), tol_y=TOL_SCAN[dt],
                         tol_state=TOL_STATE, rel_err_y=err_y, rel_err_h_last=err_h,
                         max_abs_err_y=(y.float() - py.float()).abs().max().item(),
                         ok=ok, kernel_ms=kernel_ms, kernel_ms_eager=kernel_ms_eager,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                         x_bound=kernel_ms / bms, gflop=flops / 1e9, mbytes=nbytes / 1e6,
                         tflops=flops / kernel_ms / 1e9, gbytes_per_s=nbytes / kernel_ms / 1e6))
        if not ok:
            failed.append(label)
        del conv, x, Bm, Cm, dtv, A, h0, y, h, py, ph, args
        torch.cuda.empty_cache()
    emit("kernels", kernel="ssd_scan_fwd", cases=rows)
    if failed:
        raise AssertionError(f"ssd_scan_fwd disagrees with its plain version: {failed}")
    return rows[0]


# (label, B, S, H, hd, s0, dtype of r/k/v[, decay]); the first is the
# serving path's shape (rwkv6-1.6b prefill: batch 4, prompt 512, 32 heads of
# 64).  logw is drawn from -0.02 to -3 a step, or, with decay "model", as the
# served model forms it: -exp(w0 + small) with w0 = -2.
WKV_CASES = [
    ("rwkv6-1.6b prefill", 4, 512, 32, 64, False, torch.bfloat16),
    ("rwkv6-1.6b prefill f32", 4, 512, 32, 64, False, torch.float32),
    ("ragged S=1000", 2, 1000, 32, 64, False, torch.bfloat16),
    ("ragged S=300 f32", 2, 300, 32, 64, False, torch.float32),
    ("s0 in, S_last out", 4, 512, 32, 64, True, torch.bfloat16),
    ("decode step S=1", 4, 1, 32, 64, True, torch.bfloat16),
    ("S=4096", 4, 4096, 32, 64, False, torch.bfloat16),
    ("ragged S=33", 4, 33, 32, 64, True, torch.bfloat16),
    ("decode step S=1 batch 1", 1, 1, 32, 64, True, torch.bfloat16),
    ("rwkv6 model decay", 4, 512, 32, 64, True, torch.bfloat16, "model"),
]
WKV_DECODE_CASE = "decode step S=1"      # the decode kernel's row in the summary


def wkv_bound(B, S, H, hd, s0, dtype, Q=32):
    """Bytes: r, k, v (dtype), logw (f32), u, s0 read once; y and S_last (f32)
    written once.  Operations: per chunk the strict-lower scores (an
    exponential and 3 operations per (t, i, c)), the bonus, y = A v, the
    inter-chunk (r o e^{cw-w}) S, the state update, and the 2 exponentials
    per (t, c) that form r o e^{cw-w} and k o e^{cw_Q-cw}."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * 3 * B * S * H * hd + 4 * B * S * H * hd + 4 * H * hd
              + 4 * B * S * H * hd + 4 * B * H * hd * hd * (2 if s0 else 1))
    ops = sum(n * (n - 1) // 2 * hd * 4 + n * hd * 3 + n * (n + 1) // 2 * hd * 2
              + 4 * n * hd * hd + 2 * n * hd for n in chunk_rows(S, Q))
    flops = float(B * H * ops)
    return (*bound_ms(flops, nbytes, dtype), flops, nbytes)


def phase_wkv_kernels():
    from repro_torch.kernels.wkv6 import wkv6_fwd, wkv6_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    for i, (label, B, S, H, hd, with_s0, dt, *decay) in enumerate(WKV_CASES):
        main = i == 0 or label == WKV_DECODE_CASE        # a row of the summary line
        r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt)
                   for _ in range(3))
        if decay == ["model"]:
            logw = -torch.exp(-2.0 + 0.01 * torch.randn((B, S, H, hd), generator=gen,
                                                        device="cuda"))
        else:
            logw = -(0.02 + 2.98 * torch.rand((B, S, H, hd), generator=gen, device="cuda"))
        u = 0.5 * torch.randn((H, hd), generator=gen, device="cuda")
        s0 = torch.randn((B, H, hd, hd), generator=gen, device="cuda") if with_s0 else None
        args = (r, k, v, logw, u, s0)
        y, s = wkv6_fwd(*args)
        torch.cuda.synchronize()
        py, ps = wkv6_plain(*args)
        err_y, err_s = rel_err(y, py), rel_err(s, ps)
        ok = (err_y <= TOL_STATE and err_s <= TOL_STATE and finite(y, s)
              and y.dtype == torch.float32)
        reps = 50 if main else 10
        kernel_ms_eager = cuda_ms(lambda: wkv6_fwd(*args), reps)
        kernel_ms = graph_ms(lambda: wkv6_fwd(*args), reps)
        plain_ms = cuda_ms(lambda: wkv6_plain(*args), 5 if main else 1, warmup=1)
        bms, by, flops, nbytes = wkv_bound(B, S, H, hd, with_s0, dt)
        rows.append(dict(case=label, B=B, S=S, H=H, hd=hd, s0=with_s0,
                         decay=decay[0] if decay else "uniform -0.02..-3",
                         dtype=str(dt).removeprefix("torch."), tol=TOL_STATE,
                         rel_err_y=err_y, rel_err_s_last=err_s,
                         max_abs_err_y=(y - py).abs().max().item(), ok=ok,
                         kernel_ms=kernel_ms, kernel_ms_eager=kernel_ms_eager,
                         plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                         x_bound=kernel_ms / bms, gflop=flops / 1e9, mbytes=nbytes / 1e6,
                         tflops=flops / kernel_ms / 1e9, gbytes_per_s=nbytes / kernel_ms / 1e6))
        if not ok:
            failed.append(label)
        del r, k, v, logw, u, s0, y, s, py, ps, args
        torch.cuda.empty_cache()
    emit("kernels", kernel="wkv6_fwd", cases=rows)
    if failed:
        raise AssertionError(f"wkv6_fwd disagrees with its plain version: {failed}")
    return rows[0], next(row for row in rows if row["case"] == WKV_DECODE_CASE)


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() + 1e-6)).item()


# Small f32 configurations for the card-vs-CPU check, cut from the full ones
# so that every kernel instantiation the serving paths use runs.
REFERENCE = {
    "llama2-7b": ("2 layers, d_model 256, 2 heads of 128",
                  dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, d_ff=512)),
    "zamba2-7b": ("4 layers (shared block after layers 1 and 3), d_model 256, SSD heads "
                  "of 64 with state 64, 2 attention heads of 112",
                  dict(n_layers=4, d_model=256, n_heads=2, n_kv_heads=2, head_dim=112,
                       d_ff=512, ssm_state=64, ssm_head_dim=64, attn_every=2)),
    "rwkv6-1.6b": ("2 layers, d_model 256, 4 WKV heads of 64",
                   dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                        rwkv_head_dim=64, rwkv_lora_decay=16, rwkv_lora_mix=16)),
}


def phase_reference():
    from repro_torch import configs
    from repro_torch.models import build

    out, failed = {}, []
    for arch, (what, cut) in REFERENCE.items():
        cfg = configs.get(arch).with_(vocab_size=512, dtype="float32", **cut)
        cpu, gpu = build(cfg, device="cpu", seed=SEED), build(cfg, device="cuda")
        pc = cpu.init()
        pg = gpu.load({k: v.cuda() for k, v in pc.state_dict().items()})
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                                     (2, 100)))
        cc, lc = cpu.prefill(pc, cpu.init_cache(2, 104), toks)
        cg, lg = gpu.prefill(pg, gpu.init_cache(2, 104), toks.cuda())
        rel = [_rel(lg.cpu(), lc)]
        nxt = lc.argmax(-1)
        for _ in range(3):
            cc, lc = cpu.decode_step(pc, cc, nxt)
            cg, lg = gpu.decode_step(pg, cg, nxt.cuda())
            rel.append(_rel(lg.cpu(), lc))
            nxt = lc.argmax(-1)
        out[arch] = {"cfg": f"{arch} widths cut to {what}, f32, prompt 100",
                     "prefill_then_decode_rel": rel}
        if max(rel) >= 1e-4:
            failed.append(arch)
    emit("reference", tol=1e-4, **out)
    if failed:
        raise AssertionError(f"card and CPU paths disagree: {failed}")


def kernel_counters():
    from repro_torch.kernels import flash_attention, ssd_scan, wkv6

    return {"flash_attention_fwd": (flash_attention.flash_attention_fwd,
                                    flash_attention.flash_attention_plain),
            "ssd_scan_fwd": (ssd_scan.ssd_scan_fwd, ssd_scan.ssd_scan_plain),
            "wkv6_fwd": (wkv6.wkv6_fwd, wkv6.wkv6_plain)}


# Served at full width, one after the other: the launches each kernel must
# make over one generate call of G decode steps.
SERVED = {
    "llama2-7b": lambda cfg, G: {"flash_attention_fwd": cfg.n_layers},
    "zamba2-7b": lambda cfg, G: {"ssd_scan_fwd": cfg.n_layers,
                                 "flash_attention_fwd": cfg.n_layers // cfg.attn_every},
    "rwkv6-1.6b": lambda cfg, G: {"wkv6_fwd": cfg.n_layers * (G + 1),
                                  "wkv6_decode": cfg.n_layers * G},
}


def phase_serve(arch: str) -> dict[str, int]:
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeEngine

    cfg = configs.get(arch)
    B, P, G = 4, 512, 32
    model = build(cfg, device="cuda", seed=SEED)
    t0 = time.perf_counter()
    params = model.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    engine = ServeEngine(model, params, max_len=P + G + 1)
    tokens = torch.from_numpy(
        np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, P))).cuda()

    # The counted run: one generate call, nothing else.
    counters = kernel_counters()
    want = SERVED[arch](cfg, G)
    torch.cuda.reset_peak_memory_stats()
    for fwd, plain in counters.values():
        fwd.launches = 0
        plain.calls = 0
    wkv6_fwd = counters["wkv6_fwd"][0]
    wkv6_fwd.decode_launches = 0
    t0 = time.perf_counter()
    out = engine.generate(tokens, steps=G)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {name: fwd.launches for name, (fwd, _) in counters.items()}
    launches["wkv6_decode"] = wkv6_fwd.decode_launches
    plain_calls = {name: plain.calls for name, (_, plain) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    expected = {name: want.get(name, 0) for name in launches}
    if launches != expected or any(plain_calls.values()):
        raise AssertionError(f"{arch}: generate made {launches} kernel launches and "
                             f"{plain_calls} plain calls; expected {expected} and none")
    if out.shape != (B, G + 1) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{arch}: bad generate output {tuple(out.shape)}")

    t0 = time.perf_counter()
    out2 = engine.generate(tokens, steps=G)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not torch.equal(out, out2):
        raise AssertionError(f"{arch}: greedy decoding is not repeatable")

    prefill_s = []
    for _ in range(3):
        cache = model.init_cache(B, P + G + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, cache, tokens)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(G):
        cache, logits = model.decode_step(params, cache, tok)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / G * 1e3
    del cache, logits

    # Decode must continue prefill: prefill(t[:k]) + decode(t[k]) vs prefill(t[:k+1]).
    k = P - 1
    cache, _ = model.prefill(params, model.init_cache(B, P + 1), tokens[:, :k])
    _, dec = model.decode_step(params, cache, tokens[:, k])
    _, par = model.prefill(params, model.init_cache(B, P + 1), tokens)
    rel = _rel(dec, par)
    ok = finite(dec.float(), par.float())
    del cache
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=n_params, dtype="bfloat16", batch=B, prompt=P, gen=G,
         init_s=init_s, cold_generate_s=cold_s, warm_generate_s=warm_s,
         tok_per_s=B * G / warm_s, prefill_ms=min(prefill_s) * 1e3,
         prefill_ms_all=[s * 1e3 for s in prefill_s], decode_ms_per_token=decode_ms,
         decode_tok_per_s=B / decode_ms * 1e3, max_memory_allocated=peak,
         launches=launches, plain_calls=plain_calls,
         decode_vs_prefill_rel=rel, logits_finite=ok, first_tokens=out[0, :8].tolist())
    if not ok or rel >= 0.08:
        raise AssertionError(f"{arch}: decode/prefill mismatch at full width: rel={rel}")
    phase_trace(arch, model, params, tokens, P + G + 1)
    del engine, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# Device-side names of the port's kernels, as the profiler lists them.
PORT_KERNEL_NAMES = ("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel", "ssd_fwd_bf16_kernel",
                     "ssd_fwd_f32_kernel", "wkv6_fwd_bf16_kernel", "wkv6_fwd_f32_kernel",
                     "wkv6_decode_kernel")


def phase_trace(arch, model, params, tokens, max_len: int, steps: int = 8):
    """torch.profiler over one prefill and `steps` decode steps (warm): device
    time by kernel (the top 8, and each of the port's kernels with its share
    of the busy time), and the device's idle share of each window's wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label in ("prefill", "decode"):
        cache, logits = model.prefill(params, model.init_cache(tokens.shape[0], max_len), tokens)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if label == "prefill":
                model.prefill(params, model.init_cache(tokens.shape[0], max_len), tokens)
            else:
                for _ in range(steps):
                    cache, logits = model.decode_step(params, cache, tok)
                    tok = logits.argmax(-1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
                for e in prof.key_averages()
                if getattr(e, "device_type", None) is not None
                and str(e.device_type).endswith("CUDA")]
        kern = [k for k in kern if k[1] > 0]
        busy = sum(ms for _, ms, _ in kern)
        kern.sort(key=lambda k: -k[1])
        out[label] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                      "idle_share": 1 - busy / wall_ms if kern else None,
                      "steps": 1 if label == "prefill" else steps,
                      "top": [{"kernel": n[:90], "ms": ms, "count": c} for n, ms, c in kern[:8]],
                      "port_kernels": [{"kernel": n[:90], "ms": ms, "count": c,
                                        "share_of_busy": ms / busy}
                                       for n, ms, c in kern if any(
                                           t in n for t in PORT_KERNEL_NAMES)]}
        del cache, logits
    emit("trace", arch=arch, note="device time from torch.profiler (CUPTI); profiler on, "
         "so wall times exceed the serve phase's", **out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    mains = {"flash_attention_fwd": phase_kernels(), "ssd_scan_fwd": phase_ssd_kernels()}
    mains["wkv6_fwd"], mains["wkv6_decode"] = phase_wkv_kernels()
    phase_reference()
    by_path = {arch: phase_serve(arch) for arch in SERVED}
    # wkv6_fwd's launch count holds every call of its wrapper; the S = 1 ones
    # ran the decode kernel, reported as a kernel of its own.
    for counts in by_path.values():
        counts["wkv6_fwd"] -= counts["wkv6_decode"]
    sources = {
        "flash_attention_fwd": ("flash_attention_fwd.cu", "flash_attention.py:110",
                                "max_abs_err_o"),
        "ssd_scan_fwd": ("ssd_scan_fwd.cu", "ssd_scan.py:77", "max_abs_err_y"),
        "wkv6_fwd": ("wkv6_fwd.cu", "wkv6.py:76", "max_abs_err_y"),
        "wkv6_decode": ("wkv6_fwd.cu", "wkv6.py:76", "max_abs_err_y"),
    }
    kernels = []
    for kname, (src, tpu, err_key) in sources.items():
        main_case = mains[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": sum(counts[kname] for counts in by_path.values()),
            "launches_by_path": {arch: counts[kname] for arch, counts in by_path.items()
                                 if counts[kname]},
            "max_abs_err": main_case[err_key],
            "ms": main_case["kernel_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
        })
    print(json.dumps({"kernels": kernels, "seconds": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
