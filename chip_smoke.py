#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; a failing phase raises and the script
exits nonzero without printing a result:

  device    card name and count, nvidia-smi name and power limit
  build     nvcc build of every kernel source for sm_90a (ptxas report, seconds)
  kernels   flash_attention_fwd (the Hopper kernel) against flash_attention_plain
            (its plain PyTorch version) on the same inputs, at the serving
            path's shapes and around them: o held per row, max|Δ| of a row
            over max|plain| of that row, at f32 2e-4 and bf16 3e-2 (the
            bounds of tests/test_kernels.py); lse, f32 on both sides for
            every input dtype, at 2e-4 absolute; kernel / plain / SDPA times
            (CUDA events) and the bound
  reference a small llama-shaped model (head dim 128) served on the card
            and on the CPU from the same weights: f32 logits agree to 1e-4
  serve     llama2-7b at full width (32 layers, d_model 4096, bf16 weights
            drawn on the card from a seed), batch 4, prompt 512, 32 new
            tokens through ServeEngine.generate; kernel launches counted over
            that one run (32 per prefill, 0 plain-version calls); prefill ms,
            decode ms/token, tok/s, peak memory; decode-vs-prefill at full
            width (rel < 0.08, as tests/test_models_smoke.py)

Then the kernel summary line, the nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
f32 matmuls and convolutions run without TF32 (both backends' allow_tf32 set
False) so the f32 comparisons hold full f32 precision.
"""

from __future__ import annotations

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
SEED = 0


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def band_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the causal/window band."""
    qpos = (Sk - Sq) + np.arange(Sq, dtype=np.int64)
    hi = np.clip(qpos + 1, 0, Sk) if causal else np.full(Sq, Sk)
    lo = np.clip(qpos - window + 1, 0, Sk) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def bound(B, Sq, Sk, Hq, Hkv, d, causal, window, dtype):
    """Least time the card needs: max(FLOPs / peak, bytes / HBM rate)."""
    flops = 4.0 * B * Hq * d * band_pairs(Sq, Sk, causal, window)   # QK^T and PV
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * B * d * (2 * Sq * Hq + 2 * Sk * Hkv) + 4 * B * Hq * Sq   # q,k,v,o + lse
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes"), flops, nbytes


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

    t0 = time.perf_counter()
    built = build.build()
    smem_fn = build.load("flash_attention_fwd").flash_attention_fwd_smem_bytes
    smem_fn.argtypes, smem_fn.restype = [ctypes.c_int], ctypes.c_int
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         flash_attention_fwd_smem_bytes={d: smem_fn(d) for d in (64, 128, 256)},
         libs={n: {"path": str(b.path.relative_to(Path(__file__).resolve().parent)),
                   "nvcc_s": round(b.seconds, 3), "cached": b.cached,
                   "ptxas": [ln.strip() for ln in b.ptxas.splitlines()
                             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]}
               for n, b in built.items()})


# (label, B, Sq, Sk, Hq, Hkv, d, causal, window, dtype); the first is the
# serving path's shape (llama2-7b prefill, batch 4, prompt 512).
CASES = [
    ("llama2-7b prefill", 4, 512, 512, 32, 32, 128, True, 0, torch.bfloat16),
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
]


def phase_kernels():
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    for i, (label, B, Sq, Sk, Hq, Hkv, d, causal, window, dt) in enumerate(CASES):
        main = i == 0
        q = torch.randn((B, Sq, Hq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Sk, Hkv, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Sk, Hkv, d), generator=gen, device="cuda").to(dt)
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        po, plse = flash_attention_plain(q, k, v, **kw)
        tol = TOL[dt]
        d_o = (o.float() - po.float()).abs()
        err_o = d_o.max().item()
        row_rel_o = (d_o.amax(-1) / po.float().abs().amax(-1).clamp_min(1e-30)).max().item()
        err_lse = (lse - plse).abs().max().item()
        ok = (row_rel_o <= tol and err_lse <= TOL_LSE
              and bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()))
        del d_o
        reps = 20 if main else 5
        kernel_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                           5 if main else 1, warmup=1)
        # SDPA on the same inputs, timed as a yardstick only: is_causal where
        # its top-left causal mask equals the offset one (Sq == Sk, no
        # window), else an explicit boolean mask of the band.
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        plain_mask = not window and (Sq == Sk or not causal)
        sdpa_kw = (dict(is_causal=causal) if plain_mask
                   else dict(attn_mask=band_mask(Sq, Sk, causal, window)))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=Hq != Hkv, **sdpa_kw), reps)
        bms, by, flops, nbytes = bound(B, Sq, Sk, Hq, Hkv, d, causal, window, dt)
        row = dict(case=label, B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, d=d, causal=causal,
                   window=window, dtype=str(dt).removeprefix("torch."), tol_o_row=tol,
                   tol_lse=TOL_LSE, row_rel_err_o=row_rel_o, max_abs_err_o=err_o,
                   max_abs_err_lse=err_lse, ok=ok, kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   library="sdpa is_causal" if plain_mask else "sdpa attn_mask",
                   bound_ms=bms, bound_by=by, gflop=flops / 1e9, mbytes=nbytes / 1e6,
                   tflops=flops / kernel_ms / 1e9)
        rows.append(row)
        if not ok:
            failed.append(label)
        del q, k, v, o, lse, po, plse
        torch.cuda.empty_cache()
    emit("kernels", cases=rows)
    if failed:
        raise AssertionError(f"flash_attention_fwd disagrees with its plain version: {failed}")
    return rows[0]


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / (b.abs().max() + 1e-6)).item()


def phase_reference():
    from repro_torch import configs
    from repro_torch.models import build

    cfg = configs.get("llama2-7b").with_(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2,
                                          d_ff=512, vocab_size=512, dtype="float32")
    cpu, gpu = build(cfg, device="cpu", seed=SEED), build(cfg, device="cuda")
    pc = cpu.init()
    pg = gpu.load({k: v.cuda() for k, v in pc.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 100)))
    cc, lc = cpu.prefill(pc, cpu.init_cache(2, 104), toks)
    cg, lg = gpu.prefill(pg, gpu.init_cache(2, 104), toks.cuda())
    rel = [_rel(lg.cpu(), lc)]
    nxt = lc.argmax(-1)
    for _ in range(3):
        cc, lc = cpu.decode_step(pc, cc, nxt)
        cg, lg = gpu.decode_step(pg, cg, nxt.cuda())
        rel.append(_rel(lg.cpu(), lc))
        nxt = lc.argmax(-1)
    emit("reference", cfg="llama2-7b widths cut to 2 layers, d_model 256, 2 heads of 128, "
         "f32", prefill_then_decode_rel=rel, tol=1e-4)
    if max(rel) >= 1e-4:
        raise AssertionError(f"card and CPU paths disagree: {rel}")


def phase_serve():
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeEngine

    cfg = configs.get("llama2-7b")
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
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    flash_attention_plain.calls = 0
    t0 = time.perf_counter()
    out = engine.generate(tokens, steps=G)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches, plain_calls = flash_attention_fwd.launches, flash_attention_plain.calls
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.n_layers or plain_calls != 0:
        raise AssertionError(f"prefill made {launches} kernel launches and {plain_calls} "
                             f"plain calls; expected {cfg.n_layers} and 0")
    if out.shape != (B, G + 1) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"bad generate output {tuple(out.shape)}")

    t0 = time.perf_counter()
    out2 = engine.generate(tokens, steps=G)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not torch.equal(out, out2):
        raise AssertionError("greedy decoding is not repeatable")

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

    # Decode must continue prefill: prefill(t[:k]) + decode(t[k]) vs prefill(t[:k+1]).
    k = P - 1
    cache, _ = model.prefill(params, model.init_cache(B, P + 1), tokens[:, :k])
    _, dec = model.decode_step(params, cache, tokens[:, k])
    _, par = model.prefill(params, model.init_cache(B, P + 1), tokens)
    rel = _rel(dec, par)
    finite = bool(torch.isfinite(dec.float()).all() and torch.isfinite(par.float()).all())
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=n_params, dtype="bfloat16", batch=B, prompt=P, gen=G,
         init_s=init_s, cold_generate_s=cold_s, warm_generate_s=warm_s,
         tok_per_s=B * G / warm_s, prefill_ms=min(prefill_s) * 1e3,
         prefill_ms_all=[s * 1e3 for s in prefill_s], decode_ms_per_token=decode_ms,
         decode_tok_per_s=B / decode_ms * 1e3, max_memory_allocated=peak,
         flash_launches=launches, plain_calls=plain_calls,
         decode_vs_prefill_rel=rel, logits_finite=finite, first_tokens=out[0, :8].tolist())
    if not finite or rel >= 0.08:
        raise AssertionError(f"decode/prefill mismatch at full width: rel={rel}")
    phase_trace(model, params, tokens, P + G + 1)
    return launches


def phase_trace(model, params, tokens, max_len: int, steps: int = 8):
    """torch.profiler over one prefill and `steps` decode steps (warm): device
    time by kernel, and the device's idle share of each window's wall time."""
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
                      "top": [{"kernel": n[:90], "ms": ms, "count": c} for n, ms, c in kern[:8]]}
    emit("trace", note="device time from torch.profiler (CUPTI); profiler on, so wall "
         "times exceed the serve phase's", **out)


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
    main_case = phase_kernels()
    phase_reference()
    launches = phase_serve()
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:110",
        "launches": launches,
        "max_abs_err": main_case["max_abs_err_o"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }], "seconds": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
