#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --bwd-compare {ssd_scan_bwd,wkv6_bwd} [OTHER.cu ...]

The second form builds one backward kernel from its source in csrc/ and
from each other version of it named (e.g. an earlier one), checks each in
bf16 against its plain version at its train shape (zamba2-7b or
rwkv6-1.6b), twice for bit-repeatability, times them in turns (CUDA-graph
replays), then prints the card's name and power limit; nothing else runs.

Phases, each printing one JSON line; a failing phase raises and the script
exits nonzero without printing a result:

  device    card name and count, nvidia-smi name and power limit
  build     nvcc build of every kernel source for sm_90a (ptxas report:
            registers and spills of each kernel; seconds; shared memory per
            block for both dtypes of flash, SSD and the SSD and WKV6
            backward; bf16 blocks per SM of the SSD forward and of the SSD
            and WKV6 backward kernels)
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
              and kernel_vs_library = kernel ms / SDPA ms; the profile
              phase's gpt2-1.5b shape (b 16 x s 1024) among the cases; the
              d 192 / dv 128 instantiation (MLA) at deepseek-v3-671b's
              prefill (B 4, S 512, 128:128 heads, v a view of the model's
              decompressed (B,S,H,256) buffer) in bf16 and f32, ragged
              S = 300 and Sq < Sk, its bound taking d and dv apart (SDPA
              "none" where it refuses dv != d); the d 96 instantiation at
              phi-3-vision-4.2b's prefill (B 4, S 1088 = 576 patches + 512
              tokens, 32:32 heads), ragged S = 300 and f32; non-causal at
              seamless-m4t-large-v2's encoder (B 4, S 1024, 16:16 heads,
              d 64) and cross-attention (Sq 512 < Sk 1024), and Sq 1500 >
              Sk 1024;
            ssd_scan_fwd: y held at max|Δ| / max|plain| <= f32 2e-5, bf16
              3e-2, h_last at 2e-5 relative (tests/test_kernels.py:73);
            wkv6_fwd: y and S_last at 2e-5 relative (tests/test_kernels.py:88),
              the chunk kernels at S > 1 and the decode kernel at S = 1
  reference small llama (head dim 128), zamba2 (SSD scan, attention head dim
            112), rwkv6, moonshot (1 dense + 1 MoE layer, 8 experts top-2)
            and deepseek-v3 (the same with MLA at its full per-head dims, so
            the d 192 / dv 128 kernel runs), seamless-m4t (2 encoder + 2
            decoder layers, 4 heads of 64, 128 frames: the non-causal
            kernel) and phi-3-vision (2 layers, 2 heads of 96: the d 96
            kernel, 16 patches) models served on the card and on the CPU
            from the same weights and modality stub (from SEED): logits of
            prefill and 3 decode steps agree to 1e-4 in f32 and 3e-2 in
            bf16.  The MoE models'
            CPU calls replay the card's expert picks (a near-tie flips on
            bf16 rounding); the CPU's router on each card call's own input
            must pick the same experts (a fault names the token's top-k
            margin), and in f32 so must the CPU run's router on its own
            inputs (in bf16 such flips are counted, with their margins)
  serve     llama2-7b, zamba2-7b, rwkv6-1.6b, moonshot-v1-16b-a3b (48 layers,
            28.4e9 parameters), deepseek-v3-671b (every width, depth cut
            to 4 layers: 3 dense, 1 MoE of 256 experts, the MTP block),
            seamless-m4t-large-v2 (24 + 24 layers, 1,024 frames) and
            phi-3-vision-4.2b (32 layers, 576 patches before the prompt's
            512 tokens) at full width (bf16 weights
            drawn on the card from a seed), one after the other, batch 4,
            prompt 512, 32 new tokens through ServeEngine.generate; kernel
            launches counted over that one run (llama2-7b: 32 flash per
            prefill; zamba2-7b: 81 SSD and 13 flash per prefill; rwkv6-1.6b:
            24 WKV6 per prefill and per decode step, 792 in all, 768 of
            them by the S = 1 decode kernel; moonshot and deepseek: one
            flash per layer a prefill, at d 192 / dv 128 for deepseek;
            seamless: 72 a prefill, 48 of them non-causal (each encoder
            layer, each decoder layer's cross-attention); phi-3-vision: 32
            at d 96; 0 plain-version calls); repeatable greedy output; prefill ms,
            decode ms/token, tok/s, peak memory; decode-vs-prefill at full
            width (rel < 0.08, as tests/test_models_smoke.py; MoE at its
            capacity factor 8, the cache path under the parallel path's
            expert picks)
  trace     per served model: torch.profiler over one prefill and 8 decode
            steps, device time by kernel (the top 8, and each port kernel
            with its share of the busy time) and the device's idle share
  bwd_kernels  flash_attention_bwd (dq, dk, dv) against flash_attention_bwd_plain
            on the same inputs, max|Δ| / max|plain| of each at f32 2e-4 and
            bf16 3e-2, at the llama2-7b and gpt2-1.5b train shapes and the
            profile phase's gpt2-1.5b shape (b 16 x s 1024), ragged S,
            Sq < Sk, a window, GQA 64:8 and every head dim, and the d 192 /
            dv 128 instantiation (MLA) at deepseek-v3-671b's train shape (B 4,
            S 512, 128:128 heads, v a view of the (B,S,H,256) buffer) in bf16
            and f32, ragged S = 300 and Sq < Sk; kernel ms by CUDA-graph
            replay (eager beside it), plain ms, the bound (5 products a pair,
            6 d + 4 dv operations, against the bytes of q, k, v, o, do, dq,
            dk, dv, lse and delta) and SDPA's backward (torch.autograd.grad
            of its output with the same do) as library_ms ("none" where SDPA
            refuses dv != d); the d 96 instantiation at phi-3-vision-4.2b's
            train shape (B 4, S 1088 = 576 patches + 512 tokens, 32:32
            heads) in bf16 and f32, and non-causal at seamless-m4t-large-v2's
            encoder (B 4, S 1024, 16:16 heads, d 64) and cross-attention
            (Sq 512 < Sk 1024), its decoder's causal self-attention, a ragged
            Sq 100 < Sk 128 (bf16 and f32) and Sq 300 > Sk 128
  ssd_bwd_kernels, wkv6_bwd_kernels  the SSD-scan and WKV6 backward kernels
            against their plain explicit-chunked versions on the same inputs,
            at the train paths' shapes (zamba2-7b: B 4, S 512, 112 heads, x,
            B, C views of the conv output; rwkv6-1.6b: B 4, S 512, 32 heads,
            r, k, v views of the projections) and around them (ragged S,
            nonzero initial state and last-state gradient, f32, batch 1):
            max|Δ| / max|plain| of each gradient at 2e-5, and 1e-4 for the
            ones summed over batch, time or heads (dA, dB_, dC, du) and
            dlogw; in bf16 the gradients that pass through a bf16 rounding
            (dx, ddt, dB_, dC; dr, dk, dv) at 3e-2, and those handed back in
            bf16 also elementwise within one bf16 step of the plain value
            (both compute in f32 but may round an f32 value that straddles a
            rounding boundary apart).  Also the plain backward against
            torch.autograd.grad of the plain forward on the card (same
            bounds); the bf16 SSD backward run twice at the train shape must
            agree bit for bit.  Kernel ms by CUDA-graph replay (the wrapper:
            kernel and the fixed-order sums of its partials; eager beside
            it), plain ms,
            the bound (the bytes read and written against the operations of
            the backward's products); no library call computes either.  The
            bf16 WKV6 backward, like the SSD one, must agree bit for bit
            across two runs at the train shape
  train_reference  small llama, zamba2, rwkv6, seamless-m4t and phi-3-vision
            (TRAIN_REFERENCE, the cuts of reference) trained 3 AdamW
            steps on the card and on the CPU from the same weights and
            batches (batch 2, seq 100; 128 frames, or 16 patches before the
            100 tokens, drawn as the launcher draws them: the non-causal
            backward at Sq 100 < Sk 128 and the d 96 one), as is, with
            ga_steps=2, with gc,
            and through compile_train_step on a one-rank NCCL group under
            ZeRO-Offload (moments in pinned host memory, checked) and ZeRO-3
            (FSDP2 around the kernels' autograd functions); the small
            moonshot and deepseek (the d 192 / dv 128 backward) as is, with
            ga_steps=2 and with gc (their plans across a mesh are ROADMAP
            A14b), the card under the CPU's expert picks and the routers held
            to each other on step 1's inputs as in reference;
            in f32 (losses rel 1e-4, every step-1 gradient rel 2e-4) and in
            bf16, which runs the backward's tensor-core flash kernels (losses
            3e-2, gradients 5e-2; for zamba2 and rwkv6 each gradient within
            5e-2 plus twice the CPU's own bf16 error on that leaf, its
            distance from the f32 gradient at the same weights); the worst
            leaf of each
  train     full width, batch 4, seq 512, 3 steps each, launches counted
            over those steps: llama2-7b and zamba2-7b in bf16 through
            make_train_step with ExecutionPlan(gc=True) and AdamW with bf16
            moments on one fixed batch (loss after the last step below the
            first; llama2-7b: forward flash 2 x 32 x 3, backward 32 x 3;
            zamba2-7b: SSD forward 2 x 81 x 3, SSD backward 81 x 3, flash
            forward 2 x 13 x 3, backward 13 x 3), gpt2-1.5b and rwkv6-1.6b
            through launch.train.train with its f32 AdamW (gpt2: flash
            forward and backward 48 x 3; rwkv6: WKV6 forward and backward
            24 x 3); moonshot-v1-16b-a3b cut to 10 layers (1 dense, 9 MoE of
            64 experts) and deepseek-v3-671b cut to its 3 dense layers and
            the MTP block, like llama2-7b (GC, bf16 moments; moonshot: flash
            forward 2 x 10 x 3, backward 10 x 3; deepseek: forward (2 x 3 +
            1) x 3 and backward 4 x 3, all at d 192 / dv 128), each first
            running step 1's forward + backward twice (loss, metrics and
            every gradient bit-equal) and reporting each step's ce, aux and
            mtp; then phi-3-vision-4.2b (32 layers, 576 patches before the
            512 tokens) like llama2-7b (GC, bf16 moments; flash forward 2 x
            32 x 3, backward 32 x 3, all at d 96) and seamless-m4t-large-v2
            (24 + 24 layers, 1,024 frames) through the launcher like gpt2
            (f32 AdamW, no GC; flash forward and backward 72 x 3 each, 48 x
            3 of each non-causal); 0 plain calls; step ms, tokens/s, peak
            memory; then one llama2-7b, one zamba2-7b, one rwkv6-1.6b, one
            step of each MoE path, one phi-3-vision-4.2b and one
            seamless-m4t-large-v2 step under torch.profiler (the port
            kernels' shares of busy time, idle share), and for the
            make_train_step paths a warm-up round and SPLIT_ROUNDS more of
            each timed in two halves (medians): forward + backward, then the
            optimizer update
  train_offload  llama2-7b at full width, bf16, batch 4, seq 512, through
            compile_train_step with ExecutionPlan(zero_stage=1, offload=True,
            gc=True) and OptConfig()'s f32 moments (53.9 GB) in pinned host
            memory: a warm-up step, then 3 steps with launches counted (flash
            forward 192, backward 96, 0 plain calls), every moment a pinned
            CPU tensor, peak device bytes below the GC + bf16-moments run's;
            step ms, tokens/s, pinned bytes, and OFFLOAD_ROUNDS forward +
            backward / update splits with the GB/s the moments crossed PCIe;
            then each direction's rate alone (PCIE_REPS copies of the
            largest moment leaf to the card, then back, by CUDA events)
  profile   Rubick's profiling -> fit -> predict loop on the card:
            repro_torch.core.oracle.TorchMicroOracle times gpt2-1.5b's own
            step at batch 4 x 512, then measures (a warm-up step, the median
            of 3 wall-clock steps) each one-card plan of PROFILE_FIT and
            PROFILE_HELD_OUT at the paper's Table 2 shape, b 16 x s 1024,
            OptConfig()'s f32 moments, under env_for_gpu("h100"); per plan
            T_iter, peak device bytes, pinned host bytes and the memory
            model's verdict; the performance model fitted to PROFILE_FIT with
            both engines under TABLE2's A800-derived t_fwd_unit, each fit's
            RMSLE and the held-out (avg, max) relative error against the
            paper's 7.4% / 10.4%; the measured t_fwd_unit beside TABLE2's;
            flash launches counted over the phase (0 plain calls; both flash
            kernels are held to their plain versions at the phase's b 16 x
            s 1024 in kernels and bwd_kernels).  Fails on a time that is not
            finite and positive, a step loss that is not finite, a fit that
            is not finite or a wrong launch count; an out-of-memory error is
            not caught
  schedule  Rubick's scheduling loop over profile's measurements (none
            re-measured): gpt2-1.5b's profile with the measured t_fwd_unit,
            fitted with both engines (RMSLE, held-out errors, beside profile's
            TABLE2-unit fits); its sensitivity curve on the h100 Env: the best
            one-card plan (measured by TorchMicroOracle if profile did not),
            the nine measured plans ranked by predicted T_iter beside their
            measured ranking (Spearman's rho), best_plan_at_most at 1-8 GPUs
            (extrapolated beyond one card); job A (orig plan ZeRO-Offload +
            GC, 1 GPU, 12 CPUs, guaranteed) on a one-GPU node, placed by a
            static pass (no plan or resource changes) and by Rubick's passes
            under both pass engines (which must agree); the decision executed
            on the card by checkpoint and restart (a warm-up step and 3 timed
            steps under the static plan, a checkpoint under build/, a restore
            under Rubick's plan that must be bit-equal, its first step and 3
            timed steps; each plan's T_iter beside its prediction, losses,
            peak; the reconfiguration's seconds beside restore_cost and the
            paper's 78 s); then a CalibrationManager observes the eleven
            measurements and polls, and a refit is propagated into a Rubick
            pass over the running job (the gate's verdict) and an admission
            pass.  Flash launches counted over the phase (0 plain calls).
            Fails on a time, loss or fit that is not finite, a restore that
            is not bit-equal, the engines disagreeing, a plan needing more
            than one card or a wrong launch count
  simulate  Rubick's cluster simulator over T_iter measured on the card: a
            fresh TorchMicroOracle behind a memo (each (plan, alloc) timed
            once, on its first ask, for every run) times the plans the
            schedulers pick; four gpt2-1.5b jobs like schedule's job A,
            submitted 300 s apart, 3,000 iterations each, on its one-GPU
            node, with schedule's fit in the fit cache and its measured plan
            change as the reconfiguration cost; rubick, rubick-n, synergy,
            sia and antman (repro_torch.core.baselines) under the event and
            the discrete engine, Rubick's event run sanitized and recorded
            (its JSONL under build/simulate, validated by
            repro_torch.obs.report).  One line a scheduler: avg and p99 JCT,
            makespan, reconfigurations, guarantee violations, each job's plan
            and measured T_iter; then the plans measured fresh and their card
            seconds.  Flash launches counted over the phase (0 plain calls).
            Fails on a job left unfinished, a time that is not finite, the
            engines' avg JCT or makespan more than 1% apart, a sanitizer
            violation, a trace that does not validate, a measure asked for a
            multi-card plan or a wrong launch count

Then the kernel summary line (the forward's and the backward's d 192 /
dv 128 instantiations on lines of their own, with the deepseek-v3-671b
serve's and train's launches; their d 96 ones with phi-3-vision's serve
and train launches, and their non-causal launches, seamless's served and
trained, at the encoder and cross-attention shapes), the
nvidia-smi line, and as the last line
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
import torch.distributed as dist

TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}   # o: max|Δ| / max|plain| of each row
TOL_LSE = 2e-4                                       # lse (f32 for every dtype): absolute
TOL_SCAN = {torch.bfloat16: 3e-2, torch.float32: 2e-5}   # SSD y: max|Δ| / max|plain|
TOL_STATE = 2e-5                                     # WKV6 y, and every state: relative
TOL_REF = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # card vs CPU logits
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
    """Least time the card needs: max(operations / peak, bytes / HBM rate),
    at the H100 SXM's spec figures (``repro_torch.core.roofline``)."""
    from repro_torch.core import roofline

    peak = {torch.bfloat16: roofline.PEAK_BF16, torch.float32: roofline.PEAK_F32}[dtype]
    t_ops, t_bytes = flops / peak, nbytes / roofline.HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def rel_err(got, want) -> float:
    """max|Δ| / max|want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def bound(B, Sq, Sk, Hq, Hkv, d, causal, window, dtype, dv=None):
    """Flash attention forward: (ms, bound by, operations, bytes) of
    ``flash_attention.fwd_cost``."""
    from repro_torch.kernels import flash_attention

    flops, nbytes = flash_attention.fwd_cost(B, Sq, Sk, Hq, Hkv, d, causal, window, dtype, dv)
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
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS, FWD_HEAD_DIMS
    from repro_torch.kernels.ssd_scan import SHAPES
    from repro_torch.kernels.wkv6 import HEAD_DIMS as WKV_DIMS

    t0 = time.perf_counter()
    built = build.build()

    def int_fn(lib, fn_name, nargs):
        fn = getattr(build.load(lib), fn_name)
        fn.argtypes, fn.restype = [ctypes.c_int] * nargs, ctypes.c_int
        return fn

    fa = int_fn("flash_attention_fwd", "flash_attention_fwd_smem_bytes", 3)
    fb = int_fn("flash_attention_bwd", "flash_attention_bwd_smem_bytes", 4)
    ssd = int_fn("ssd_scan_fwd", "ssd_scan_fwd_smem_bytes", 3)
    ssd_occ = int_fn("ssd_scan_fwd", "ssd_scan_fwd_bf16_blocks_per_sm", 0)
    wkv = int_fn("wkv6_fwd", "wkv6_fwd_smem_bytes", 2)
    wkv_occ = int_fn("wkv6_fwd", "wkv6_fwd_bf16_blocks_per_sm", 0)
    ssd_bwd = int_fn("ssd_scan_bwd", "ssd_scan_bwd_smem_bytes", 2)
    ssd_bwd_occ = int_fn("ssd_scan_bwd", "ssd_scan_bwd_bf16_blocks_per_sm", 1)
    wkv_bwd = int_fn("wkv6_bwd", "wkv6_bwd_smem_bytes", 2)
    wkv_bwd_occ = int_fn("wkv6_bwd", "wkv6_bwd_bf16_blocks_per_sm", 1)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         smem_bytes={"flash_attention_fwd": {dt: {d if d == dv else f"{d}/{dv}": fa(d, dv, code)
                                                  for d, dv in FWD_HEAD_DIMS}
                                             for dt, code in (("bfloat16", 1),
                                                              ("float32", 0))},
                     "flash_attention_bwd": {f"{dt} {kern}": {d if d == dv else f"{d}/{dv}":
                                                              fb(d, dv, code, k)
                                                              for d, dv in BWD_HEAD_DIMS}
                                             for dt, code in (("bfloat16", 1), ("float32", 0))
                                             for kern, k in (("dq", 0), ("dkdv", 1))},
                     "ssd_scan_fwd": {dt: {f"P={p},N={n}": ssd(p, n, code) for p, n in SHAPES}
                                      for dt, code in (("bfloat16", 1), ("float32", 0))},
                     "wkv6_fwd": {dt: {d: wkv(d, code) for d in WKV_DIMS}
                                  for dt, code in (("bfloat16", 1), ("float32", 0))},
                     "ssd_scan_bwd": {"bfloat16": ssd_bwd(1, 0), "bfloat16 states": ssd_bwd(1, 1),
                                      "float32": ssd_bwd(0, 0)},
                     "wkv6_bwd": {"bfloat16 sums": wkv_bwd(1, 0), "bfloat16 chunks": wkv_bwd(1, 1),
                                  "float32": wkv_bwd(0, 0)}},
         ssd_bf16_blocks_per_sm=ssd_occ(), wkv6_bf16_blocks_per_sm=wkv_occ(),
         ssd_bwd_bf16_blocks_per_sm={"backward walk": ssd_bwd_occ(0), "states": ssd_bwd_occ(1)},
         wkv6_bwd_bf16_blocks_per_sm={"sums": wkv_bwd_occ(0), "chunks": wkv_bwd_occ(1)},
         libs={n: {"path": str(b.path.relative_to(Path(__file__).resolve().parent)),
                   "nvcc_s": round(b.seconds, 3), "cached": b.cached,
                   "ptxas": [ln.strip() for ln in b.ptxas.splitlines()
                             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]}
               for n, b in built.items()})


# (label, B, Sq, Sk, Hq, Hkv, d, causal, window, dtype[, packed]); the first
# is the serving path's shape (llama2-7b prefill, batch 4, prompt 512).
# packed: q, k, v are strided views of one (B, S, 3, H, d) buffer.  d is a
# pair (d, dv) for MLA (MLA_D): q and k 192 wide, v 128, v a view of the
# (B, S, H, 128 + 128) buffer the model decompresses it into, as the model
# hands it over; the first such case is deepseek-v3-671b's prefill.
MLA_D = (192, 128)
# The serving shapes of phi-3-vision-4.2b (d 96) and seamless-m4t-large-v2
# (non-causal, d 64), which the kernels line reports beside the first case.
D96_CASE = "phi-3-vision-4.2b prefill d=96 (576 patches + 512 text)"
ENCODER_CASE = "seamless-m4t-large-v2 encoder, bidirectional"
CROSS_CASE = "seamless-m4t-large-v2 cross-attention, Sq 512 < Sk 1024"
CASES = [
    ("llama2-7b prefill", 4, 512, 512, 32, 32, 128, True, 0, torch.bfloat16),
    ("packed (B,S,3,H,d) views", 4, 512, 512, 32, 32, 128, True, 0, torch.bfloat16, True),
    ("qwen2-72b GQA 64:8", 4, 512, 512, 64, 8, 128, True, 0, torch.bfloat16),
    ("ragged S=17", 4, 17, 17, 32, 32, 128, True, 0, torch.bfloat16),
    ("llama2-7b S=2048", 4, 2048, 2048, 32, 32, 128, True, 0, torch.bfloat16),
    ("llama2-7b S=4096", 4, 4096, 4096, 32, 32, 128, True, 0, torch.bfloat16),
    ("gemma-2b MQA d=256", 4, 512, 512, 8, 1, 256, True, 0, torch.bfloat16),
    ("gpt2-1.5b d=64", 4, 512, 512, 25, 25, 64, True, 0, torch.bfloat16),
    ("gpt2-1.5b profile d=64", 16, 1024, 1024, 25, 25, 64, True, 0, torch.bfloat16),
    ("starcoder2-3b window 4096, S=8192", 1, 8192, 8192, 24, 2, 128, True, 4096, torch.bfloat16),
    ("Sq < Sk (chunk 128 after 512)", 4, 128, 640, 32, 32, 128, True, 0, torch.bfloat16),
    ("ragged S=1000", 2, 1000, 1000, 32, 32, 128, True, 0, torch.bfloat16),
    ("bidirectional", 2, 512, 512, 32, 32, 128, False, 0, torch.bfloat16),
    ("llama2-7b prefill f32", 4, 512, 512, 32, 32, 128, True, 0, torch.float32),
    ("gemma-2b MQA d=256 f32", 2, 512, 512, 8, 1, 256, True, 0, torch.float32),
    ("gpt2-1.5b ragged S=300 f32", 2, 300, 300, 25, 25, 64, True, 0, torch.float32),
    ("zamba2-7b shared block d=112", 4, 512, 512, 32, 32, 112, True, 0, torch.bfloat16),
    ("deepseek-v3 MLA prefill d=192 dv=128", 4, 512, 512, 128, 128, MLA_D, True, 0,
     torch.bfloat16),
    ("deepseek-v3 MLA prefill d=192 dv=128 f32", 4, 512, 512, 128, 128, MLA_D, True, 0,
     torch.float32),
    ("MLA ragged S=300", 2, 300, 300, 128, 128, MLA_D, True, 0, torch.bfloat16),
    ("MLA Sq < Sk (chunk 128 after 512)", 4, 128, 640, 128, 128, MLA_D, True, 0,
     torch.bfloat16),
    (D96_CASE, 4, 1088, 1088, 32, 32, 96, True, 0, torch.bfloat16),
    ("d=96 ragged S=300", 2, 300, 300, 32, 32, 96, True, 0, torch.bfloat16),
    ("d=96 f32", 2, 512, 512, 32, 32, 96, True, 0, torch.float32),
    (ENCODER_CASE, 4, 1024, 1024, 16, 16, 64, False, 0, torch.bfloat16),
    ("seamless-m4t-large-v2 decoder self", 4, 512, 512, 16, 16, 64, True, 0, torch.bfloat16),
    (CROSS_CASE, 4, 512, 1024, 16, 16, 64, False, 0, torch.bfloat16),
    ("bidirectional Sq 1500 > Sk 1024", 4, 1500, 1024, 16, 16, 64, False, 0, torch.bfloat16),
]


def phase_kernels():
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    for i, (label, B, Sq, Sk, Hq, Hkv, d, causal, window, dt, *packed) in enumerate(CASES):
        main = i == 0
        d, dv = d if isinstance(d, tuple) else (d, d)
        q = torch.randn((B, Sq, Hq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Sk, Hkv, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Sk, Hkv, dv), generator=gen, device="cuda").to(dt)
        if dv != d:
            v = torch.cat((torch.zeros_like(v), v), dim=-1)[..., dv:]
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
        library = "sdpa is_causal" if plain_mask else "sdpa attn_mask"
        try:
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=Hq != Hkv, **sdpa_kw), reps)
        except RuntimeError as e:    # the yardstick only: SDPA may refuse dv != d
            if dv == d:
                raise
            library_ms, library = None, f"none (SDPA refused d {d} / dv {dv}: {str(e)[:120]})"
        bms, by, flops, nbytes = bound(B, Sq, Sk, Hq, Hkv, d, causal, window, dt, dv)
        row = dict(case=label, B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, d=d, dv=dv, causal=causal,
                   window=window, dtype=str(dt).removeprefix("torch."), tol_o_row=tol,
                   tol_lse=TOL_LSE, row_rel_err_o=row_rel_o, max_abs_err_o=err_o,
                   max_abs_err_lse=err_lse, ok=ok, kernel_ms=kernel_ms,
                   kernel_ms_eager=kernel_ms_eager, plain_ms=plain_ms,
                   library_ms=library_ms,
                   kernel_vs_library=kernel_ms / library_ms if library_ms else None,
                   library=library, packed=bool(packed), v_view=dv != d,
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
    by_label = {r["case"]: r for r in rows}
    return {"flash_attention_fwd": rows[0],
            "flash_attention_fwd_mla": next(r for r in rows if r["dv"] != r["d"]),
            "flash_attention_fwd_d96": by_label[D96_CASE],
            "flash_attention_fwd_encoder": by_label[ENCODER_CASE],
            "flash_attention_fwd_cross": by_label[CROSS_CASE]}


# (label, B, Sq, Sk, Hq, Hkv, d, causal, window, dtype); the first is the
# llama2-7b train path's shape (batch 4, seq 512), the third gpt2-1.5b's, the
# fourth the profile phase's (b 16 x s 1024; GA 2 and 4 split it in 8 and 4).
# d is a pair (d, dv) for MLA (MLA_D), v a view of the (B, S, H, 128 + 128)
# buffer as in CASES; the first such case is deepseek-v3-671b's train path.
# The train shapes of phi-3-vision-4.2b (d 96) and seamless-m4t-large-v2
# (non-causal, d 64) are reported beside the first case in the kernels line.
D96_BWD_CASE = "phi-3-vision-4.2b train d=96 (576 patches + 512 text)"
ENCODER_BWD_CASE = "seamless-m4t-large-v2 encoder, bidirectional"
CROSS_BWD_CASE = "seamless-m4t-large-v2 cross-attention, Sq 512 < Sk 1024"
BWD_CASES = [
    ("llama2-7b train", 4, 512, 512, 32, 32, 128, True, 0, torch.bfloat16),
    ("llama2-7b train f32", 4, 512, 512, 32, 32, 128, True, 0, torch.float32),
    ("gpt2-1.5b train d=64", 4, 512, 512, 25, 25, 64, True, 0, torch.bfloat16),
    ("gpt2-1.5b profile d=64", 16, 1024, 1024, 25, 25, 64, True, 0, torch.bfloat16),
    ("ragged S=17", 2, 17, 17, 8, 8, 128, True, 0, torch.bfloat16),
    ("ragged S=65 f32", 2, 65, 65, 8, 8, 128, True, 0, torch.float32),
    ("ragged S=100 d=64", 2, 100, 100, 8, 8, 64, True, 0, torch.bfloat16),
    ("Sq < Sk (128 after 512)", 2, 128, 640, 8, 8, 128, True, 0, torch.bfloat16),
    ("window 96, GQA 8:2", 2, 512, 512, 8, 2, 128, True, 96, torch.bfloat16),
    ("qwen2-72b GQA 64:8", 1, 256, 256, 64, 8, 128, True, 0, torch.bfloat16),
    ("zamba2-7b shared block d=112", 2, 256, 256, 8, 8, 112, True, 0, torch.bfloat16),
    ("gemma-2b MQA d=256", 2, 256, 256, 8, 1, 256, True, 0, torch.bfloat16),
    ("d=256 f32", 1, 200, 200, 4, 2, 256, True, 0, torch.float32),
    ("bidirectional", 2, 256, 256, 8, 8, 128, False, 0, torch.bfloat16),
    ("deepseek-v3 MLA train d=192 dv=128", 4, 512, 512, 128, 128, MLA_D, True, 0,
     torch.bfloat16),
    ("deepseek-v3 MLA train d=192 dv=128 f32", 4, 512, 512, 128, 128, MLA_D, True, 0,
     torch.float32),
    ("MLA ragged S=300", 2, 300, 300, 128, 128, MLA_D, True, 0, torch.bfloat16),
    ("MLA Sq < Sk (128 after 512)", 2, 128, 640, 128, 128, MLA_D, True, 0, torch.bfloat16),
    (D96_BWD_CASE, 4, 1088, 1088, 32, 32, 96, True, 0, torch.bfloat16),
    ("phi-3-vision-4.2b train d=96 f32", 4, 1088, 1088, 32, 32, 96, True, 0, torch.float32),
    (ENCODER_BWD_CASE, 4, 1024, 1024, 16, 16, 64, False, 0, torch.bfloat16),
    (CROSS_BWD_CASE, 4, 512, 1024, 16, 16, 64, False, 0, torch.bfloat16),
    ("seamless-m4t-large-v2 decoder self", 4, 512, 512, 16, 16, 64, True, 0, torch.bfloat16),
    ("non-causal ragged Sq 100 < Sk 128", 2, 100, 128, 8, 8, 64, False, 0, torch.bfloat16),
    ("non-causal Sq 300 > Sk 128", 2, 300, 128, 8, 8, 64, False, 0, torch.bfloat16),
    ("non-causal Sq 100 < Sk 128 f32", 2, 100, 128, 8, 8, 64, False, 0, torch.float32),
]


def bwd_bound(B, Sq, Sk, Hq, Hkv, d, causal, window, dtype, dv=None):
    """Attention backward: (ms, bound by, operations, bytes) of
    ``flash_attention.bwd_cost``."""
    from repro_torch.kernels import flash_attention

    flops, nbytes = flash_attention.bwd_cost(B, Sq, Sk, Hq, Hkv, d, causal, window, dtype, dv)
    return (*bound_ms(flops, nbytes, dtype), flops, nbytes)


def phase_bwd_kernels():
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    mains = (D96_BWD_CASE, ENCODER_BWD_CASE, CROSS_BWD_CASE)
    for i, (label, B, Sq, Sk, Hq, Hkv, d, causal, window, dt) in enumerate(BWD_CASES):
        d, dv = d if isinstance(d, tuple) else (d, d)
        main = (i == 0 or (dv != d and not any(r["dv"] != r["d"] for r in rows))
                or label in mains)
        q = torch.randn((B, Sq, Hq, d), generator=gen, device="cuda").to(dt)
        do = torch.randn((B, Sq, Hq, dv), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Sk, Hkv, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Sk, Hkv, dv), generator=gen, device="cuda").to(dt)
        if dv != d:
            v = torch.cat((torch.zeros_like(v), v), dim=-1)[..., dv:]
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        args = (q, k, v, o, lse, do)
        got = flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        want = flash_attention_bwd_plain(*args, **kw)
        errs = {n: rel_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        max_abs = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        ok = max(errs.values()) <= TOL[dt] and finite(*got)
        del got, want
        reps = 20 if main else 5
        kernel_ms_eager = cuda_ms(lambda: flash_attention_bwd(*args, **kw), reps)
        kernel_ms = graph_ms(lambda: flash_attention_bwd(*args, **kw), reps)
        plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(*args, **kw), 3 if main else 1,
                           warmup=1)
        # SDPA's backward on the same inputs, timed as a yardstick only: the
        # gradient of its output with the same do (masks as in phase_kernels).
        # A backward runs on its forward's stream, so forward and backward are
        # captured together and the forward's own replay time is taken off.
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        plain_mask = not window and (Sq == Sk or not causal)
        sdpa_kw = (dict(is_causal=causal) if plain_mask
                   else dict(attn_mask=band_mask(Sq, Sk, causal, window)))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=Hq != Hkv, **sdpa_kw)

        library = "sdpa backward " + ("is_causal" if plain_mask else "attn_mask")
        try:
            library_ms = (graph_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), reps)
                          - graph_ms(sdpa, reps))
        except RuntimeError as e:    # the yardstick only: SDPA may refuse dv != d
            if dv == d:
                raise
            library_ms, library = None, f"none (SDPA refused d {d} / dv {dv}: {str(e)[:120]})"
        bms, by, flops, nbytes = bwd_bound(B, Sq, Sk, Hq, Hkv, d, causal, window, dt, dv)
        rows.append(dict(case=label, B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, d=d, dv=dv,
                         causal=causal, window=window, dtype=str(dt).removeprefix("torch."),
                         tol=TOL[dt], rel_err=errs, max_abs_err=max_abs, ok=ok,
                         kernel_ms=kernel_ms, kernel_ms_eager=kernel_ms_eager, plain_ms=plain_ms,
                         library_ms=library_ms,
                         kernel_vs_library=kernel_ms / library_ms if library_ms else None,
                         library=library, v_view=dv != d,
                         bound_ms=bms, bound_by=by, x_bound=kernel_ms / bms,
                         gflop=flops / 1e9, mbytes=nbytes / 1e6,
                         tflops=flops / kernel_ms / 1e9))
        if not ok:
            failed.append(label)
        del q, k, v, o, lse, do, args, qt, kt, vt, dot
        torch.cuda.empty_cache()
    emit("bwd_kernels", kernel="flash_attention_bwd", cases=rows)
    if failed:
        raise AssertionError(f"flash_attention_bwd disagrees with its plain version: {failed}")
    by_label = {r["case"]: r for r in rows}
    return {"flash_attention_bwd": rows[0],
            "flash_attention_bwd_mla": next(r for r in rows if r["dv"] != r["d"]),
            "flash_attention_bwd_d96": by_label[D96_BWD_CASE],
            "flash_attention_bwd_noncausal": dict(by_label[ENCODER_BWD_CASE],
                                                  other_case=by_label[CROSS_BWD_CASE])}


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


def ssd_bound(B, S, H, P, N, h0, dtype):
    """SSD forward: (ms, bound by, operations, bytes) of ``ssd_scan.fwd_cost``."""
    from repro_torch.kernels import ssd_scan

    flops, nbytes = ssd_scan.fwd_cost(B, S, H, P, N, h0, dtype)
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


def wkv_bound(B, S, H, hd, s0, dtype):
    """WKV6 forward: (ms, bound by, operations, bytes) of ``wkv6.fwd_cost``."""
    from repro_torch.kernels import wkv6

    flops, nbytes = wkv6.fwd_cost(B, S, H, hd, s0, dtype)
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


TOL_SUMMED = 1e-4     # backward: the gradients summed over batch, time or heads, and dlogw


def bf16_step(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 at |t| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(1e-30))) - 7)


def over_bound(errs: dict, summed, rounded, dtype) -> list[str]:
    """The gradients whose max|Δ| / max|plain| misses its bound (see
    check_grads)."""
    return [n for n, e in errs.items()
            if e > (TOL_SCAN[dtype] if dtype == torch.bfloat16 and n in rounded
                    else TOL_SUMMED if n in summed else TOL_STATE)]


def steps_apart(got, want) -> float:
    """max over elements of |got - want|, less TOL_STATE max|want|, in bf16
    steps at |want|."""
    d = (got.float() - want.float()).abs() - TOL_STATE * want.float().abs().max()
    return (d.clamp_min(0) / bf16_step(want)).max().item()


def check_grads(got, want, names, summed, rounded, dtype) -> tuple[dict, dict, list[str]]:
    """Backward kernel against its plain version: (max|Δ| / max|plain| of each
    gradient, bf16 steps apart of each bf16 one, the names that miss their
    bound).  Both compute in f32, so each gradient holds at TOL_STATE
    (TOL_SUMMED for `summed`); in bf16 the gradients in `rounded` (name:
    bf16 roundings on its path) pass through roundings that an f32 value on
    a boundary can take either way, so they hold at TOL_SCAN's 3e-2, and
    those handed back in bf16 also elementwise within one bf16 step per
    rounding of the plain value (plus TOL_STATE max|plain|)."""
    errs = {name: rel_err(g, w) for name, g, w in zip(names, got, want)}
    steps = {name: steps_apart(g, w) for name, g, w in zip(names, got, want)
             if g.dtype == torch.bfloat16}
    bad = over_bound(errs, summed, rounded, dtype)
    bad += [n for n, st in steps.items() if st > rounded.get(n, 0)]
    bad += [n for n, g, w in zip(names, got, want) if not finite(g) or g.dtype != w.dtype]
    return errs, steps, sorted(set(bad))


def autograd_errs(plain_fwd, args, n_in, grads_out, plain_bwd_out, names) -> dict:
    """The plain backward against torch.autograd.grad of the plain forward."""
    leaves = [a.detach().clone().requires_grad_() if a is not None else None
              for a in args[:n_in]]
    with torch.enable_grad():
        outs = plain_fwd(*leaves)
        have = [i for i, a in enumerate(leaves) if a is not None]
        want = torch.autograd.grad(outs, [leaves[i] for i in have],
                                   [g if g is not None else torch.zeros_like(o)
                                    for g, o in zip(grads_out, outs)])
    return {names[i]: rel_err(plain_bwd_out[i], w) for i, w in zip(have, want)}


def bwd_case(label, main, args, bwd, bwd_plain, fwd_plain, names, summed, rounded, dt,
             bound) -> dict:
    """One backward case: the kernel against its plain version on the same
    inputs (check_grads), the plain version against autograd of the plain
    forward, and the kernel (CUDA-graph replay and eager) and plain times.
    args = (the forward's 6 inputs, the output gradients y and state)."""
    got = bwd(*args)
    torch.cuda.synchronize()
    want = bwd_plain(*args)
    errs, steps, bad = check_grads(got, want, names, summed, rounded, dt)
    max_abs = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    auto = autograd_errs(fwd_plain, args, 6, args[6:], want, names)
    auto_bad = over_bound(auto, summed, rounded, dt)
    del got, want
    reps = 20 if main else 5
    kernel_ms_eager = cuda_ms(lambda: bwd(*args), reps)
    kernel_ms = graph_ms(lambda: bwd(*args), reps)
    plain_ms = cuda_ms(lambda: bwd_plain(*args), 3 if main else 1, warmup=1)
    bms, by, flops, nbytes = bound
    return dict(case=label, dtype=str(dt).removeprefix("torch."), rel_err=errs,
                bf16_steps_apart=steps, failed=bad, plain_vs_autograd_rel_err=auto,
                plain_vs_autograd_failed=auto_bad, max_abs_err=max_abs,
                ok=not bad and not auto_bad, kernel_ms=kernel_ms,
                kernel_ms_eager=kernel_ms_eager, plain_ms=plain_ms, library_ms=None,
                bound_ms=bms, bound_by=by, x_bound=kernel_ms / bms, gflop=flops / 1e9,
                mbytes=nbytes / 1e6, tflops=flops / kernel_ms / 1e9)


# (label, B, S, H, h0 and dh_last, dtype); the first is the zamba2-7b train
# path's shape (batch 4, seq 512, 112 heads of 64, state 64).
SSD_BWD_CASES = [
    ("zamba2-7b train", 4, 512, 112, False, torch.bfloat16),
    ("zamba2-7b train f32", 4, 512, 112, False, torch.float32),
    ("ragged S=300, h0 and dh_last", 2, 300, 112, True, torch.bfloat16),
    ("ragged S=77, h0 and dh_last f32", 2, 77, 112, True, torch.float32),
    ("batch 1, h0 and dh_last", 1, 512, 112, True, torch.bfloat16),
]
SSD_GRADS = ("dx", "ddt", "dA", "dB_", "dC", "dh0")
SSD_SUMMED = ("dA", "dB_", "dC")
# dx rounds d(xdt), then d(xdt) dt: a flip of the first moves the product by
# up to two steps before the second rounding
SSD_ROUNDED = {"dx": 3, "ddt": 0, "dB_": 1, "dC": 1}


def ssd_bwd_bound(B, S, H, P, N, state, dtype):
    """SSD backward: (ms, bound by, operations, bytes) of ``ssd_scan.bwd_cost``."""
    from repro_torch.kernels import ssd_scan

    flops, nbytes = ssd_scan.bwd_cost(B, S, H, P, N, state, dtype)
    return (*bound_ms(flops, nbytes, dtype), flops, nbytes)


def ssd_bwd_args(gen, B, S, H, state, dt) -> tuple:
    """The SSD backward's inputs, heads of P = 64, state N = 64: x, B, C as
    views of one conv output, as mamba2_apply passes them; h0 and dh_last
    only when `state`."""
    P = N = 64
    conv = torch.randn((B, S, H * P + 2 * N), generator=gen, device="cuda").to(dt)
    x = conv[..., :H * P].view(B, S, H, P)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dtv = 0.05 + 0.95 * torch.rand((B, S, H), generator=gen, device="cuda")
    A = -(0.3 + 1.7 * torch.rand((H,), generator=gen, device="cuda"))
    h0, dh = (torch.randn((B, H, P, N), generator=gen, device="cuda") if state else None
              for _ in range(2))
    dy = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dt)
    return (x, dtv, A, Bm, Cm, h0, dy, dh)


def phase_ssd_bwd_kernels():
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    for i, (label, B, S, H, state, dt) in enumerate(SSD_BWD_CASES):
        main = i == 0
        args = ssd_bwd_args(gen, B, S, H, state, dt)
        row = bwd_case(label, main, args, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain,
                       SSD_GRADS, SSD_SUMMED, SSD_ROUNDED, dt,
                       ssd_bwd_bound(B, S, H, 64, 64, state, dt))
        if main:
            # no atomics: two runs on the same inputs agree bit for bit
            first, second = ssd_scan_bwd(*args), ssd_scan_bwd(*args)
            row["bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(first, second))
            row["ok"] = row["ok"] and row["bitwise_repeatable"]
            del first, second
        rows.append(dict(B=B, S=S, H=H, P=64, N=64, state=state, **row))
        if not row["ok"]:
            failed.append(label)
        del args
        torch.cuda.empty_cache()
    emit("ssd_bwd_kernels", kernel="ssd_scan_bwd", tol=TOL_STATE, tol_summed=TOL_SUMMED,
         tol_bf16_rounded=TOL_SCAN[torch.bfloat16], cases=rows)
    if failed:
        raise AssertionError(f"ssd_scan_bwd disagrees with its plain version: {failed}")
    return rows[0]


# (label, B, S, H, s0 and dS_last, dtype); the first is the rwkv6-1.6b train
# path's shape (batch 4, seq 512, 32 heads of 64).
WKV_BWD_CASES = [
    ("rwkv6-1.6b train", 4, 512, 32, False, torch.bfloat16),
    ("rwkv6-1.6b train f32", 4, 512, 32, False, torch.float32),
    ("ragged S=300, s0 and dS_last", 2, 300, 32, True, torch.bfloat16),
    ("ragged S=33, s0 and dS_last f32", 2, 33, 32, True, torch.float32),
    ("batch 1, s0 and dS_last", 1, 512, 32, True, torch.bfloat16),
]
WKV_GRADS = ("dr", "dk", "dv", "dlogw", "du", "ds0")
WKV_SUMMED = ("dlogw", "du")
WKV_ROUNDED = {"dr": 1, "dk": 1, "dv": 1}


def wkv_bwd_bound(B, S, H, hd, state, dtype):
    """WKV6 backward: (ms, bound by, operations, bytes) of ``wkv6.bwd_cost``."""
    from repro_torch.kernels import wkv6

    flops, nbytes = wkv6.bwd_cost(B, S, H, hd, state, dtype)
    return (*bound_ms(flops, nbytes, dtype), flops, nbytes)


def wkv_bwd_args(gen, B, S, H, state, dt) -> tuple:
    """The WKV6 backward's inputs, heads of 64: r, k, v as views of one
    projection output, as time_mix passes them; s0 and dS_last only when
    `state`."""
    hd = 64
    proj = torch.randn((B, S, 3, H * hd), generator=gen, device="cuda").to(dt)
    r, k, v = (proj[:, :, j].view(B, S, H, hd) for j in range(3))
    logw = -(0.02 + 2.98 * torch.rand((B, S, H, hd), generator=gen, device="cuda"))
    u = 0.5 * torch.randn((H, hd), generator=gen, device="cuda")
    s0, dS = (torch.randn((B, H, hd, hd), generator=gen, device="cuda") if state else None
              for _ in range(2))
    dy = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    return (r, k, v, logw, u, s0, dy, dS)


def phase_wkv_bwd_kernels():
    from repro_torch.kernels.wkv6 import wkv6_bwd, wkv6_bwd_plain, wkv6_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failed = [], []
    for i, (label, B, S, H, state, dt) in enumerate(WKV_BWD_CASES):
        main = i == 0
        args = wkv_bwd_args(gen, B, S, H, state, dt)
        row = bwd_case(label, main, args, wkv6_bwd, wkv6_bwd_plain, wkv6_plain, WKV_GRADS,
                       WKV_SUMMED, WKV_ROUNDED, dt, wkv_bwd_bound(B, S, H, 64, state, dt))
        if main:
            # no atomics: two runs on the same inputs agree bit for bit
            first, second = wkv6_bwd(*args), wkv6_bwd(*args)
            row["bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(first, second))
            row["ok"] = row["ok"] and row["bitwise_repeatable"]
            del first, second
        rows.append(dict(B=B, S=S, H=H, hd=64, state=state, **row))
        if not row["ok"]:
            failed.append(label)
        del args
        torch.cuda.empty_cache()
    emit("wkv6_bwd_kernels", kernel="wkv6_bwd", tol=TOL_STATE, tol_summed=TOL_SUMMED,
         tol_bf16_rounded=TOL_SCAN[torch.bfloat16], cases=rows)
    if failed:
        raise AssertionError(f"wkv6_bwd disagrees with its plain version: {failed}")
    return rows[0]


def ssd_bwd_launcher(lib):
    from repro_torch.kernels.ssd_scan import bind_bwd, launch_bwd

    fn = bind_bwd(lib)
    return lambda *args: launch_bwd(fn, *args)


def wkv_bwd_launcher(lib):
    """The CUDA-core source (commits fa89b8d to b22a2e0) has the same C entry
    point but no size functions: its scratch is the chunk-start states,
    (B,H,nc,hd,hd) f32, and its du partials one row a batch."""
    from repro_torch.kernels.wkv6 import CHUNK, bind_bwd, bind_bwd_sizes, launch_bwd

    fn = bind_bwd(lib)
    sizes = (bind_bwd_sizes(lib) if hasattr(lib, "wkv6_bwd_scratch_bytes")
             else lambda B, S, H, code: (4 * B * H * -(-S // CHUNK) * 64 * 64, 1))
    return lambda *args: launch_bwd(fn, sizes, *args)


# --bwd-compare: each backward kernel's launcher from a built library, its
# module, its cases (the first, the train shape, is compared), inputs, bound
# and check_grads arguments.
BWD_COMPARE = {
    "ssd_scan_bwd": (ssd_bwd_launcher, "ssd_scan", SSD_BWD_CASES, ssd_bwd_args,
                     lambda B, S, H, state, dt: ssd_bwd_bound(B, S, H, 64, 64, state, dt),
                     SSD_GRADS, SSD_SUMMED, SSD_ROUNDED),
    "wkv6_bwd": (wkv_bwd_launcher, "wkv6", WKV_BWD_CASES, wkv_bwd_args,
                 lambda B, S, H, state, dt: wkv_bwd_bound(B, S, H, 64, state, dt),
                 WKV_GRADS, WKV_SUMMED, WKV_ROUNDED),
}


def build_bwd_versions(kernel: str, others: list[Path]) -> dict:
    """csrc/<kernel>.cu and each other version of it named (e.g. an earlier
    one), built by nvcc all at once into build/bwd_compare/<kernel>/<tag>/
    (tag: "current", or the other source's directory name).  tag ->
    (launch function, bf16 blocks per SM of its two kernels or None, ptxas
    lines)."""
    import ctypes

    from repro_torch.kernels import build

    out = build.BUILD_DIR.parent / "bwd_compare" / kernel
    sources = {"current": (build.CSRC / f"{kernel}.cu").read_text()}
    for path in others:
        sources[path.resolve().parent.name] = path.read_text()
    procs = {}
    for tag, text in sources.items():
        (out / tag).mkdir(parents=True, exist_ok=True)
        cu = out / tag / f"{kernel}.cu"
        cu.write_text(text)
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out / tag / "lib.so"), str(cu)]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        lib = ctypes.CDLL(str(out / tag / "lib.so"))
        occ = None
        if hasattr(lib, f"{kernel}_bf16_blocks_per_sm"):
            fn = getattr(lib, f"{kernel}_bf16_blocks_per_sm")
            fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
            occ = [fn(0), fn(1)]
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
        libs[tag] = (BWD_COMPARE[kernel][0](lib), occ, ptxas)
    return libs


def compare_bwd(kernel: str, others: list[Path], reps: int = 20) -> int:
    """--bwd-compare KERNEL: every version from build_bwd_versions against
    the plain version at the train shape (the bwd_kernels limits), twice for
    bit-repeatability, then timed as CUDA-graph replays in turns (the
    versions in order, then reversed), each with the fixed-order sums of
    its partials."""
    import importlib

    _, module, cases, make_args, make_bound, names, summed, rounded = BWD_COMPARE[kernel]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    name, smi = phase_device()
    libs = build_bwd_versions(kernel, others)
    label, B, S, H, state, dt = cases[0]
    args = make_args(torch.Generator(device="cuda").manual_seed(SEED), B, S, H, state, dt)
    mod._check_bwd(*args)
    want = getattr(mod, f"{kernel}_plain")(*args)
    rows, failed = {}, []
    for tag, (launch, occ, ptxas) in libs.items():
        got = launch(*args)
        torch.cuda.synchronize()
        errs, steps, bad = check_grads(got, want, names, summed, rounded, dt)
        again = launch(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rows[tag] = dict(version=tag, blocks_per_sm=occ, ptxas=ptxas,
                         rel_err=errs, bf16_steps_apart=steps, failed=bad,
                         bitwise_repeatable=same, ms=[])
        if bad or not same:
            failed.append(tag)
        del got, again
    order = list(libs)
    for tag in order + order[::-1]:
        launch = libs[tag][0]
        rows[tag]["ms"].append(graph_ms(lambda: launch(*args), reps))
    bms, by, flops, nbytes = make_bound(B, S, H, state, dt)
    for row in rows.values():
        best = min(row["ms"])
        emit("bwd_compare", kernel=kernel, case=label, B=B, S=S, H=H, **row, bound_ms=bms,
             bound_by=by, x_bound=best / bms, tflops=flops / best / 1e9)
    print(smi)
    if failed:
        print(f"chip_smoke: versions disagree with the plain version: {failed}", file=sys.stderr)
        return 1
    return 0


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
    "moonshot-v1-16b-a3b": ("2 layers (1 dense + 1 MoE), d_model 256, 2 heads of 128, 8 "
                            "experts top-2, 1 shared, moe_d_ff 128",
                            dict(n_layers=2, n_dense_layers=1, d_model=256, n_heads=2,
                                 n_kv_heads=2, d_ff=512, n_experts=8, top_k=2,
                                 n_shared_experts=1, moe_d_ff=128)),
    "deepseek-v3-671b": ("2 layers (1 dense + 1 MoE) and the MTP block, d_model 256, 2 MLA "
                         "heads at the full per-head dims (qk_nope 128 + qk_rope 64, v 128: "
                         "the d 192 / dv 128 kernel), q_lora 64, kv_lora 32, 8 experts "
                         "top-2, 1 shared, moe_d_ff 128",
                         dict(n_layers=2, n_dense_layers=1, d_model=256, n_heads=2,
                              n_kv_heads=2, d_ff=512, n_experts=8, top_k=2,
                              n_shared_experts=1, moe_d_ff=128, q_lora_rank=64,
                              kv_lora_rank=32)),
    "seamless-m4t-large-v2": ("2 encoder + 2 decoder layers, d_model 256, 4 heads of 64, "
                              "128 frames (the encoder and the cross-attention run the "
                              "non-causal kernel, the cross-attention at Sq 100 < Sk 128)",
                              dict(n_layers=2, enc_layers=2, d_model=256, n_heads=4,
                                   n_kv_heads=4, d_ff=512, n_frames=128)),
    "phi-3-vision-4.2b": ("2 layers, d_model 256, 2 heads of 96 (the d 96 kernel), 16 "
                          "patches before the 100 tokens",
                          dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, head_dim=96,
                               d_ff=512, n_patches=16)),
}


# Every cut model of REFERENCE is also trained on the card against the CPU.
TRAIN_REFERENCE = REFERENCE


def train_batch_on(cfg, data, step: int, device) -> dict[str, torch.Tensor]:
    """Step ``step``'s batch as the launcher makes it (launch.train.train_batch:
    the data source's tokens, and the modality stub drawn from the step; a
    vision model's tokens cut to seq_len - n_patches) on ``device``."""
    from repro_torch.launch.train import train_batch

    out = {k: torch.from_numpy(a).to(device)
           for k, a in train_batch(cfg, data.batch(step), step).items()}
    out["tokens"] = out["tokens"].long()
    return out


def stub_seq(cfg, n_text: int) -> int:
    """The launcher's seq for ``n_text`` tokens: a vision model's counts its
    patches too."""
    return n_text + (cfg.n_patches if cfg.frontend == "vision" else 0)


def prompt_on(cfg, B: int, n_text: int, device) -> dict[str, torch.Tensor]:
    """A prompt of ``n_text`` tokens from SEED with the config's modality stub
    (frames, or patches before the text), as the launcher draws it, on
    ``device``."""
    from repro_torch.launch.serve import prompt_batch

    n = n_text + (cfg.n_patches if cfg.frontend == "vision" else 0)
    return {k: torch.from_numpy(a).to(device) for k, a in prompt_batch(cfg, B, n, SEED).items()}


def positions(batch: dict) -> int:
    """Cache positions a prompt fills: its tokens, and its patches before them."""
    return batch["tokens"].shape[1] + (batch["patches"].shape[1] if "patches" in batch else 0)


def topk_margin(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Per token, the k-th largest probability less the (k+1)-th: how far the
    router's input is from flipping a pick."""
    top = probs.float().topk(k + 1, dim=-1).values
    return top[:, k - 1] - top[:, k]


@torch.no_grad()
def route_check(first_log, second_log, second_params, cfg, strict: bool,
                names=("card", "CPU")) -> tuple[dict, list[str]]:
    """The MoE routers of a first run (the card's, when serving) and of the
    second run that replayed its picks (the CPU's): (summary, faults).  Each
    first call's input is routed again by the second run's router: a pick
    that differs is a fault, named with the token's top-k margin.  The
    second run's own top k on its own inputs is compared with the picks it
    replayed: under ``strict`` (f32, whose noise is ~1e-6) a difference is a
    fault too; in bf16 it is reported with its margins (rounding noise flips
    near-ties)."""
    from repro_torch.models import moe

    K = cfg.top_k
    first, second = names
    routers = [lp.moe.router for lp in second_params.moe_layers]
    same_input, own_input, own_margins = [], [], []
    for i, ((xg, _, eg), (_, pc, ec)) in enumerate(zip(first_log.seen, second_log.seen)):
        router = routers[i % len(routers)]
        pr, _, again = moe.route(router, xg.to(router.device), K)
        bad = (again.sort(-1).values != eg.to(again.device).sort(-1).values).any(-1)
        for t in bad.nonzero()[:, 0].tolist():
            same_input.append(f"call {i} token {t}: {first} picks {eg[t].tolist()}, the "
                              f"{second}'s router on the same input {again[t].tolist()}, "
                              f"top-{K} margin {float(topk_margin(pr[t:t + 1], K)[0]):.3g}")
        own = pc.topk(K, dim=-1).indices.sort(-1).values
        flip = (own != ec.sort(-1).values).any(-1)
        for t in flip.nonzero()[:, 0].tolist():
            margin = float(topk_margin(pc[t:t + 1], K)[0])
            own_margins.append(margin)
            own_input.append(f"call {i} token {t}: the {second}'s own input picks "
                             f"{own[t].tolist()}, the {first}'s {ec[t].tolist()}, top-{K} "
                             f"margin {margin:.3g}")
    summary = {"calls": len(first_log.seen), "same_input_mismatches": len(same_input),
               "own_input_flips": len(own_input),
               "own_input_flip_margins": sorted(own_margins)[:8]}
    return summary, same_input + (own_input if strict else [])


def replayed(first, second):
    """Run ``first`` with its MoE picks recorded, then ``second`` replaying
    them (moe.ROUTE_LOG; a model without MoE layers records none):
    (first's result, second's, first's log, second's log)."""
    from repro_torch.models import moe

    first_log = moe.RouteLog()
    try:
        moe.ROUTE_LOG = first_log
        a = first()
        moe.ROUTE_LOG = second_log = moe.RouteLog([e for _, _, e in first_log.seen])
        b = second()
    finally:
        moe.ROUTE_LOG = None
    if second_log.replay:
        raise AssertionError(f"{len(second_log.replay)} replayed picks unused")
    return a, b, first_log, second_log


def reference_run(cfg, device: str = "cuda") -> tuple[list[float], dict, list[str]]:
    """One small model served on ``device`` and on the CPU from the same
    weights and the same modality stub, prefill of 2 x 100 tokens (after 16
    patches for the vision model) then 3 decode steps: (rel of each step's
    logits, route summary, route faults).  For a MoE model each CPU call
    replays the experts the card picked for it (moe.ROUTE_LOG): a pick is a
    discontinuous function of its input, and the card's and the CPU's bf16
    hidden states differ by rounding, so a near-tie could flip and move a
    token's output by O(1).  The routers are held to each other apart, on
    the same inputs (route_check)."""
    from repro_torch.models import build, moe

    cpu, gpu = build(cfg, device="cpu", seed=SEED), build(cfg, device=device)
    pc = cpu.init()
    pg = gpu.load({k: v.to(device) for k, v in pc.state_dict().items()})
    batch = prompt_on(cfg, 2, 100, "cpu")
    n = positions(batch) + 4
    card_log, cpu_log = moe.RouteLog(), moe.RouteLog()

    def both(card_step, cpu_step):
        """The card's step (its picks recorded), then the CPU's (replaying them)."""
        card, cpu_out, card_step_log, cpu_step_log = replayed(card_step, cpu_step)
        card_log.seen += card_step_log.seen
        cpu_log.seen += cpu_step_log.seen
        return card, cpu_out

    (cg, lg), (cc, lc) = both(lambda: gpu.prefill(pg, gpu.init_cache(2, n),
                                                  {k: t.to(device) for k, t in batch.items()}),
                              lambda: cpu.prefill(pc, cpu.init_cache(2, n), batch))
    rel = [_rel(lg.cpu(), lc)]
    for _ in range(3):
        nxt = lc.argmax(-1)
        (cg, lg), (cc, lc) = both(lambda: gpu.decode_step(pg, cg, nxt.to(device)),
                                  lambda: cpu.decode_step(pc, cc, nxt))
        rel.append(_rel(lg.cpu(), lc))
    if not cfg.n_experts:
        return rel, {}, []
    routes, faults = route_check(card_log, cpu_log, pc, cfg, strict=cfg.dtype == "float32")
    return rel, routes, faults


def phase_reference():
    from repro_torch import configs

    out, failed = {}, []
    for arch, (what, cut) in REFERENCE.items():
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).removeprefix("torch.")
            cfg = configs.get(arch).with_(vocab_size=512, dtype=name, **cut)
            rel, routes, faults = reference_run(cfg)
            entry = {"cfg": f"{arch} cut to {what}, {name}, prompt 100 tokens",
                     "tol": TOL_REF[dt], "prefill_then_decode_rel": rel}
            if cfg.n_experts:
                entry.update(routes=routes, route_faults=faults[:4])
            out[f"{arch} {name}"] = entry
            if max(rel) >= TOL_REF[dt] or faults:
                failed.append(f"{arch} {name}")
    emit("reference", **out)
    if failed:
        raise AssertionError(f"card and CPU paths disagree: {failed}")


# Card against CPU in training: bounds on the per-step loss and on every
# leaf's step-1 gradient (max|card - CPU| / max|CPU|).  bf16 gradients carry
# 2-4% rounding noise in either framework (tests/test_torch_train.py); the
# SSM families' more (up to 45% on the reduced configs), so for them each
# bf16 gradient is held at the bound plus twice the CPU's own bf16 error on
# that leaf (its distance from the f32 gradient at the same weights).
TRAIN_TOL = {"float32": (1e-4, 2e-4), "bfloat16": (3e-2, 5e-2)}
NOISY_BF16 = ("zamba2-7b", "rwkv6-1.6b")


def whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor, or an FSDP2 DTensor gathered whole."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# The plans of phase_train_reference the MoE family does not take: its
# layout across a mesh is ROADMAP A14b (train.step.check_plan refuses it).
MOE_SKIPPED_PLANS = ("offload", "zero3")


def phase_train_reference():
    """The small models of TRAIN_REFERENCE trained 3 AdamW steps on the card and
    on the CPU from the same weights and batches, under five plans (the MoE
    models under three), in f32 and in bf16; a MoE model's card run replays
    the CPU run's expert picks, and its routers are held to each other on
    the step-1 inputs (route_check)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.models import ModelOpts, build
    from repro_torch.parallel.plan import ExecutionPlan
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.step import compile_train_step, make_train_step

    # The card runs the last two plans through compile_train_step on a
    # one-rank NCCL group (moments in pinned host memory; FSDP2's hooks
    # around the kernels' autograd functions); the CPU runs make_train_step,
    # which acts on ga_steps alone, so each plan's CPU side is the same
    # arithmetic as its card side.
    plans = {"plain": ExecutionPlan(), "ga_steps=2": ExecutionPlan(ga_steps=2),
             "gc": ExecutionPlan(gc=True),
             "offload": ExecutionPlan(zero_stage=1, offload=True),
             "zero3": ExecutionPlan(zero_stage=3)}
    mesh = single_device_mesh("cuda")
    optcfg = OptConfig(lr=1e-3)
    out, failed = {}, []
    for arch, (what, cut) in TRAIN_REFERENCE.items():
        is_moe = "n_experts" in cut
        for dtype, (tol_loss, tol_grad) in TRAIN_TOL.items():
            cfg = configs.get(arch).with_(vocab_size=512, dtype=dtype, **cut)
            # 100 tokens a row, after 16 patches for the vision model, and
            # the encoder-decoder's 128 frames
            data = make_source(DataConfig(vocab_size=512, seq_len=stub_seq(cfg, 100),
                                          global_batch=2, seed=SEED))
            batch0 = train_batch_on(cfg, data, 0, "cpu")
            specs = {k: torch.empty(t.shape, dtype=t.dtype, device="meta")
                     for k, t in batch0.items()}
            for label, plan in plans.items():
                if is_moe and label in MOE_SKIPPED_PLANS:
                    continue
                opts = ModelOpts(remat="full" if plan.gc else "none", loss_chunk=0)
                cpu = build(cfg, device="cpu", seed=SEED, opts=opts)
                gpu = build(cfg, device="cuda", opts=opts)
                pc = cpu.init()
                state = {k: v.cuda() for k, v in pc.state_dict().items()}
                if plan.zero_stage:
                    step_g, _, _, _, pg, sg = compile_train_step(gpu, plan, mesh, optcfg, specs,
                                                                 state=state)
                else:
                    pg = gpu.load(state)
                    sg, step_g = opt_init(pg, optcfg), make_train_step(gpu, plan, optcfg)

                def grads_of(m, p):
                    loss, _ = m.loss(p, {k: t.to(m.device) for k, t in batch0.items()})
                    loss.backward()
                    g = {n: whole(t.grad).detach().cpu() for n, t in p.named_parameters()}
                    p.zero_grad(set_to_none=True)
                    return g

                # The card under the CPU's picks (none without MoE layers).
                gc_, gg, cpu_log, card_log = replayed(lambda: grads_of(cpu, pc),
                                                      lambda: grads_of(gpu, pg))
                routes, route_faults = route_check(
                    cpu_log, card_log, pg, cfg, strict=dtype == "float32",
                    names=("CPU", "card")) if is_moe else ({}, [])
                del cpu_log, card_log
                grads = [gc_, gg]
                grad_rel = {n: _rel(grads[1][n], g) for n, g in grads[0].items()}
                noise = {n: 0.0 for n in grad_rel}
                if dtype == "bfloat16" and arch in NOISY_BF16:
                    f32 = build(cfg.with_(dtype="float32"), device="cpu", opts=opts)
                    p32 = f32.load({k: v.float() for k, v in pc.state_dict().items()})
                    f32.loss(p32, batch0)[0].backward()
                    noise = {n: _rel(grads[0][n], t.grad) for n, t in p32.named_parameters()}
                    del f32, p32
                bound = {n: tol_grad + 2 * noise[n] for n in grad_rel}
                sc, step_c = opt_init(pc, optcfg), make_train_step(cpu, plan, optcfg)
                loss_rel, losses = [], []
                for i in range(3):
                    b = train_batch_on(cfg, data, i, "cpu")
                    (pc, sc, mc), (pg, sg, mg), _, _ = replayed(
                        lambda: step_c(pc, sc, b),
                        lambda: step_g(pg, sg, {k: t.cuda() for k, t in b.items()}))
                    loss_rel.append(abs(mg["loss"].item() - mc["loss"].item())
                                    / abs(mc["loss"].item()))
                    losses.append(mg["loss"].item())
                worst = max(grad_rel, key=grad_rel.get)
                tightest = max(grad_rel, key=lambda n: grad_rel[n] / bound[n])
                entry = out[f"{arch} {dtype} {label}"] = {
                    "loss_rel": loss_rel, "losses": losses,
                    "step1_grad_rel_max": grad_rel[worst], "step1_grad_rel_argmax": worst,
                    "step1_grad_bound_at_argmax": bound[worst],
                    "step1_grad_closest_to_bound": tightest,
                    "step1_grad_rel_there": grad_rel[tightest], "bound_there": bound[tightest]}
                if is_moe:
                    entry.update(routes=routes, route_faults=route_faults[:4])
                if (max(loss_rel) > tol_loss or grad_rel[tightest] > bound[tightest]
                        or not np.isfinite(losses).all() or route_faults):
                    failed.append(f"{arch} {dtype} {label}")
                if plan.offload and not all(t.is_pinned() for k in ("m", "v")
                                            for t in sg[k].values()):
                    failed.append(f"{arch} {dtype} {label}: moments not in pinned host memory")
                del pg, sg, gpu, grads, step_g
    # The backward ran on autograd's device thread, whose cuBLAS handle kept
    # a workspace of its own: 32 MiB on every later phase's peak memory.
    torch._C._cuda_clearCublasWorkspaces()
    free_device_memory()
    emit("train_reference", cfg={arch: f"{arch} widths cut to {what}" for arch, (what, _)
                                 in TRAIN_REFERENCE.items()},
         batch="batch 2, seq 100 (after 16 patches for phi-3-vision; 128 frames for "
         "seamless-m4t, drawn as the launcher draws them), AdamW lr 1e-3, 3 steps",
         tol_loss_grad=TRAIN_TOL,
         plans={label: plan.strategy for label, plan in plans.items()},
         moe_plans_skipped={label: "the MoE family's plans across a mesh are ROADMAP A14b"
                            for label in MOE_SKIPPED_PLANS},
         moe_picks="the card replays the CPU's expert picks; routers held on step 1's inputs",
         noisy_bf16_bound="tol_grad + 2 x |CPU bf16 - CPU f32| per leaf for " +
         ", ".join(NOISY_BF16), **out)
    if failed:
        raise AssertionError(f"card and CPU training disagree: {failed}")


def kernel_counters():
    from repro_torch.kernels import flash_attention, ssd_scan, wkv6

    return {"flash_attention_fwd": (flash_attention.flash_attention_fwd,
                                    flash_attention.flash_attention_plain),
            "flash_attention_bwd": (flash_attention.flash_attention_bwd,
                                    flash_attention.flash_attention_bwd_plain),
            "ssd_scan_fwd": (ssd_scan.ssd_scan_fwd, ssd_scan.ssd_scan_plain),
            "ssd_scan_bwd": (ssd_scan.ssd_scan_bwd, ssd_scan.ssd_scan_bwd_plain),
            "wkv6_fwd": (wkv6.wkv6_fwd, wkv6.wkv6_plain),
            "wkv6_bwd": (wkv6.wkv6_bwd, wkv6.wkv6_bwd_plain)}


def reset_counts(counters) -> None:
    for fwd, plain in counters.values():
        fwd.launches = 0
        plain.calls = 0
    counters["wkv6_fwd"][0].decode_launches = 0
    counters["flash_attention_fwd"][0].noncausal_launches = 0
    counters["flash_attention_bwd"][0].noncausal_launches = 0


def read_counts(counters) -> tuple[dict[str, int], dict[str, int]]:
    """(kernel launches, plain-version calls) since reset_counts."""
    launches = {name: fwd.launches for name, (fwd, _) in counters.items()}
    launches["wkv6_decode"] = counters["wkv6_fwd"][0].decode_launches
    for kname in ("flash_attention_fwd", "flash_attention_bwd"):
        launches[f"{kname}_noncausal"] = counters[kname][0].noncausal_launches
    return launches, {name: plain.calls for name, (_, plain) in counters.items()}


# The dryrun phase: paths whose one more step (untimed, after their timed
# ones) is counted on the card's real tensors by repro_torch.core.op_cost;
# phase_dryrun counts each again on fake CUDA tensors (FakeTensorMode) and
# holds the two counts equal.  {path: record}
COUNTED: dict = {}
SERVE_COUNTED = ("llama2-7b", "zamba2-7b", "rwkv6-1.6b")
SERVED_MS: dict = {}


def zeros_like_batch(batch: dict) -> dict:
    """A batch of zeros with the shapes and dtypes of ``batch`` on the card
    (fake tensors under FakeTensorMode)."""
    return {k: torch.zeros(t.shape, dtype=t.dtype, device="cuda") for k, t in batch.items()}


def count_real(path: str, run, rebuild, measured_ms: float, shape, cfg) -> None:
    """Count one call of ``run`` (a step of ``path`` on the card's real
    tensors) with the card's peak over it, and keep ``rebuild`` (which, under
    FakeTensorMode, builds the same call on fake tensors: ``(run, held)``)
    for phase_dryrun.  ``shape`` is the step's ShapeConfig (its model
    FLOPs)."""
    from repro_torch.core import costs, op_cost

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, cost = op_cost.count(run)
    torch.cuda.synchronize()
    COUNTED[path] = {"real": cost, "rebuild": rebuild, "measured_ms": measured_ms,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "model_flops": costs.model_flops(cfg, shape), "shape": shape,
                     "arch": cfg.name, "count_s": time.perf_counter() - t0}


def serve_rebuild(cfg, batch: dict, max_len: int, kind: str, pos: int = 0):
    """The fake twin of a served prefill (of ``batch``'s shapes) or decode
    (at cache position ``pos``) of ``cfg`` at full width."""
    def rebuild():
        from repro_torch.models import build

        model = build(cfg, device="cuda", seed=SEED)
        params = model.init()
        fake = zeros_like_batch(batch)
        B = fake["tokens"].shape[0]
        cache = model.init_cache(B, max_len)
        if kind == "prefill":
            return (lambda: model.prefill(params, cache, fake)), (params, cache, fake)
        cache["pos"] = pos
        tok = torch.zeros((B,), dtype=torch.long, device="cuda")
        return (lambda: model.decode_step(params, cache, tok)), (params, cache, tok)
    return rebuild


def count_serve(cfg, model, params, batch: dict, max_len: int, prefill_ms: float,
                decode_ms: float) -> None:
    """Count one more prefill and one more decode step of a served model."""
    from repro_torch.configs.base import ShapeConfig

    B, P = batch["tokens"].shape
    cache = model.init_cache(B, max_len)
    count_real(f"{cfg.name} prefill", lambda: model.prefill(params, cache, batch),
               serve_rebuild(cfg, batch, max_len, "prefill"), prefill_ms,
               ShapeConfig("prefill", positions(batch), B, "prefill"), cfg)
    pos = cache["pos"]
    tok = torch.zeros((B,), dtype=torch.long, device="cuda")
    count_real(f"{cfg.name} decode", lambda: model.decode_step(params, cache, tok),
               serve_rebuild(cfg, batch, max_len, "decode", pos), decode_ms,
               ShapeConfig("decode", pos + 1, B, "decode"), cfg)
    del cache


def train_rebuild(make_step, batch: dict):
    """The fake twin of a train step: ``make_step()`` builds (model, params,
    opt_state, step) as the path did."""
    def rebuild():
        _, params, opt_state, step = make_step()
        fake = zeros_like_batch(batch)
        return (lambda: step(params, opt_state, fake)), (params, opt_state, fake)
    return rebuild


def op_host_cost(decode_ms: float, n_calls: int, rounds: int = 15, calls: int = 200) -> dict:
    """Host microseconds a call of the WKV6 forward at the rwkv6-1.6b decode
    shape (batch 4, S = 1) costs through its op (``kernels.registry``) and
    as a direct call of the checked launch the op wraps: the median over
    ``rounds`` rounds of ``calls`` back-to-back calls (host-bound: the decode
    kernel takes a few µs on the card).  The op's extra cost times the
    ``n_calls`` WKV6 calls of one decode step is set beside that step's ms."""
    from repro_torch.kernels import wkv6

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, hd = 4, 32, 64
    r, k, v = (torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    logw = -torch.rand((B, 1, H, hd), generator=gen, device="cuda")
    u = torch.randn((H, hd), generator=gen, device="cuda")
    s0 = torch.randn((B, H, hd, hd), generator=gen, device="cuda")
    fns = {"direct": lambda: wkv6._fwd_cuda(r, k, v, logw, u, s0),
           "op": lambda: wkv6.wkv6_fwd(r, k, v, logw, u, s0)}
    per_call = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            per_call[name].append((time.perf_counter() - t0) / calls * 1e6)
    us = {name: float(np.median(x)) for name, x in per_call.items()}
    extra = us["op"] - us["direct"]
    out = {"us_per_call": us, "extra_us_per_call": extra, "decode_ms_per_token": decode_ms,
           "wkv6_calls_per_decode_step": n_calls,
           "share_of_decode": extra * n_calls / (decode_ms * 1e3)}
    emit("op_host_cost", **out)
    return out


# Served at full width, one after the other: the launches each kernel must
# make over one generate call of G decode steps.
SERVED = {
    "llama2-7b": lambda cfg, G: {"flash_attention_fwd": cfg.n_layers},
    "zamba2-7b": lambda cfg, G: {"ssd_scan_fwd": cfg.n_layers,
                                 "flash_attention_fwd": cfg.n_layers // cfg.attn_every},
    "rwkv6-1.6b": lambda cfg, G: {"wkv6_fwd": cfg.n_layers * (G + 1),
                                  "wkv6_decode": cfg.n_layers * G},
    "moonshot-v1-16b-a3b": lambda cfg, G: {"flash_attention_fwd": cfg.n_layers},
    # every launch at d 192 / dv 128 (MLA prefill)
    "deepseek-v3-671b": lambda cfg, G: {"flash_attention_fwd": cfg.n_layers},
    # per prefill: each encoder layer (bidirectional), each decoder layer's
    # self (causal) and cross-attention (non-causal, Sq 512 < Sk 1024)
    "seamless-m4t-large-v2": lambda cfg, G: {
        "flash_attention_fwd": cfg.enc_layers + 2 * cfg.n_layers,
        "flash_attention_fwd_noncausal": cfg.enc_layers + cfg.n_layers},
    # every launch at d 96, over 576 patches + 512 tokens
    "phi-3-vision-4.2b": lambda cfg, G: {"flash_attention_fwd": cfg.n_layers},
}
# Served models cut in depth to fit one card: (what was cut, the cut).
SERVE_CUT = {
    "deepseek-v3-671b": ("n_layers 61 -> 4 (its 3 dense layers and 1 MoE layer of 256 experts, "
                         "plus the MTP block): 671.7e9 parameters do not fit one card; every "
                         "width is the published one", dict(n_layers=4)),
}


def split_picks(seen, B: int, k: int) -> list[torch.Tensor]:
    """The picks a prefill of k + 1 tokens made (one dispatch chunk a layer),
    as a prefill of its first k tokens and a decode of token k make them, in
    call order."""
    picks = [eidx.view(B, k + 1, -1) for _, _, eidx in seen]
    return [e[:, :k].reshape(B * k, -1) for e in picks] + [e[:, k] for e in picks]


def decode_vs_prefill(model, params, batch: dict) -> float:
    """rel of prefill(t[:k]) + decode(t[k]) against prefill(t[:k+1]), k = P - 1,
    on the same modality stub.
    A MoE model runs at capacity factor 8, as tests/test_models_smoke.py
    (token dropping depends on the sequence length by design), and its cache
    path under the experts its parallel path picked: the two paths' bf16
    rounding differs, and a near-tie in a router flips on it."""
    from repro_torch.models import build, moe

    tokens = batch["tokens"]
    B, P = tokens.shape
    k = P - 1
    n = positions(batch) + 1
    if model.cfg.n_experts:
        model = build(model.cfg.with_(capacity_factor=8.0), device=model.device,
                      opts=model.opts)
    try:
        moe.ROUTE_LOG = par_log = moe.RouteLog()
        _, par = model.prefill(params, model.init_cache(B, n), batch)
        moe.ROUTE_LOG = log = moe.RouteLog(split_picks(par_log.seen, B, k))
        del par_log
        cache, _ = model.prefill(params, model.init_cache(B, n),
                                 dict(batch, tokens=tokens[:, :k]))
        _, dec = model.decode_step(params, cache, tokens[:, k])
        if log.replay:
            raise AssertionError(f"{model.cfg.name}: {len(log.replay)} replayed picks unused")
    finally:
        moe.ROUTE_LOG = None
    if not finite(dec.float(), par.float()):
        raise AssertionError(f"{model.cfg.name}: logits not finite at full width")
    return _rel(dec, par)


def phase_serve(arch: str) -> dict[str, int]:
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeEngine

    cut, cut_kw = SERVE_CUT.get(arch, ("none", {}))
    cfg = configs.get(arch).with_(**cut_kw)
    B, P, G = 4, 512, 32
    model = build(cfg, device="cuda", seed=SEED)
    t0 = time.perf_counter()
    params = model.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    batch = prompt_on(cfg, B, P, "cuda")
    max_len = positions(batch) + G + 1
    engine = ServeEngine(model, params, max_len=max_len)

    # The counted run: one generate call, nothing else.
    counters = kernel_counters()
    want = SERVED[arch](cfg, G)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    t0 = time.perf_counter()
    out = engine.generate(batch, steps=G)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches, plain_calls = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    expected = {name: want.get(name, 0) for name in launches}
    if launches != expected or any(plain_calls.values()):
        raise AssertionError(f"{arch}: generate made {launches} kernel launches and "
                             f"{plain_calls} plain calls; expected {expected} and none")
    if out.shape != (B, G + 1) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{arch}: bad generate output {tuple(out.shape)}")

    t0 = time.perf_counter()
    out2 = engine.generate(batch, steps=G)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not torch.equal(out, out2):
        raise AssertionError(f"{arch}: greedy decoding is not repeatable")

    prefill_s = []
    for _ in range(3):
        cache = model.init_cache(B, max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = model.prefill(params, cache, batch)
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
    if arch in SERVE_COUNTED:
        count_serve(cfg, model, params, batch, max_len, min(prefill_s) * 1e3, decode_ms)
        SERVED_MS[arch] = {"prefill_ms": min(prefill_s) * 1e3, "decode_ms": decode_ms}

    # Decode must continue prefill: prefill(t[:k]) + decode(t[k]) vs prefill(t[:k+1]).
    rel = decode_vs_prefill(model, params, batch)
    stub = {k: list(t.shape) for k, t in batch.items() if k != "tokens"}
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, enc_layers=cfg.enc_layers,
         d_model=cfg.d_model, cut=cut, n_params=n_params, dtype="bfloat16", batch=B,
         prompt=P, prompt_positions=positions(batch), stub=stub, gen=G,
         init_s=init_s, cold_generate_s=cold_s, warm_generate_s=warm_s,
         tok_per_s=B * G / warm_s, prefill_ms=min(prefill_s) * 1e3,
         prefill_ms_all=[s * 1e3 for s in prefill_s], decode_ms_per_token=decode_ms,
         decode_tok_per_s=B / decode_ms * 1e3, max_memory_allocated=peak,
         launches=launches, plain_calls=plain_calls,
         decode_vs_prefill_rel=rel, first_tokens=out[0, :8].tolist())
    if rel >= 0.08:
        raise AssertionError(f"{arch}: decode/prefill mismatch at full width: rel={rel}")
    phase_trace(arch, model, params, batch, max_len)
    del engine, params, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# Device-side names of the port's kernels, as the profiler lists them.
PORT_KERNEL_NAMES = ("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel", "flash_bwd_dq",
                     "flash_bwd_dkdv", "ssd_fwd_bf16_kernel", "ssd_fwd_f32_kernel",
                     "wkv6_fwd_bf16_kernel", "wkv6_fwd_f32_kernel", "wkv6_decode_kernel",
                     "ssd_bwd_bf16_kernel", "ssd_bwd_states_kernel", "ssd_bwd_f32_kernel",
                     "wkv6_bwd_kernel", "wkv6_bwd_sums_kernel", "wkv6_bwd_scan_kernel",
                     "wkv6_bwd_chunk_kernel")


def device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, count) of every kernel in a torch.profiler run,
    longest first."""
    kern = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    return sorted((k for k in kern if k[1] > 0), key=lambda k: -k[1])


def phase_trace(arch, model, params, batch: dict, max_len: int, steps: int = 8):
    """torch.profiler over one prefill and `steps` decode steps (warm): device
    time by kernel (the top 8, and each of the port's kernels with its share
    of the busy time), and the device's idle share of each window's wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    B = batch["tokens"].shape[0]
    for label in ("prefill", "decode"):
        cache, logits = model.prefill(params, model.init_cache(B, max_len), batch)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if label == "prefill":
                model.prefill(params, model.init_cache(B, max_len), batch)
            else:
                for _ in range(steps):
                    cache, logits = model.decode_step(params, cache, tok)
                    tok = logits.argmax(-1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kern = device_kernels(prof)
        busy = sum(ms for _, ms, _ in kern)
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


# Trained at full width after the serve phases: the launches each kernel must
# make over `n` train steps.  llama2-7b runs under gc (remat), so each layer's
# forward runs twice: once in the forward, once recomputed in the backward.
TRAINED = {
    "llama2-7b train": lambda cfg, n: {"flash_attention_fwd": 2 * cfg.n_layers * n,
                                       "flash_attention_bwd": cfg.n_layers * n},
    "llama2-7b train offload": lambda cfg, n: {"flash_attention_fwd": 2 * cfg.n_layers * n,
                                               "flash_attention_bwd": cfg.n_layers * n},
    "gpt2-1.5b train": lambda cfg, n: {"flash_attention_fwd": cfg.n_layers * n,
                                       "flash_attention_bwd": cfg.n_layers * n},
    "zamba2-7b train": lambda cfg, n: {
        "ssd_scan_fwd": 2 * cfg.n_layers * n, "ssd_scan_bwd": cfg.n_layers * n,
        "flash_attention_fwd": 2 * (cfg.n_layers // cfg.attn_every) * n,
        "flash_attention_bwd": (cfg.n_layers // cfg.attn_every) * n},
    "rwkv6-1.6b train": lambda cfg, n: {"wkv6_fwd": cfg.n_layers * n,
                                        "wkv6_bwd": cfg.n_layers * n},
    # GC as llama2-7b's: 2 forward and 1 backward flash launch a layer a step
    "moonshot-v1-16b-a3b train": lambda cfg, n: {"flash_attention_fwd": 2 * cfg.n_layers * n,
                                                 "flash_attention_bwd": cfg.n_layers * n},
    # every launch at d 192 / dv 128; the MTP block runs outside the
    # checkpointed layers, so its attention forward runs once a step
    "deepseek-v3-671b train": lambda cfg, n: {
        "flash_attention_fwd": (2 * cfg.n_layers + cfg.mtp_depth) * n,
        "flash_attention_bwd": (cfg.n_layers + cfg.mtp_depth) * n},
    # GC as llama2-7b's, every launch at d 96 over 576 patches + 512 tokens
    "phi-3-vision-4.2b train": lambda cfg, n: {"flash_attention_fwd": 2 * cfg.n_layers * n,
                                               "flash_attention_bwd": cfg.n_layers * n},
    # the launcher, no GC: each encoder layer (non-causal), each decoder
    # layer's self (causal) and cross-attention (non-causal, Sq 512 < Sk
    # 1024), once forward and once backward a step
    "seamless-m4t-large-v2 train": lambda cfg, n: {
        "flash_attention_fwd": (cfg.enc_layers + 2 * cfg.n_layers) * n,
        "flash_attention_fwd_noncausal": (cfg.enc_layers + cfg.n_layers) * n,
        "flash_attention_bwd": (cfg.enc_layers + 2 * cfg.n_layers) * n,
        "flash_attention_bwd_noncausal": (cfg.enc_layers + cfg.n_layers) * n},
}
# The trained MoE paths, cut in depth to fit one card with their gradients
# and bf16 moments: (what was cut, the cut, AdamW's learning rate).
# deepseek-v3-671b runs at its published peak rate, 2.2e-4 (arXiv:2412.19437
# §4.2): at llama2-7b's 1e-3 its loss on one fixed batch rose over steps 2-3
# (16.0, 8.7, 14.4, then 18.9; grad norm 11 -> 80), where the port and the
# JAX package follow the same trajectory at either rate on a narrower cut
# (CHANGES.md).
TRAIN_CUT = {
    "moonshot-v1-16b-a3b": ("n_layers 48 -> 10: 1 dense and 9 MoE layers of 64 experts top-6 "
                            "and 2 shared, 6.0e9 parameters (the 48 layers' 28.4e9 with their "
                            "gradients and moments do not fit one card); every width is the "
                            "published one", dict(n_layers=10), 1e-3),
    "deepseek-v3-671b": ("n_layers 61 -> 3: its 3 dense layers (MLA, 128 heads of 192 / 128) "
                         "and the MTP block, 4.3e9 parameters; a routed layer (256 experts, "
                         "11.3e9 parameters) with its gradients and moments does not fit one "
                         "card beside them (expert sharding across cards is ROADMAP A14b); "
                         "every width is the published one", dict(n_layers=3), 2.2e-4),
}
# The port kernels a train step's profile reports, by the substring of their
# device-side names.
TRACE_SHARES = {
    "llama2-7b train": {"flash_fwd": "flash_fwd_bf16_kernel", "flash_bwd": "flash_bwd_"},
    "zamba2-7b train": {"ssd_fwd": "ssd_fwd_bf16_kernel", "ssd_bwd": "ssd_bwd_",
                        "ssd_bwd_states": "ssd_bwd_states_kernel",
                        "flash_fwd": "flash_fwd_bf16_kernel", "flash_bwd": "flash_bwd_"},
    "rwkv6-1.6b train": {"wkv6_fwd": "wkv6_fwd_bf16_kernel", "wkv6_bwd": "wkv6_bwd_",
                         "wkv6_bwd_sums": "wkv6_bwd_sums_kernel",
                         "wkv6_bwd_scan": "wkv6_bwd_scan_kernel",
                         "wkv6_bwd_chunks": "wkv6_bwd_chunk_kernel"},
    "moonshot-v1-16b-a3b train": {"flash_fwd": "flash_fwd_bf16_kernel", "flash_bwd": "flash_bwd_"},
    "deepseek-v3-671b train": {"flash_fwd": "flash_fwd_bf16_kernel", "flash_bwd": "flash_bwd_"},
    "phi-3-vision-4.2b train": {"flash_fwd": "flash_fwd_bf16_kernel", "flash_bwd": "flash_bwd_"},
    "seamless-m4t-large-v2 train": {"flash_fwd": "flash_fwd_bf16_kernel",
                                    "flash_bwd": "flash_bwd_"},
}


def free_device_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def check_launches(path: str, cfg, steps: int, launches, plain_calls,
                   want: dict[str, int] | None = None) -> None:
    """Each kernel launched exactly as `want` (by default TRAINED[path] over
    `steps` steps) says, the others never, and no plain version called."""
    want = TRAINED[path](cfg, steps) if want is None else want
    expected = {name: want.get(name, 0) for name in launches}
    if launches != expected or any(plain_calls.values()):
        raise AssertionError(f"{path}: {steps} steps made {launches} kernel launches and "
                             f"{plain_calls} plain calls; expected {expected} and none")


# Rounds of train_split timed after its warm-up round.
SPLIT_ROUNDS = 3
# Train paths whose one more step the dryrun phase counts.
TRAIN_COUNTED = ("llama2-7b", "zamba2-7b", "rwkv6-1.6b")


def step1_repeat(model, params, batch) -> dict:
    """The loss, metrics and every gradient of one step's forward + backward,
    twice from the same weights: whether the two agree bit for bit."""
    runs = []
    for _ in range(2):
        loss, metrics = model.loss(params, batch)
        loss.backward()
        runs.append((loss.detach(), {k: v.detach() for k, v in metrics.items()},
                     [p.grad for p in params.parameters()]))
        for p in params.parameters():
            p.grad = None
    (l0, m0, g0), (l1, m1, g1) = runs
    same_grads = sum(torch.equal(a, b) for a, b in zip(g0, g1))
    out = {"loss_bit_equal": torch.equal(l0, l1),
           "metrics_bit_equal": all(torch.equal(m0[k], m1[k]) for k in m0),
           "grads_bit_equal": same_grads, "grads": len(g0)}
    del runs, g0, g1
    return out


def phase_train_fixed(arch: str, steps: int = 3) -> tuple[dict[str, int], int]:
    """llama2-7b, zamba2-7b, phi-3-vision-4.2b (576 patches before the 512
    tokens, drawn as the launcher draws them) or a MoE path of TRAIN_CUT (cut
    in depth), bf16, batch 4, seq 512, through make_train_step with
    ExecutionPlan(gc=True) and AdamW with bf16 moments (f32 moments would
    need 6.74e9 x 12 bytes = 80.9 GB for llama2-7b), on one fixed batch;
    then a profile of one step,
    and a step's two halves (forward + backward, the update) timed apart.  A
    MoE path first runs step 1's forward + backward twice, which must agree
    bit for bit, and reports each step's ce / aux / mtp.  Returns the
    launches and the peak device bytes of the 3 steps."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import ModelOpts, build
    from repro_torch.parallel.plan import ExecutionPlan
    from repro_torch.train.optimizer import OptConfig, opt_init, opt_update
    from repro_torch.train.step import make_train_step

    path = f"{arch} train"
    cut, cut_kw, lr = TRAIN_CUT.get(arch, ("none", {}, 1e-3))
    cfg = configs.get(arch).with_(**cut_kw)
    B, S = 4, 512
    plan = ExecutionPlan(gc=True)
    optcfg = OptConfig(lr=lr, moment_dtype="bfloat16")
    free_device_memory()
    model = build(cfg, device="cuda", seed=SEED, opts=ModelOpts(remat="full", loss_chunk=0))
    params = model.init()
    n_params = sum(p.numel() for p in params.parameters())
    step = make_train_step(model, plan, optcfg)
    data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=stub_seq(cfg, S),
                                  global_batch=B, seed=SEED))
    batch = train_batch_on(cfg, data, 0, "cuda")
    positions = stub_seq(cfg, S)
    repeat = None
    if cfg.n_experts:
        repeat = step1_repeat(model, params, batch)
        free_device_memory()
    opt_state = opt_init(params, optcfg)

    counters = kernel_counters()
    reset_counts(counters)
    times, losses, gnorms, parts = [], [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        parts.append({k: metrics[k].item() for k in ("ce", "aux", "mtp") if k in metrics})
    launches, plain_calls = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    check_launches(path, cfg, steps, launches, plain_calls)
    step_ms = float(np.median(times[1:])) * 1e3
    with torch.no_grad():
        final = model.loss(params, batch)[0].item()
    if arch in TRAIN_COUNTED:
        # After the loss of the timed steps: the counted step updates params.
        from repro_torch.configs.base import ShapeConfig

        opts = model.opts

        def make_step():
            m = build(cfg, device="cuda", seed=SEED, opts=opts)
            p = m.init()
            return m, p, opt_init(p, optcfg), make_train_step(m, plan, optcfg)
        count_real(path, lambda: step(params, opt_state, batch),
                   train_rebuild(make_step, batch), step_ms,
                   ShapeConfig("train", positions, B, "train"), cfg)
    emit("train", path=path, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         cut=cut, n_params=n_params, dtype="bfloat16", batch=B, seq=S, plan=plan.strategy,
         optimizer=f"adamw lr {lr:g}, bf16 moments", steps=steps, losses=losses,
         loss_parts=parts if cfg.n_experts else None, loss_after_last_step=final,
         grad_norms=gnorms, step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
         tokens_per_s=B * S / step_ms * 1e3, max_memory_allocated=peak,
         **({"patches": cfg.n_patches, "positions_per_s": B * positions / step_ms * 1e3}
            if positions != S else {}),
         step1_repeat=repeat, launches=launches, plain_calls=plain_calls)
    if not (np.isfinite(losses).all() and np.isfinite(final) and final < losses[0]):
        raise AssertionError(f"{path}: loss did not fall on one batch: {losses} -> {final}")
    if repeat and not (repeat["loss_bit_equal"] and repeat["metrics_bit_equal"]
                       and repeat["grads_bit_equal"] == repeat["grads"]):
        raise AssertionError(f"{path}: step 1 repeated is not bit-equal: {repeat}")
    phase_train_trace(path, lambda: step(params, opt_state, batch), TRACE_SHARES[path])

    # One step's two halves timed apart: forward + backward, then the update;
    # a warm-up round (it allocates the .grad tensors), then the median of
    # SPLIT_ROUNDS rounds.
    named = dict(params.named_parameters())
    fwd_bwd, update = [], []
    for _ in range(1 + SPLIT_ROUNDS):
        for p in named.values():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.loss(params, batch)[0].backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt_update({n: p.grad for n, p in named.items()}, opt_state, params, optcfg)
        torch.cuda.synchronize()
        fwd_bwd.append((t1 - t0) * 1e3)
        update.append((time.perf_counter() - t1) * 1e3)
    emit("train_split", path=path, forward_backward_ms=float(np.median(fwd_bwd[1:])),
         optimizer_ms=float(np.median(update[1:])), forward_backward_ms_all=fwd_bwd,
         optimizer_ms_all=update)
    del params, opt_state, step, model, batch, metrics, named
    free_device_memory()
    return launches, peak


OFFLOAD_ROUNDS = 2       # forward + backward, then the update timed alone


def phase_train_offload(peak_on_device: int, steps: int = 3) -> dict[str, int]:
    """llama2-7b at full width, bf16, batch 4, seq 512, through
    compile_train_step on a one-rank NCCL group with
    ExecutionPlan(zero_stage=1, offload=True, gc=True) and OptConfig()'s f32
    moments: 6.74e9 x 8 bytes = 53.9 GB in pinned host memory, which cannot
    sit on the card beside the weights.  A warm-up step, then `steps` counted
    ones; every moment must be a pinned CPU tensor and the peak device bytes
    below `peak_on_device` (the GC + bf16-moments run's); then OFFLOAD_ROUNDS
    rounds of a forward + backward and the update timed apart, whose moments
    cross PCIe both ways."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.models import ModelOpts, build
    from repro_torch.parallel.plan import ExecutionPlan
    from repro_torch.train.optimizer import OptConfig, opt_update
    from repro_torch.train.step import compile_train_step

    path = "llama2-7b train offload"
    cfg = configs.get("llama2-7b")
    B, S = 4, 512
    plan = ExecutionPlan(zero_stage=1, offload=True, gc=True)
    optcfg = OptConfig()
    free_device_memory()
    model = build(cfg, device="cuda", seed=SEED, opts=ModelOpts(remat="full", loss_chunk=0))
    t0 = time.perf_counter()
    specs = {"tokens": torch.empty((B, S), dtype=torch.long, device="meta")}
    step, _, o_shard, _, params, opt_state = compile_train_step(
        model, plan, single_device_mesh("cuda"), optcfg, specs)
    setup_s = time.perf_counter() - t0
    moments = [t for k in ("m", "v") for t in opt_state[k].values()]
    if not all(t.device.type == "cpu" and t.is_pinned() for t in moments):
        raise AssertionError(f"{path}: a moment is not a pinned CPU tensor")
    moment_bytes = sum(t.numel() * t.element_size() for t in moments)
    blocks = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in moments}
    data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                  seed=SEED))
    batch = {"tokens": torch.from_numpy(data.batch(0)).long().cuda()}
    params, opt_state, metrics = step(params, opt_state, batch)      # warm-up
    torch.cuda.synchronize()
    counters = kernel_counters()
    reset_counts(counters)
    times, losses = [], [metrics["loss"].item()]
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
    launches, plain_calls = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    check_launches(path, cfg, steps, launches, plain_calls)
    if not all(t.device.type == "cpu" and t.is_pinned() for k in ("m", "v")
               for t in opt_state[k].values()):
        raise AssertionError(f"{path}: a moment left pinned host memory")
    named = dict(params.named_parameters())
    fwd_bwd, update = [], []
    for _ in range(OFFLOAD_ROUNDS):
        for p in named.values():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.loss(params, batch)[0].backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt_update({n: p.grad for n, p in named.items()}, opt_state, params, optcfg)
        torch.cuda.synchronize()
        fwd_bwd.append((t1 - t0) * 1e3)
        update.append((time.perf_counter() - t1) * 1e3)
    step_ms = float(np.median(times[1:])) * 1e3
    update_ms = float(np.median(update))
    one_way = pcie_one_way(max(moments, key=lambda t: t.numel()))
    host = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    emit("train_offload", path=path, arch=cfg.name, n_layers=cfg.n_layers,
         n_params=sum(p.numel() for p in named.values()), dtype="bfloat16", batch=B, seq=S,
         plan=plan.strategy, optimizer="adamw lr 3e-4 (OptConfig()), f32 moments in pinned "
         "host memory", moment_memory=sorted({s.memory_kind for s in o_shard["m"].values()}),
         setup_s=setup_s, steps=steps, losses=losses, step_ms=step_ms,
         step_ms_all=[t * 1e3 for t in times], tokens_per_s=B * S / step_ms * 1e3,
         max_memory_allocated=peak, peak_gc_bf16_moments_on_device=peak_on_device,
         pinned_moment_bytes=moment_bytes, pinned_blocks_bytes=sorted(blocks.values()),
         host_allocator={k: v for k, v in host.items() if "allocated_bytes" in k or
                         "reserved_bytes" in k},
         forward_backward_ms_all=fwd_bwd, optimizer_ms_all=update, optimizer_ms=update_ms,
         pcie_bytes_per_update=2 * moment_bytes,
         pcie_gb_per_s_both_ways=2 * moment_bytes / update_ms / 1e6, **one_way,
         launches=launches, plain_calls=plain_calls)
    if not (np.isfinite(losses).all() and peak < peak_on_device):
        raise AssertionError(f"{path}: losses {losses}, peak {peak} bytes against "
                             f"{peak_on_device} with the moments on the card")
    del params, opt_state, step, model, batch, metrics, named, moments
    free_device_memory()
    return launches


PCIE_REPS = 8


def pcie_one_way(host: torch.Tensor) -> dict:
    """The rate of one direction of PCIe alone: PCIE_REPS copies of a pinned
    host tensor (the largest moment leaf) to the card, then as many back
    into it (the same values), each direction timed by CUDA events after a
    warm-up copy.  GB/s are 1e9 bytes a second."""
    dev = torch.empty_like(host, device="cuda")
    nbytes = host.numel() * host.element_size()
    out = {"pcie_one_way_bytes": nbytes}
    for key, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        dst.copy_(src, non_blocking=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(PCIE_REPS):
            dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        out[f"pcie_gb_per_s_{key}"] = PCIE_REPS * nbytes / start.elapsed_time(end) / 1e6
    del dev
    return out


def phase_train_trace(path: str, run_step, shares: dict[str, str]) -> None:
    """torch.profiler over one train step: device time by kernel (the top
    10), the shares of the busy time of the port kernels named in `shares`
    (label: substring of the device-side name), and the device's idle share
    of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(prof)
    busy = sum(ms for _, ms, _ in kern)

    def share(tag):
        ms = sum(m for n, m, _ in kern if tag in n)
        return {"ms": ms, "count": sum(c for n, _, c in kern if tag in n),
                "share_of_busy": ms / busy if busy else None}

    emit("train_trace", path=path, note="device time from torch.profiler (CUPTI), one step, "
         "profiler on", wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=1 - busy / wall_ms if kern else None,
         **{label: share(tag) for label, tag in shares.items()},
         top=[{"kernel": n[:90], "ms": ms, "count": c} for n, ms, c in kern[:10]])


def phase_train_launcher(arch: str, steps: int = 3) -> dict[str, int]:
    """gpt2-1.5b, rwkv6-1.6b or seamless-m4t-large-v2 (1,024 frames drawn by
    the launcher), bf16, batch 4, seq 512, through the launcher
    (launch.train.train) with its own f32 AdamW; the step times are the
    launcher's own (each step up to reading its loss).  For the paths in
    TRACE_SHARES (rwkv6-1.6b, seamless-m4t-large-v2), one more step under
    the profiler."""
    from repro_torch import configs
    from repro_torch.launch.train import train

    path = f"{arch} train"
    cfg = configs.get(arch)
    B, S = 4, 512
    free_device_memory()
    counters = kernel_counters()
    reset_counts(counters)
    out = train(arch=arch, reduced=False, batch=B, seq=S, steps=steps, seed=SEED,
                log_every=1, device="cuda")
    launches, plain_calls = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    check_launches(path, cfg, steps, launches, plain_calls)
    n_params = sum(p.numel() for p in out["params"].parameters())
    times = out["step_seconds"]
    step_ms = float(np.median(times[1:])) * 1e3
    emit("train", path=path, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=n_params, dtype="bfloat16", batch=B, seq=S, plan="DP",
         optimizer="adamw lr 1e-3, f32 moments (the launcher's)", steps=steps,
         losses=out["losses"], step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
         tokens_per_s=B * S / step_ms * 1e3, max_memory_allocated=peak,
         **({"frames": cfg.n_frames} if cfg.is_encdec else {}),
         launches=launches, plain_calls=plain_calls)
    if not np.isfinite(out["losses"]).all():
        raise AssertionError(f"{path}: non-finite loss {out['losses']}")
    if arch in TRAIN_COUNTED:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.data.pipeline import DataConfig, make_source
        from repro_torch.launch.train import build_runtime
        from repro_torch.train.optimizer import OptConfig, opt_init
        from repro_torch.train.step import make_train_step

        data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                      seed=SEED))
        batch = train_batch_on(cfg, data, steps, "cuda")

        def make_step():
            _, m, plan = build_runtime(arch, False, {}, False, "cuda", SEED, S)
            p = m.init()
            optcfg = OptConfig(lr=1e-3)
            return m, p, opt_init(p, optcfg), make_train_step(m, plan, optcfg)
        count_real(path, lambda: out["step_fn"](out["params"], out["opt_state"], batch),
                   train_rebuild(make_step, batch), step_ms,
                   ShapeConfig("train", S, B, "train"), cfg)
    if path in TRACE_SHARES:
        from repro_torch.data.pipeline import DataConfig, make_source

        data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                      seed=SEED))
        batch = train_batch_on(cfg, data, steps, "cuda")
        phase_train_trace(path, lambda: out["step_fn"](out["params"], out["opt_state"], batch),
                          TRACE_SHARES[path])
    del out
    free_device_memory()
    return launches


# The profile phase: gpt2-1.5b as the paper's Table 2 profiles it (b 16, s
# 1024).  The fit set is the paper's profiling set (src/repro/core/oracle.py:
# 169-181) cut to its plans that take one GPU, at Alloc(1, 12); the held-out
# plans are other one-card plans, measured where the memory model calls them
# feasible.
PROFILE_ARCH = "gpt2-1.5b"
PROFILE_FIT = ({"zero_stage": 1}, {"zero_stage": 3, "gc": True},
               {"zero_stage": 1, "offload": True},
               {"zero_stage": 1, "offload": True, "gc": True})
PROFILE_HELD_OUT = ({"ga_steps": 2}, {"ga_steps": 4}, {"gc": True},
                    {"zero_stage": 1, "offload": True, "ga_steps": 2},
                    {"zero_stage": 3, "gc": True, "ga_steps": 2})
PROFILE_MICRO = (4, 512)          # TorchMicroOracle's own step: batch, seq


def flash_launches(cfg, plan, steps: int) -> dict[str, int]:
    """Flash launches of `steps` steps of a dense decoder under `plan`: each
    microbatch runs every layer's forward once (twice under GC) and its
    backward once."""
    fwd = cfg.n_layers * plan.ga_steps * steps
    return {"flash_attention_fwd": fwd * (2 if plan.gc else 1), "flash_attention_bwd": fwd}


def fit_engines(path: str, profile, samples: dict, env) -> tuple[dict, dict]:
    """The performance model fitted to samples["fit"] with both engines:
    ({engine: params, fit RMSLE, fit seconds, held-out (avg, max) relative
    error over samples["held_out"], predicted ms of every sample}, {engine:
    FitParams}).  Raises on a fit that is not finite."""
    from repro_torch.core.perfmodel import (fit, predict_titer_batch, prediction_error, rmsle,
                                            sample_arrays)

    cols, gpus, cpus, per_node, true = sample_arrays(samples["fit"], env)
    every = samples["fit"] + samples["held_out"]
    all_cols, all_gpus, all_cpus, all_node, _ = sample_arrays(every, env)
    fits, params = {}, {}
    for engine in ("batched", "scalar"):
        t1 = time.perf_counter()
        k = params[engine] = fit(profile, samples["fit"], env=env, engine=engine)
        fit_s = time.perf_counter() - t1
        vec = k.as_vector()
        if not np.isfinite(vec).all():
            raise AssertionError(f"{path}: the {engine} fit is not finite: {k}")
        pred = predict_titer_batch(profile, cols, gpus, cpus, env, k, per_node=per_node)
        avg, worst = prediction_error(profile, k, samples["held_out"], env)
        every_pred = predict_titer_batch(profile, all_cols, all_gpus, all_cpus, env, k,
                                         per_node=all_node)
        fits[engine] = {
            "params": fit_params(k), "fit_rmsle": rmsle(pred, true), "fit_s": fit_s,
            "held_out_err_avg": avg, "held_out_err_max": worst,
            "predicted_ms": {plan_label(pl): t * 1e3
                             for (pl, _, _), t in zip(every, every_pred)}}
    return fits, params


def fit_params(k) -> dict[str, float]:
    return dict(zip(("k_bwd", "k_sync", "k_opt", "k_opt_off", "k_off", "k_swap", "k_const"),
                    k.as_vector().tolist()))


def plan_label(plan) -> str:
    return f"{plan.strategy} {plan.ga_steps}"


def phase_profile() -> dict:
    """Rubick's profiling -> fit -> predict loop on the card: TorchMicroOracle
    times gpt2-1.5b's one-card plans at full width (each plan: a warm-up step,
    then the median of 3 wall-clock steps), the performance model is fitted to
    the fit set with both engines, and the held-out plans are predicted (the
    paper's Table 2 metric).  Fails only on a time that is not finite and
    positive, a step loss that is not finite, a fit that is not finite, or a
    wrong launch count; the errors themselves are findings.  Returns what it
    measured for the schedule phase: the flash launches, the samples by role,
    the fits and the oracle."""
    from repro_torch import configs
    from repro_torch.core import memory
    from repro_torch.core.oracle import TorchMicroOracle
    from repro_torch.core.paper_models import TABLE2
    from repro_torch.core.perfmodel import Alloc, env_for_gpu
    from repro_torch.parallel.plan import ExecutionPlan

    path = f"{PROFILE_ARCH} profile"
    cfg = configs.get(PROFILE_ARCH)
    profile = TABLE2[PROFILE_ARCH]
    env = env_for_gpu("h100")
    alloc = Alloc(1, 12)
    free_device_memory()
    counters = kernel_counters()
    reset_counts(counters)
    t0 = time.perf_counter()
    oracle = TorchMicroOracle(cfg, *PROFILE_MICRO, device="cuda", seed=SEED, env=env)
    micro_loss = oracle.last["loss"]
    if not np.isfinite(micro_loss).all():
        raise AssertionError(f"{path}: the micro step's losses are {micro_loss}")
    plain = ExecutionPlan()
    want = flash_launches(cfg, plain, 1 + oracle.steps)
    n_steps = 1 + oracle.steps
    counted = ExecutionPlan(**PROFILE_FIT[0])     # ZeRO-1 on one card: the plain-DP step

    def count_profile_step(plan, run, batch, times):
        if plan != counted:
            return
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.core.oracle import build_train_step

        shape = ShapeConfig("profile", profile.s, profile.b, "train")

        def rebuild():
            fake = build_train_step(cfg, plan, shape, "cuda", seed=SEED)
            fb = zeros_like_batch(batch)
            return ((lambda: fake.step(fake.params, fake.opt_state, fb)),
                    (fake.params, fake.opt_state, fb))
        count_real(path, lambda: run.step(run.params, run.opt_state, batch), rebuild,
                   float(np.median(times)) * 1e3, shape, cfg)
    oracle.after_steps = count_profile_step
    rows, samples = [], {"fit": [], "held_out": []}
    for role, plans in (("fit", PROFILE_FIT), ("held_out", PROFILE_HELD_OUT)):
        for kw in plans:
            plan = ExecutionPlan(**kw)
            est = memory.estimate(profile, plan, alloc, env)
            feasible = memory.feasible(profile, plan, alloc, env)
            t = oracle.measure(profile, plan, alloc, env=env)
            row = {"role": role, "plan": kw, "strategy": plan.strategy,
                   "memory_model": {"feasible": feasible, "gpu_bytes": est.gpu_bytes,
                                    "host_bytes": est.host_bytes, "gpu_mem": env.gpu_mem}}
            if feasible:
                loss = oracle.last["loss"]
                if not (np.isfinite(t) and t > 0 and np.isfinite(loss).all()):
                    raise AssertionError(f"{path}: {plan.strategy} measured {t} s, "
                                         f"losses {loss}")
                row.update(t_iter_ms=t * 1e3, step_ms_all=[x * 1e3 for x in oracle.last["step_s"]],
                           loss=loss,
                           peak_device_bytes=oracle.last["peak_device_bytes"],
                           pinned_host_bytes=oracle.last["pinned_host_bytes"])
                samples[role].append((plan, alloc, t))
                # the counted plan runs one more step, counted by op_cost
                extra = int(plan == counted)
                for name, n in flash_launches(cfg, plan, 1 + oracle.steps + extra).items():
                    want[name] += n
                n_steps += 1 + oracle.steps + extra
            elif role == "fit":
                raise AssertionError(f"{path}: the memory model calls fit plan "
                                     f"{plan.strategy} infeasible")
            rows.append(row)
            emit("profile_plan", path=path, **row)
    oracle.after_steps = None
    launches, plain_calls = read_counts(counters)
    check_launches(path, cfg, n_steps, launches, plain_calls, want)
    measure_s = time.perf_counter() - t0

    # TABLE2's t_fwd_unit is derived from the A800's bf16 peak
    # (paper_models.py); the unit measured here is printed beside it.
    fits, _ = fit_engines(path, profile, samples, env)
    emit("profile", path=path, arch=cfg.name, profile={"s": profile.s, "b": profile.b,
         "h": profile.h, "l": profile.l, "P": profile.P}, alloc=[alloc.gpus, alloc.cpus],
         optimizer="adamw lr 3e-4 (OptConfig()), f32 moments",
         env={"gpu_mem": env.gpu_mem, "gpu_flops": env.gpu_flops, "B_pcie": env.B_pcie},
         n_fit=len(samples["fit"]), n_held_out=len(samples["held_out"]), fits=fits,
         paper_table2_err_limits={"avg": 0.074, "max": 0.104},
         t_fwd_unit_measured=oracle.t_fwd_unit(), t_fwd_unit_table2_a800=profile.t_fwd_unit,
         micro={"batch": PROFILE_MICRO[0], "seq": PROFILE_MICRO[1], "t_step_ms":
                oracle.t_step * 1e3, "loss": micro_loss}, measure_s=measure_s, launches=launches,
         plain_calls=plain_calls)
    free_device_memory()
    return {"launches": launches, "samples": samples, "fits": fits, "oracle": oracle}


def spearman(a, b) -> float:
    """Spearman's rank correlation; values equal to 1e-12 (seconds) share
    their mean rank (the model prices GA at 0, so GA plans tie)."""
    def ranks(x):
        x = np.round(np.asarray(x, float), 12)
        r = np.empty(len(x))
        r[np.argsort(x, kind="stable")] = np.arange(len(x))
        for v in np.unique(x):
            r[x == v] = r[x == v].mean()
        return r

    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


# The user's static, memory-safe choice for job A, and the steps timed under
# each plan of the executed reconfiguration.
SCHEDULE_STATIC = {"zero_stage": 1, "offload": True, "gc": True}
SCHEDULE_STEPS = 3
CHECKPOINT_DIR = Path(__file__).resolve().parent / "build" / "schedule_ckpt"


def phase_schedule(prof: dict) -> dict:
    """Rubick's scheduling loop on the card, fed by the profile phase (which
    it does not re-measure): the performance model fitted under the measured
    t_fwd_unit, its sensitivity curve's one-card ranking against the measured
    one, a static and a Rubick scheduler pass for job A on a one-GPU node (both
    pass engines), the Rubick decision executed by checkpoint and restart
    (train under the static plan, save, restore bit for bit under Rubick's,
    train on), then the eleven measurements observed by a CalibrationManager
    and polled; a refit is propagated into a Rubick pass over the running job
    and into an admission pass.  Fails on a time, loss or fit that is not
    finite, a restore that is not bit-equal, the two pass engines disagreeing,
    a plan that needs more than one device, or a wrong launch count; every
    prediction error and ranking is a finding.  Returns the launches, the
    card's profile (TABLE2's under the measured t_fwd_unit), its batched fit
    and the plan change's measured seconds (save + restore + first step),
    for the simulate phase."""
    import dataclasses
    import shutil

    from repro_torch import configs
    from repro_torch.calibration import CalibrationManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import memory
    from repro_torch.core.cluster import Cluster, Job, JobState, SchedEvents
    from repro_torch.core.oracle import build_train_step, reconfigure, run_steps
    from repro_torch.core.paper_models import TABLE2
    from repro_torch.core.perfmodel import Alloc, env_for_gpu, predict_titer, prediction_error
    from repro_torch.core.scheduler import RubickScheduler, SchedulerConfig
    from repro_torch.core.sensitivity import get_curve
    from repro_torch.parallel.plan import ExecutionPlan

    path = f"{PROFILE_ARCH} schedule"
    cfg = configs.get(PROFILE_ARCH)
    env = env_for_gpu("h100")
    alloc = Alloc(1, 12)
    oracle = prof["oracle"]
    card = dataclasses.replace(TABLE2[PROFILE_ARCH], t_fwd_unit=oracle.t_fwd_unit())
    free_device_memory()
    counters = kernel_counters()
    reset_counts(counters)
    want = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}

    def count(plan, steps):
        for name, n in flash_launches(cfg, plan, steps).items():
            want[name] += n

    # 1. The card's profile fitted with both engines; the batched fit is used.
    t0 = time.perf_counter()
    fits, params = fit_engines(path, card, prof["samples"], env)
    k = params["batched"]

    # 2. Its curve: the best one-card plan, and the measured plans ranked.
    measured = prof["samples"]["fit"] + prof["samples"]["held_out"]
    curve = get_curve(card, k, env, max_gpus=8)
    best = curve.best_plan(1, 12)
    if best.plan is None:
        raise AssertionError(f"{path}: the curve has no feasible one-card plan")
    pred = [predict_titer(card, plan, a, env, k) for plan, a, _ in measured]
    meas = [t for _, _, t in measured]
    fastest = measured[int(np.argmin(meas))][0]
    ranking = {"plans": [plan_label(plan) for plan, _, _ in measured],
               "measured_ms": [t * 1e3 for t in meas], "predicted_ms": [t * 1e3 for t in pred],
               "measured_order": [plan_label(measured[i][0]) for i in np.argsort(meas)],
               "predicted_order": [plan_label(measured[i][0]) for i in np.argsort(pred)],
               "spearman_rho": spearman(pred, meas),
               "best_is_fastest_measured": best.plan == fastest}
    best_row = {"plan": dataclasses.asdict(best.plan), "label": plan_label(best.plan),
                "predicted_ms": card.b / best.throughput * 1e3}
    if all(best.plan != plan for plan, _, _ in measured):
        t = oracle.measure(card, best.plan, alloc, env=env)
        loss = oracle.last["loss"]
        if not (np.isfinite(t) and t > 0 and np.isfinite(loss).all()):
            raise AssertionError(f"{path}: {best.plan.strategy} measured {t} s, losses {loss}")
        count(best.plan, 1 + oracle.steps)
        best_row.update(measured_ms=t * 1e3, loss=loss,
                        peak_device_bytes=oracle.last["peak_device_bytes"])
    at_most = {g: curve.best_plan_at_most(g) for g in (1, 2, 4, 8)}
    extrapolated = {g: {"plan": plan_label(pt.plan) if pt.plan else None, "gpus": pt.gpus,
                        "samples_per_s": pt.throughput} for g, pt in at_most.items()}

    # 3. Two scheduler passes for job A on a one-GPU node of the card.
    static = ExecutionPlan(**SCHEDULE_STATIC)
    job = Job(name="A", profile=card, submit=0.0, target_iters=1000.0, req_gpus=1, req_cpus=12,
              orig_plan=static, guaranteed=True)

    def one_pass(sched_cfg, fitted=k):
        cluster = Cluster(n_nodes=1, gpus_per_node=1, cpus_per_node=12)
        js = JobState(job=job, fitted=fitted)
        sched = RubickScheduler(env, sched_cfg)
        sched.schedule([js], cluster, 0.0)
        if js.status != "running" or js.plan is None:
            raise AssertionError(f"{path}: the pass left job A {js.status}")
        if js.plan.n_gpus > 1 or js.total_gpus > 1:
            raise AssertionError(f"{path}: the pass picked {js.plan} on {js.total_gpus} GPUs; "
                                 f"multi-card plans are ROADMAP A14b")
        return js, sched, cluster

    def placed(js):
        return {"plan": plan_label(js.plan), "alloc": [js.alloc.gpus, js.alloc.cpus],
                "placement": {str(n): list(v) for n, v in js.placement.items()},
                "min_res": list(js.min_res), "baseline_perf": js.baseline_perf}

    js_static, _, _ = one_pass(SchedulerConfig(reconfigure_plans=False,
                                               reallocate_resources=False))
    passes = {"static": placed(js_static)}
    rubick = {}
    for engine in ("incremental", "full"):
        rubick[engine] = one_pass(SchedulerConfig(pass_engine=engine))
        passes[engine] = placed(rubick[engine][0])
    if passes["incremental"] != passes["full"]:
        raise AssertionError(f"{path}: the pass engines disagree: {passes}")
    js, sched, cluster = rubick["incremental"]
    if js_static.plan != static:
        raise AssertionError(f"{path}: the static pass placed A under {js_static.plan}")
    new_plan = js.plan

    # 4. The decision executed: checkpoint under the static plan, restart under Rubick's.
    shape = ShapeConfig("schedule", card.s, card.b, "train")
    CHECKPOINT_DIR.mkdir(parents=True, exist_ok=True)
    disk = shutil.disk_usage(CHECKPOINT_DIR)
    executed = {"disk_free_bytes": disk.free}
    emit("schedule_disk", path=path, dir=str(CHECKPOINT_DIR), free_bytes=disk.free,
         total_bytes=disk.total)

    def train(run, label):
        torch.cuda.reset_peak_memory_stats()
        times, losses = run_steps(run, batch, SCHEDULE_STEPS, warmup=0)
        if not (np.isfinite(times).all() and np.isfinite(losses).all()):
            raise AssertionError(f"{path}: {label} steps took {times} s, losses {losses}")
        return {"plan": plan_label(run.plan), "t_iter_ms": float(np.median(times)) * 1e3,
                "step_ms_all": [t * 1e3 for t in times], "loss": losses,
                "predicted_ms": predict_titer(card, run.plan, alloc, env, k) * 1e3,
                "peak_device_bytes": torch.cuda.max_memory_allocated()}

    try:
        run = build_train_step(cfg, static, shape, "cuda", seed=SEED)
        batch = run.model.dummy_batch(shape)
        _, first_loss = run_steps(run, batch, 1, warmup=0)           # warm-up step
        executed["static"] = train(run, "static")
        executed["static"]["warmup_loss"] = first_loss
        run, info = reconfigure(run, new_plan, shape, CHECKPOINT_DIR, step=1 + SCHEDULE_STEPS,
                                seed=SEED)
        if info["differ"]:
            raise AssertionError(f"{path}: the restore under {new_plan.strategy} differs from "
                                 f"the saved state in {info['differ'][:8]}")
        first_s, first_loss = run_steps(run, batch, 1, warmup=0)    # first step after restart
        executed["rubick"] = train(run, "rubick")
        executed["rubick"]["warmup_loss"] = first_loss
        count(static, 1 + SCHEDULE_STEPS)
        count(new_plan, 1 + SCHEDULE_STEPS)
        run.release()
        del run, batch
    finally:
        shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    executed.update(
        same_plan=new_plan == static, checkpoint_bytes=info["checkpoint_bytes"],
        save_s=info["save_s"], restore_s=info["restore_s"], first_step_s=first_s[0],
        reconfig_s=info["save_s"] + info["restore_s"] + first_s[0],
        restore_cost_model_s=memory.restore_cost(card),
        restore_cost_of_checkpoint_s=memory.restore_cost(nbytes=info["checkpoint_bytes"]),
        reconfig_cost_s_paper_a800=SchedulerConfig().reconfig_cost_s, restore_bit_equal=True)
    free_device_memory()

    # 5. Observe the eleven measurements and poll: a refit is propagated.
    mgr = CalibrationManager(env=env)
    mgr.ensure(card, k)
    stream = measured + [(static, alloc, executed["static"]["t_iter_ms"] / 1e3),
                         (new_plan, alloc, executed["rubick"]["t_iter_ms"] / 1e3)]
    for i, (plan, a, t) in enumerate(stream, start=1):
        mgr.observe(card, k, plan, a, env, t, now=60.0 * i)
    now = 60.0 * (len(stream) + 1)
    calibration = {"n_observations": len(stream), "window_rmsle_before": mgr.window_error(card),
                   "threshold": mgr.detector.cfg.threshold,
                   "min_observations": mgr.detector.cfg.min_observations}
    refits = mgr.poll(now)
    calibration["refit"] = bool(refits)
    if refits:
        r = refits[0]
        if not np.isfinite(r.new.as_vector()).all():
            raise AssertionError(f"{path}: the refit is not finite: {r.new}")
        avg, worst = prediction_error(card, r.new, prof["samples"]["held_out"], env)
        js.run_time = sum(executed["rubick"]["step_ms_all"]) / 1e3 + executed["reconfig_s"] \
            + sum(executed["static"]["step_ms_all"]) / 1e3
        old_plan = js.plan
        js.fitted, js.min_res, js.baseline_perf = r.new, None, 0.0
        gate = sched._reconfig_gate(js)
        sched.schedule([js], cluster, now, events=SchedEvents(refit=[(js, r.old)]))
        fresh, _, _ = one_pass(SchedulerConfig(), r.new)
        calibration.update(
            version=r.version, params=fit_params(r.new), rmsle_before=r.rmsle_before,
            rmsle_after=r.rmsle_after,
            held_out_err_avg=avg, held_out_err_max=worst,
            running_pass={"run_time_s": js.run_time, "gate_open": gate,
                          "plan_before": plan_label(old_plan), "plan_after": plan_label(js.plan),
                          "n_reconfig": js.n_reconfig, "min_res": list(js.min_res)},
            admission_plan=plan_label(fresh.plan))
    phase_s = time.perf_counter() - t0
    launches, plain_calls = read_counts(counters)
    check_launches(path, cfg, 0, launches, plain_calls, want)
    emit("schedule", path=path, arch=cfg.name, env="h100", alloc=[alloc.gpus, alloc.cpus],
         t_fwd_unit_measured=card.t_fwd_unit, t_fwd_unit_table2_a800=TABLE2[PROFILE_ARCH]
         .t_fwd_unit, fits_measured_unit=fits, fits_table2_unit=prof["fits"],
         best_plan_1gpu=best_row, ranking=ranking,
         best_plan_at_most_extrapolated_beyond_one_card=extrapolated, passes=passes,
         engines_agree=True, executed=executed, calibration=calibration, seconds=phase_s,
         launches=launches, plain_calls=plain_calls)
    return {"launches": launches, "profile": card, "fit": k, "reconfig_s": executed["reconfig_s"]}


# The simulate phase: SIM_JOBS gpt2-1.5b jobs like schedule's job A (TABLE2's
# b 16 x s 1024, orig plan ZeRO-Offload + GC, 1 GPU and 12 CPUs, guaranteed),
# submitted SIM_GAP_S apart onto its one-GPU node, SIM_ITERS iterations each,
# under each of SIM_SCHEDULERS and both simulator engines.
SIM_JOBS = 4
SIM_GAP_S = 300.0
SIM_ITERS = 3000.0
SIM_SCHEDULERS = ("rubick", "rubick-n", "synergy", "sia", "antman")
SIM_ENGINE_TOL = 0.01    # event vs discrete avg JCT and makespan (src/repro/core/simulator.py:20-22)
SIM_DIR = Path(__file__).resolve().parent / "build" / "simulate"


class MeasureMemo:
    """One table of T_iter for every run of a phase: ``measure`` (the
    oracle's signature) asks the oracle for a (plan, alloc) on its first call
    only, so every scheduler and both engines see the same times.  ``fresh``
    lists each measurement: plan, alloc, T_iter, the seconds it took and the
    oracle's ``last``.  A plan or allocation of more than one card raises
    before the oracle is asked; so does a feasible plan whose time or losses
    are not finite."""

    def __init__(self, oracle):
        self.oracle = oracle
        self.table: dict = {}
        self.fresh: list[dict] = []

    def measure(self, profile, plan, alloc, seed: int = 0, env=None, now: float = 0.0) -> float:
        key = (plan, alloc)
        if key not in self.table:
            if plan.n_gpus > 1 or alloc.gpus > 1:
                raise AssertionError(f"the simulation asked for {plan.strategy} on {alloc.gpus} "
                                     f"GPUs; this node has one card")
            t0 = time.perf_counter()
            t = self.oracle.measure(profile, plan, alloc, env=env)
            row = {"plan": plan, "alloc": alloc, "t_iter_s": t,
                   "seconds": time.perf_counter() - t0}
            if np.isfinite(t):
                last = dict(getattr(self.oracle, "last", {}))
                if not (t > 0 and np.isfinite(last.get("loss", [0.0])).all()):
                    raise AssertionError(f"{plan.strategy} measured {t} s, losses "
                                         f"{last.get('loss')}")
                row["last"] = last
            self.table[key] = t
            self.fresh.append(row)
        return self.table[key]


def simulate_jobs(oracle, profile, fitted, env, reconfig_cost: float,
                  trace_dir: Path | None = None) -> dict:
    """The simulate phase's runs on any oracle with ``measure``: SIM_JOBS jobs
    of ``profile`` on a one-GPU node, under each of SIM_SCHEDULERS
    (repro_torch.core.baselines.ALL) and both engines, with ``fitted`` in the
    fit cache and ``reconfig_cost`` seconds a plan change.  Rubick's event
    run is sanitized (SchedulerConfig(sanitize=True)) and carries a
    FlightRecorder, whose JSONL goes to ``trace_dir`` (when given) and must
    pass ``python -m repro_torch.obs.report validate``.  Returns {"runs":
    {scheduler: {engine: result}}, "trace": its path, "recorder": its summary}.
    Raises on a job left unfinished, a time that is not finite, engines more
    than SIM_ENGINE_TOL apart, a sanitizer violation or a trace that does not
    validate."""
    from repro_torch.core import baselines
    from repro_torch.core.cluster import Cluster, Job
    from repro_torch.core.perfmodel import fit_key
    from repro_torch.core.scheduler import RubickScheduler, SchedulerConfig
    from repro_torch.core.simulator import Simulator
    from repro_torch.obs import FlightRecorder, report, write_jsonl
    from repro_torch.parallel.plan import ExecutionPlan

    static = ExecutionPlan(**SCHEDULE_STATIC)
    jobs = [Job(name=f"J{i}", profile=profile, submit=SIM_GAP_S * i, target_iters=SIM_ITERS,
                req_gpus=1, req_cpus=12, orig_plan=static, guaranteed=True)
            for i in range(SIM_JOBS)]
    runs, out = {}, {}
    for name in SIM_SCHEDULERS:
        runs[name] = {}
        for mode in ("event", "discrete"):
            rec = None
            if name == "rubick" and mode == "event":
                sched = RubickScheduler(env, SchedulerConfig(sanitize=True))
                sched.name = name
                rec = FlightRecorder(meta={"arch": profile.name})
            else:
                sched = baselines.ALL[name](env=env)
            sim = Simulator(Cluster(n_nodes=1, gpus_per_node=1, cpus_per_node=12), sched,
                            oracle=oracle, env=env, reconfig_cost=reconfig_cost,
                            fit_cache={fit_key(profile): fitted}, mode=mode, recorder=rec)
            t0 = time.perf_counter()
            res = sim.run(jobs)
            wall_s = time.perf_counter() - t0
            label = f"{name} {mode}"
            if sorted(res.jcts) != [j.name for j in jobs]:
                raise AssertionError(f"{label}: jobs left unfinished: finished {sorted(res.jcts)}")
            times = list(res.jcts.values()) + [res.makespan]
            if not np.isfinite(times).all():
                raise AssertionError(f"{label}: times not finite: {res.jcts}, {res.makespan}")
            runs[name][mode] = {
                "avg_jct_s": res.avg_jct, "p99_jct_s": res.p99_jct, "makespan_s": res.makespan,
                "n_reconfig": res.n_reconfig, "guarantee_violations": res.guarantee_violations,
                "n_events": res.n_events, "n_sched_calls": res.n_sched_calls,
                "total_paused_s": res.total_paused_s, "sim_wall_s": wall_s,
                "jobs": {s.job.name: {"jct_s": res.jcts[s.job.name], "plan": plan_label(s.plan),
                                      "alloc": [s.alloc.gpus, s.alloc.cpus],
                                      "t_iter_ms": oracle.measure(profile, s.plan, s.alloc,
                                                                  env=env) * 1e3,
                                      "n_reconfig": s.n_reconfig}
                         for s in sim.last_states}}
            if rec is not None:
                out["recorder"] = rec.summary()
                if trace_dir is not None:
                    trace_dir.mkdir(parents=True, exist_ok=True)
                    path = write_jsonl(rec, trace_dir / f"{name}_{mode}.jsonl")
                    if report.main(["validate", str(path)]) != 0:
                        raise AssertionError(f"{label}: the flight-recorder trace {path} does "
                                             f"not validate")
                    out["trace"] = str(path)
        ev, di = runs[name]["event"], runs[name]["discrete"]
        apart = {key: abs(ev[key] - di[key]) / max(abs(di[key]), 1e-9)
                 for key in ("avg_jct_s", "makespan_s")}
        runs[name]["engines_rel_diff"] = apart
        runs[name]["jct_rel_diff_max"] = max(
            abs(ev["jobs"][j]["jct_s"] - di["jobs"][j]["jct_s"]) / di["jobs"][j]["jct_s"]
            for j in ev["jobs"])
        if max(apart.values()) > SIM_ENGINE_TOL:
            raise AssertionError(f"{name}: the event and discrete engines are {apart} apart "
                                 f"(limit {SIM_ENGINE_TOL})")
    out["runs"] = runs
    return out


def phase_simulate(sched: dict) -> dict[str, int]:
    """Rubick's cluster simulator over T_iter measured on the card: a fresh
    TorchMicroOracle for gpt2-1.5b behind a MeasureMemo (one table of card
    times for every run), schedule's profile and fit in the fit cache and its
    measured plan change as the reconfiguration cost; simulate_jobs' runs
    (five schedulers, both engines, the sanitized and recorded Rubick event
    run).  Prints each scheduler's avg and p99 JCT, makespan, reconfigurations,
    guarantee violations and each job's plan with its measured T_iter, and
    how many plans were measured fresh and the card seconds they took.
    Fails as simulate_jobs does, and on a wrong flash launch count or a plain
    call; which scheduler wins is a finding."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.oracle import TorchMicroOracle
    from repro_torch.core.perfmodel import env_for_gpu
    from repro_torch.parallel.plan import ExecutionPlan

    path = f"{PROFILE_ARCH} simulate"
    cfg = configs.get(PROFILE_ARCH)
    env = env_for_gpu("h100")
    free_device_memory()
    counters = kernel_counters()
    reset_counts(counters)
    t0 = time.perf_counter()
    oracle = TorchMicroOracle(cfg, *PROFILE_MICRO, device="cuda", seed=SEED, env=env)
    memo = MeasureMemo(oracle)
    want = flash_launches(cfg, ExecutionPlan(), 1 + oracle.steps)
    sim = simulate_jobs(memo, sched["profile"], sched["fit"], env, sched["reconfig_s"], SIM_DIR)
    for row in memo.fresh:
        if np.isfinite(row["t_iter_s"]):
            for name, n in flash_launches(cfg, row["plan"], 1 + oracle.steps).items():
                want[name] += n
    launches, plain_calls = read_counts(counters)
    check_launches(path, cfg, 0, launches, plain_calls, want)
    default = dataclasses.asdict(ExecutionPlan())
    fresh = [{"plan": plan_label(r["plan"]),
              "plan_kw": {f: v for f, v in dataclasses.asdict(r["plan"]).items()
                          if v != default[f]},
              "alloc": [r["alloc"].gpus, r["alloc"].cpus], "t_iter_ms": r["t_iter_s"] * 1e3,
              "seconds": r["seconds"],
              "step_ms_all": [x * 1e3 for x in r.get("last", {}).get("step_s", [])],
              "peak_device_bytes": r.get("last", {}).get("peak_device_bytes")}
             for r in memo.fresh]
    for name, by_mode in sim["runs"].items():
        emit("simulate_run", path=path, scheduler=name, **by_mode)
    emit("simulate", path=path, arch=cfg.name, env="h100", n_jobs=SIM_JOBS, gap_s=SIM_GAP_S,
         target_iters=SIM_ITERS, node={"gpus": 1, "cpus": 12},
         reconfig_cost_s=sched["reconfig_s"], fit=fit_params(sched["fit"]),
         t_fwd_unit=sched["profile"].t_fwd_unit, micro_t_step_ms=oracle.t_step * 1e3,
         measured_fresh=len(fresh), measured_s=sum(r["seconds"] for r in fresh), plans=fresh,
         summary={name: {mode: {k: by_mode[mode][k] for k in ("avg_jct_s", "makespan_s",
                                                              "n_reconfig")}
                         for mode in ("event", "discrete")}
                  for name, by_mode in sim["runs"].items()},
         trace=sim.get("trace"), recorder=sim.get("recorder"),
         seconds=time.perf_counter() - t0, launches=launches, plain_calls=plain_calls)
    free_device_memory()
    return launches


def phase_dryrun() -> None:
    """Each counted path's step again on fake CUDA tensors (FakeTensorMode,
    nothing run on the card): FLOPs, bytes, collective bytes and calls per
    kernel op must equal the real count; then its roofline terms at the
    card's spec figures beside the step's measured ms, and MemTracker's peak
    of the fake step beside the card's peak of the real one (not gated).
    Last, one production cell of the dry run, gpt2-1.5b train_4k on the
    fake 16 x 16 mesh (256 fake ranks; run after the card's process group is
    gone)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import roofline
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    t_phase = time.perf_counter()
    for path, rec in COUNTED.items():
        t0 = time.perf_counter()
        with FakeTensorMode():
            run, held = rec["rebuild"]()
            fake, peak = dryrun.count_step(run, held)
        real = rec["real"]
        if fake.summary() != real.summary():
            diff = {k: (v, fake.summary()[k]) for k, v in real.summary().items()
                    if fake.summary()[k] != v}
            raise AssertionError(f"{path}: real and fake counts differ (real, fake): {diff}")
        rep = roofline.analyze(real, arch=rec["arch"], shape=rec["shape"], mesh={"card": 1},
                               model_flops=rec["model_flops"], peak_bytes=peak)
        t_bound_ms = rep.t_bound * 1e3
        emit("dryrun_path", path=path, flops=real.flops, bytes=real.bytes,
             dot_flops=real.dot_flops, coll_bytes=real.coll_bytes,
             kernel_calls=dict(real.kernel_calls), kernel_flops=dict(real.kernel_flops),
             n_ops=real.n_ops, t_compute_ms=rep.t_compute * 1e3,
             t_memory_ms=rep.t_memory * 1e3, t_bound_ms=t_bound_ms,
             bottleneck=rep.bottleneck, measured_ms=rec["measured_ms"],
             bound_over_measured=t_bound_ms / rec["measured_ms"],
             model_flops=rec["model_flops"], useful_ratio=rep.useful_ratio,
             roofline_fraction=rep.roofline_fraction, memtracker_peak_bytes=peak,
             max_memory_allocated=rec["max_memory_allocated"],
             real_count_s=rec["count_s"], fake_count_s=time.perf_counter() - t0)
    mesh = make_production_mesh()
    try:
        row = dryrun.run_cell("gpt2-1.5b", "train_4k", mesh, verbose=False)
    finally:
        dist.destroy_process_group()
    if row.get("status") != "ok":
        raise AssertionError(f"the dry run's gpt2-1.5b train_4k cell: {row}")
    emit("dryrun_cell", **row)
    emit("dryrun", paths=list(COUNTED), seconds=time.perf_counter() - t_phase)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--bwd-compare"]:
        if sys.argv[2:3] == [] or sys.argv[2] not in BWD_COMPARE:
            print(f"chip_smoke: --bwd-compare takes one of {list(BWD_COMPARE)}", file=sys.stderr)
            return 2
        return compare_bwd(sys.argv[2], [Path(a) for a in sys.argv[3:]])
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    mains = {"ssd_scan_fwd": phase_ssd_kernels()}
    mains.update(phase_kernels())
    mains["wkv6_fwd"], mains["wkv6_decode"] = phase_wkv_kernels()
    phase_reference()
    by_path = {arch: phase_serve(arch) for arch in SERVED}
    from repro_torch import configs

    op_host_cost(SERVED_MS["rwkv6-1.6b"]["decode_ms"], configs.get("rwkv6-1.6b").n_layers)
    # The training phases run after serving, so that the serve phases meet the
    # allocator in the state they always have (their peaks compare to the byte).
    mains.update(phase_bwd_kernels())
    mains["ssd_scan_bwd"] = phase_ssd_bwd_kernels()
    mains["wkv6_bwd"] = phase_wkv_bwd_kernels()
    phase_train_reference()
    peaks = {}
    for arch in ("llama2-7b", "zamba2-7b"):
        by_path[f"{arch} train"], peaks[arch] = phase_train_fixed(arch)
    for arch in ("gpt2-1.5b", "rwkv6-1.6b"):
        by_path[f"{arch} train"] = phase_train_launcher(arch)
    by_path["llama2-7b train offload"] = phase_train_offload(peaks["llama2-7b"])
    for arch in TRAIN_CUT:
        by_path[f"{arch} train"], _ = phase_train_fixed(arch)
    by_path["phi-3-vision-4.2b train"], _ = phase_train_fixed("phi-3-vision-4.2b")
    by_path["seamless-m4t-large-v2 train"] = phase_train_launcher("seamless-m4t-large-v2")
    prof = phase_profile()
    by_path[f"{PROFILE_ARCH} profile"] = prof["launches"]
    sched = phase_schedule(prof)
    by_path[f"{PROFILE_ARCH} schedule"] = sched["launches"]
    by_path[f"{PROFILE_ARCH} simulate"] = phase_simulate(sched)
    dist.destroy_process_group()
    phase_dryrun()
    # wkv6_fwd's launch count holds every call of its wrapper; the S = 1 ones
    # ran the decode kernel, reported as a kernel of its own.
    for counts in by_path.values():
        counts["wkv6_fwd"] -= counts["wkv6_decode"]
    sources = {
        "flash_attention_fwd": ("flash_attention_fwd.cu",
                                "src/repro/kernels/flash_attention.py:110", "max_abs_err_o"),
        "flash_attention_bwd": ("flash_attention_bwd.cu",
                                "src/repro/models/flash.py:146 (an HLO backward, not Pallas)",
                                "max_abs_err"),
        "ssd_scan_fwd": ("ssd_scan_fwd.cu", "src/repro/kernels/ssd_scan.py:77",
                         "max_abs_err_y"),
        "ssd_scan_bwd": ("ssd_scan_bwd.cu", "src/repro/models/mamba2.py:57 (autodiff of "
                         "ssd_chunked; no Pallas kernel)", "max_abs_err"),
        "wkv6_fwd": ("wkv6_fwd.cu", "src/repro/kernels/wkv6.py:76", "max_abs_err_y"),
        "wkv6_bwd": ("wkv6_bwd.cu", "src/repro/models/rwkv6.py:85 (autodiff of "
                     "wkv_chunked; no Pallas kernel)", "max_abs_err"),
        "wkv6_decode": ("wkv6_fwd.cu", "src/repro/kernels/wkv6.py:76", "max_abs_err_y"),
    }
    # The d 192 / dv 128, d 96 and non-causal launches of the forward and the
    # backward, on lines of their own: their launches are the
    # deepseek-v3-671b serve's and train's (every one of which is MLA), the
    # phi-3-vision-4.2b serve's and train's (every one at d 96) and the
    # non-causal ones (seamless-m4t-large-v2's encoder and cross-attention,
    # served and trained); flash_attention_fwd's and _bwd's counts hold them
    # too.
    paths = {"_mla": ("deepseek-v3-671b", "deepseek-v3-671b train"),
             "_d96": ("phi-3-vision-4.2b", "phi-3-vision-4.2b train")}
    variants = {"_mla": " (d 192, dv 128)", "_d96": " (d 96)",
                "_noncausal": " (non-causal)"}
    for suffix in variants:
        for kname in ("flash_attention_fwd", "flash_attention_bwd"):
            sources[kname + suffix] = sources[kname]
            for arch, counts in by_path.items():
                if suffix in paths:
                    counts[kname + suffix] = counts.get(kname, 0) if arch in paths[suffix] else 0
    mains["flash_attention_fwd_noncausal"] = dict(mains["flash_attention_fwd_encoder"],
                                                  other_case=mains["flash_attention_fwd_cross"])
    kernels = []
    for kname, (src, tpu, err_key) in sources.items():
        main_case = mains[kname]
        base, suffix = next(((kname.removesuffix(v), v) for v in variants if kname.endswith(v)),
                            (kname, ""))
        kernels.append({
            "name": base + variants.get(suffix, ""),
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu,
            "launches": sum(counts[kname] for counts in by_path.values()),
            "launches_by_path": {arch: counts[kname] for arch, counts in by_path.items()
                                 if counts[kname]},
            "case": main_case.get("case"),
            "max_abs_err": main_case[err_key],
            "ms": main_case["kernel_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            **({"other_case": {k: main_case["other_case"][k]
                               for k in ("case", err_key, "kernel_ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms")}}
               if "other_case" in main_case else {}),
        })
    print(json.dumps({"kernels": kernels, "seconds": time.perf_counter() - t_start}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
