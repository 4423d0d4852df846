#!/usr/bin/env python3
"""Time the port's layernorm against autograd of the same plain ops on the card.

    PYTHONPATH=src python3 tools/norm_bench.py [--reps 50]

At rwkv6-1.6b's training shape (x bf16 (4, 512, 2048), f32 gains, as
``models/rwkv_model.py`` calls it), in turns (plain, port, port, plain):
the forward + backward ms (CUDA events around ``reps`` eager calls: the
host's launches are timed too, as a train step pays them) and the bytes
each keeps for its backward (``memory_allocated`` after a forward whose
graph is kept, less before it and less the output's).  Prints one JSON
line a version and a round, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def plain_layernorm(x, gamma, beta, eps=1e-5):
    """The port's layernorm before it had its own backward: autograd of these
    ops keeps f32 copies of x."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("norm_bench: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.models import nn

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (4, 512, 2048)
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16().requires_grad_()
    g = (1 + 0.1 * torch.randn(shape[-1:], generator=gen, device="cuda")).requires_grad_()
    b = (0.1 * torch.randn(shape[-1:], generator=gen, device="cuda")).requires_grad_()
    dy = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    versions = {"plain ops + autograd": plain_layernorm, "nn.layernorm": nn.layernorm}

    def step(fn):
        fn(x, g, b, 1e-5).backward(dy)
        x.grad = g.grad = b.grad = None

    for rnd, name in enumerate(("plain ops + autograd", "nn.layernorm", "nn.layernorm",
                                "plain ops + autograd")):
        fn = versions[name]
        for _ in range(5):
            step(fn)
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.reps):
            step(fn)
        t1.record()
        t1.synchronize()
        base = torch.cuda.memory_allocated()
        y = fn(x, g, b, 1e-5)
        kept = torch.cuda.memory_allocated() - base - y.numel() * y.element_size()
        del y
        print(json.dumps({"round": rnd, "version": name, "shape": list(shape),
                          "fwd_bwd_ms": t0.elapsed_time(t1) / args.reps,
                          "bytes_kept_for_backward": kept}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
