"""Serving launcher for the port: batched greedy decoding on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --full \
        --batch 4 --prompt-len 512 --gen 32

Every arch the port registers serves (``repro_torch.configs.base.ARCHS``:
the dense decoders, zamba2-7b and rwkv6-1.6b).

Same flags as ``repro.launch.serve`` plus ``--device`` (default ``cuda``;
``cpu`` runs the plain path) and ``--seed`` (weights and prompts).  The
reduced configs (the default without ``--full``) run on the CPU only: the
card refuses them up front.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.launch import launch_device
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeEngine

    device = launch_device(args.device, reduced=not args.full)
    cfg = configs.get(args.arch) if args.full else configs.get_reduced(args.arch)
    model = build(cfg, device=device, seed=args.seed)
    params = model.init()
    engine = ServeEngine(model, params, max_len=args.prompt_len + args.gen + 1)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    tokens = torch.from_numpy(prompts).to(model.device)

    def timed() -> float:
        t0 = time.perf_counter()
        engine.generate(tokens, steps=args.gen)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        return time.perf_counter() - t0

    cold = timed()
    warm = timed()
    name = torch.cuda.get_device_name(model.device) if model.device.type == "cuda" \
        else "cpu"
    print(f"[serve] {args.arch} on {name}: batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} cold={cold:.2f}s "
          f"warm={warm:.2f}s ({args.batch * args.gen / warm:,.0f} tok/s)")


if __name__ == "__main__":
    main()
