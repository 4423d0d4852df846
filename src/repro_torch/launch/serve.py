"""Serving launcher for the port: batched greedy decoding on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --full \
        --batch 4 --prompt-len 512 --gen 32

Every arch the port registers serves (``repro_torch.configs.base.ARCHS``:
the dense decoders, zamba2-7b, rwkv6-1.6b, the MoE models
moonshot-v1-16b-a3b and deepseek-v3-671b, the encoder-decoder
seamless-m4t-large-v2 and the vision decoder phi-3-vision-4.2b).
deepseek-v3-671b's 671.7e9 parameters do not fit one card; ``--layers 4``
keeps every width and its 3 dense layers and 1 MoE layer (15.8e9
parameters):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b --full \
        --layers 4 --batch 4 --prompt-len 512 --gen 32

The modality stubs are drawn from ``--seed`` like the prompt's tokens:
seamless-m4t-large-v2 encodes ``n_frames`` (1,024) frame embeddings, and
phi-3-vision-4.2b's prompt is ``n_patches`` (576) patch embeddings followed
by text, ``--prompt-len`` counting both (so it must exceed 576):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --full \
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --full \
        --batch 4 --prompt-len 1088 --gen 32

Same flags as ``repro.launch.serve`` plus ``--device`` (default ``cuda``;
``cpu`` runs the plain path), ``--seed`` (weights and prompts) and
``--layers`` (cut the depth, keeping every width).  The reduced configs
(the default without ``--full``) run on the CPU only: the card refuses them
up front.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int) -> dict[str, np.ndarray]:
    """A prompt from ``seed`` (numpy): token ids in [0, vocab), then the
    config's modality stub as f32 normals x 0.02 (the reference's
    ``dummy_batch`` scale): "frames" (B, n_frames, D), or "patches" (B,
    n_patches, D) with ``prompt_len`` counting patches and text, as the
    reference's ``input_specs`` counts them."""
    from repro_torch.models.api import stub_key

    key = stub_key(cfg)
    n_stub = {"frames": cfg.n_frames, "patches": cfg.n_patches}.get(key, 0)
    n_text = prompt_len - n_stub if key == "patches" else prompt_len
    if n_text <= 0:
        raise ValueError(f"{cfg.name}: --prompt-len {prompt_len} counts its {n_stub} "
                         f"patches and the text, so it must exceed {n_stub}")
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, n_text))}
    if key:
        out[key] = rng.standard_normal((batch, n_stub, cfg.d_model), dtype=np.float32) * 0.02
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the config's)")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.launch import launch_device
    from repro_torch.models import build
    from repro_torch.serve.engine import ServeEngine

    device = launch_device(args.device, reduced=not args.full)
    cfg = configs.get(args.arch) if args.full else configs.get_reduced(args.arch)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    prompt = prompt_batch(cfg, args.batch, args.prompt_len, args.seed)
    model = build(cfg, device=device, seed=args.seed)
    params = model.init()
    engine = ServeEngine(model, params, max_len=args.prompt_len + args.gen + 1)
    batch = {k: torch.from_numpy(a).to(model.device) for k, a in prompt.items()}

    def timed() -> float:
        t0 = time.perf_counter()
        engine.generate(batch, steps=args.gen)
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
