"""Training launcher for the port: checkpoint/restart fault tolerance and
plan reconfiguration at the job level, the torch twin of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b --full \
        --steps 10 --batch 4 --seq 512 --plan '{"gc": true}'
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20

Same flags as the reference plus ``--device`` (default ``cuda``).  The
reduced configs (the default without ``--full``) run on the CPU only: the
card refuses them up front.  A run resumes from the latest checkpoint in
``--ckpt-dir``; a restart may carry another ``--plan`` (the reconfiguration
Rubick drives), and a checkpoint written by ``repro.launch.train`` resumes
here as well as the other way round.  The data are the reference's
synthetic tokens from the same seed, so both frameworks see the same
batches.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def build_runtime(arch: str, reduced: bool, plan_kw: dict, remat: bool, device, seed: int):
    from repro_torch import configs
    from repro_torch.launch import launch_device
    from repro_torch.models import ModelOpts, build
    from repro_torch.parallel.plan import ExecutionPlan

    dev = launch_device(device, reduced)
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    plan = ExecutionPlan(**plan_kw)
    plan.validate()
    opts = ModelOpts(remat="full" if (plan.gc or remat) else "none", loss_chunk=0)
    return cfg, build(cfg, device=dev, seed=seed, opts=opts), plan


def train(arch: str = "gemma-2b", reduced: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 128, lr: float = 1e-3,
          plan_kw: dict | None = None, ckpt_dir: str | None = None,
          ckpt_every: int = 20, log_every: int = 10, seed: int = 0,
          remat: bool = False, device="cuda") -> dict:
    """Train ``steps`` steps (from the latest checkpoint when there is one).
    Returns {"losses", "final_loss", "params", "opt_state", "step_fn",
    "step_seconds"}: the last is each step's wall time, up to reading its
    loss (which waits for the device); ``step_fn`` takes a further step."""
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.step import make_train_step

    cfg, model, plan = build_runtime(arch, reduced, plan_kw or {}, remat, device, seed)
    optcfg = OptConfig(lr=lr)
    params = model.init()
    opt_state = opt_init(params, optcfg)
    step_fn = make_train_step(model, plan, optcfg)

    data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        params, opt_state, meta = mgr.restore(params, opt_state)
        start = meta["step"]
        print(f"[train] resumed from step {start}")

    losses, step_seconds = [], []
    t0 = time.time()
    for step in range(start, steps):
        tokens = torch.from_numpy(data.batch(step)).long().to(model.device)
        t_step = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, {"tokens": tokens})
        loss = float(metrics["loss"])
        step_seconds.append(time.perf_counter() - t_step)
        losses.append(loss)
        if step % log_every == 0:
            tokps = batch * seq * (step - start + 1) / (time.time() - t0)
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({tokps:,.0f} tok/s)", flush=True)
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, params, opt_state,
                     meta={"arch": arch, "plan": plan.strategy})
    if mgr is not None:
        mgr.save(steps, params, opt_state,
                 meta={"arch": arch, "plan": plan.strategy}, block=True)
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "params": params, "opt_state": opt_state, "step_fn": step_fn,
            "step_seconds": step_seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced smoke config, CPU only)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--plan", default="{}",
                    help='ExecutionPlan kwargs as JSON, e.g. {"ga_steps":2}')
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train(arch=args.arch, reduced=not args.full, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                plan_kw=json.loads(args.plan), ckpt_dir=args.ckpt_dir,
                seed=args.seed, device=args.device)
    print(f"[train] done; final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
