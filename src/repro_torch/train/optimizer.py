"""Optimizers: the torch twin of ``repro.train.optimizer``.

AdamW and Lion in the reference's functional form, one leaf at a time:
bias correction from an f32 step count, the global-norm clip with its
``+ 1e-9``, weight decay added to the step (not decoupled), f32 math cast
back to each parameter's dtype, and moments kept in ``moment_dtype``.
``torch.optim.AdamW`` is not used: its rounding and state dtypes differ, and
its multi-tensor path would make f32 copies of every parameter at once.

Params and grads are dicts of name -> tensor (an ``nn.Module`` is taken as
its ``named_parameters()``).  The state is ``{"count": int, "m": {name:
tensor}, "v": {name: tensor}}`` (Lion keeps no ``v``).  Unlike the
reference, which returns new arrays, ``opt_update`` writes each leaf's new
value into the parameter and moment tensors in place, so a 7B model holds
one copy of each plus one leaf's f32 temporaries; it returns the same
objects.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"                # adamw | lion
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # float32 | bfloat16


def _mdt(cfg: OptConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def _leaves(params) -> dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params


def opt_init(params, cfg: OptConfig) -> dict:
    """Zero moments shaped like each parameter, in ``moment_dtype``."""
    dt = _mdt(cfg)
    leaves = _leaves(params)

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in leaves.items()}

    state = {"count": 0, "m": zeros()}
    if cfg.name != "lion":
        state["v"] = zeros()
    return state


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(torch.stack([g.float().square().sum() for g in grads.values()]).sum())


@torch.no_grad()
def opt_update(grads: dict[str, torch.Tensor], state: dict, params, cfg: OptConfig):
    """One step, in place.  Returns (params, state, {"grad_norm"})."""
    leaves = _leaves(params)
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    # the reference forms b ** count in f32 from an int32 count
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))

    for name, p in leaves.items():
        g = grads[name].float() * scale
        m = state["m"][name]
        if cfg.name == "lion":
            m32 = m.float()
            u = torch.sign(b1 * m32 + (1 - b1) * g)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p.float()
            p.copy_(p.float() - cfg.lr * u)
            m.copy_(b2 * m32 + (1 - b2) * g)
            continue
        v = state["v"][name]
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - cfg.lr * step)
        m.copy_(m32)
        v.copy_(v32)
    state = {**state, "count": count}
    return params, state, {"grad_norm": gnorm}
