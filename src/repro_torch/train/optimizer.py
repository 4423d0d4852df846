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

Sharded plans (``repro_torch.train.step.compile_train_step``) hand each
rank's pieces to ``opt_update`` with ``owned`` and ``group``: the global
norm adds each rank's sums of squares over the group, counting a piece that
several ranks hold (a replica) on one of them only.

ZeRO-Offload (``opt_init(..., host=True)``): the moments live in host
memory, pinned when the parameters are on ``cuda`` (one pinned block per
moment, carved into leaves), plain CPU tensors when they are on the CPU.
On the card each leaf's moments are copied to the device on a side stream
while the previous leaf updates, updated there with the same arithmetic,
and copied back on another side stream (two staging slots, ordered by
events); the clip scale stays on the device and nothing waits on the host.
A failure to pin or to copy raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


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


def opt_init(params, cfg: OptConfig, *, host: bool = False) -> dict:
    """Zero moments shaped like each parameter, in ``moment_dtype``; in host
    memory under ``host`` (ZeRO-Offload)."""
    dt = _mdt(cfg)
    leaves = _leaves(params)

    def zeros():
        if host:
            return _host_zeros({n: p.shape for n, p in leaves.items()}, dt,
                               pin=any(p.device.type == "cuda" for p in leaves.values()))
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in leaves.items()}

    state = {"count": 0, "m": zeros()}
    if cfg.name != "lion":
        state["v"] = zeros()
    return state


def _host_zeros(shapes: dict, dtype: torch.dtype, pin: bool) -> dict[str, torch.Tensor]:
    """One zeroed host block carved into a tensor per leaf; pinned under
    ``pin`` (one block, not one per leaf: the pinned allocator rounds each
    allocation up to a power of two)."""
    sizes = {n: int(np.prod(s, dtype=np.int64)) for n, s in shapes.items()}
    block = torch.zeros(max(sum(sizes.values()), 1), dtype=dtype, pin_memory=pin)
    if pin and not block.is_pinned():
        raise RuntimeError(f"could not pin {block.numel() * block.element_size()} bytes of "
                           f"optimizer state")
    out, off = {}, 0
    for n, s in shapes.items():
        out[n] = block[off:off + sizes[n]].view(s)
        off += sizes[n]
    return out


def global_norm(grads: dict[str, torch.Tensor], owned: dict[str, bool] | None = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.  With
    ``owned`` only those leaves' pieces count on this rank, and with
    ``group`` the sums are added over its ranks."""
    sums = [g.float().square().sum() for n, g in grads.items() if owned is None or owned[n]]
    device = next(iter(grads.values())).device
    total = torch.stack(sums).sum() if sums else torch.zeros((), device=device)
    if group is not None:
        dist.all_reduce(total, group=group)
    return torch.sqrt(total)


def _adamw_leaf(p, g, m, v, cfg: OptConfig, scale, bc1: float, bc2: float) -> None:
    g = g.float() * scale
    m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
    v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
    step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
    if cfg.weight_decay:
        step = step + cfg.weight_decay * p.float()
    p.copy_(p.float() - cfg.lr * step)
    m.copy_(m32)
    v.copy_(v32)


def _lion_leaf(p, g, m, cfg: OptConfig, scale) -> None:
    g = g.float() * scale
    m32 = m.float()
    u = torch.sign(cfg.b1 * m32 + (1 - cfg.b1) * g)
    if cfg.weight_decay:
        u = u + cfg.weight_decay * p.float()
    p.copy_(p.float() - cfg.lr * u)
    m.copy_(cfg.b2 * m32 + (1 - cfg.b2) * g)


@torch.no_grad()
def opt_update(grads: dict[str, torch.Tensor], state: dict, params, cfg: OptConfig,
               *, owned: dict[str, bool] | None = None, group=None):
    """One step, in place.  Returns (params, state, {"grad_norm"}).  ``owned``
    and ``group``: see :func:`global_norm`."""
    leaves = _leaves(params)
    count = state["count"] + 1
    gnorm = global_norm(grads, owned, group)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    # the reference forms b ** count in f32 from an int32 count
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(count))
    kinds = [k for k in ("m", "v") if k in state]

    def update(name, moments):
        if cfg.name == "lion":
            _lion_leaf(leaves[name], grads[name], moments[0], cfg, scale)
        else:
            _adamw_leaf(leaves[name], grads[name], *moments, cfg, scale, bc1, bc2)

    streamed = any(state[k][n].device != p.device and p.device.type == "cuda"
                   for k in kinds for n, p in leaves.items())
    if streamed:
        _streamed(leaves, state, kinds, update)
    else:
        for name in leaves:
            update(name, [state[k][name] for k in kinds])
    state = {**state, "count": count}
    return params, state, {"grad_norm": gnorm}


def _streamed(leaves: dict, state: dict, kinds: list[str], update) -> None:
    """The update with host moments: leaf i+1's moments are copied in on one
    side stream while leaf i updates on the current stream, and leaf i's are
    copied out on another; two staging slots, reused once the copy out of
    the leaf two back has finished."""
    names = list(leaves)
    for k in kinds:
        for n in names:
            if not state[k][n].is_pinned():
                raise RuntimeError(f"optimizer state {k}/{n} is in pageable host memory; "
                                   f"offloaded moments must be pinned")
    dev = next(iter(leaves.values())).device
    main = torch.cuda.current_stream(dev)
    h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    dt = state[kinds[0]][names[0]].dtype
    big = max(leaves[n].numel() for n in names)
    slots = [[torch.empty(big, dtype=dt, device=dev) for _ in kinds] for _ in range(2)]
    freed = [None, None]          # event: the slot's last copy out finished
    arrived = {}

    def stage(i):
        n, s = names[i], i % 2
        with torch.cuda.stream(h2d):
            if freed[s] is not None:
                h2d.wait_event(freed[s])
            for buf, k in zip(slots[s], kinds):
                buf[:leaves[n].numel()].view(leaves[n].shape).copy_(state[k][n],
                                                                    non_blocking=True)
            arrived[i] = h2d.record_event()

    h2d.wait_stream(main)         # the gradients and the clip scale
    d2h.wait_stream(main)
    stage(0)
    for i, n in enumerate(names):
        if i + 1 < len(names):
            stage(i + 1)
        main.wait_event(arrived.pop(i))
        s, shape = i % 2, leaves[n].shape
        moments = [buf[:leaves[n].numel()].view(shape) for buf in slots[s]]
        update(n, moments)
        done = main.record_event()
        with torch.cuda.stream(d2h):
            d2h.wait_event(done)
            for m, k in zip(moments, kinds):
                state[k][n].copy_(m, non_blocking=True)
            freed[s] = d2h.record_event()
    main.wait_stream(d2h)
