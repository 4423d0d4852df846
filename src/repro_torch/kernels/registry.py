"""The port's kernel entry points as dispatcher ops, ``repro_torch::<name>``.

Each kernel wrapper (``flash_attention_fwd``, ``ssd_scan_bwd``, ...) calls
one op, so that every dispatch mode sees the kernel as one call:
``FakeTensorMode``, ``MemTracker``, and the step counter of
``repro_torch.core.op_cost`` (which would otherwise count the plain
version's torch ops, or fail on a fake tensor).  Each op has

  * a CUDA implementation: the checked ctypes launch, which raises when it
    fails (and counts the launch);
  * a CPU implementation: the plain version;
  * a fake implementation that only allocates the outputs (fake tensors);

and none for any other device: the wrappers raise for one
(:func:`check_device`).

The ops are registered on a ``torch.library.Library`` (``define`` /
``impl`` / ``register_fake``), whose call goes from the dispatcher straight
to the Python implementation.  ``torch.library.custom_op``'s Python wrapper
cost more on an H100's host: 36-43 µs a WKV6 decode call over the direct
launch, against 10-15 µs for ``Library`` (PERF.md §6).
"""

from __future__ import annotations

import torch

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def check_device(name: str, t: torch.Tensor) -> None:
    """The wrappers' guard: a tensor on a device other than cuda or cpu
    raises (a meta tensor too; a fake tensor reports the device it stands
    for)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {t.device}")


def define(name: str, schema: str, *, cuda, cpu, fake):
    """Register ``repro_torch::name`` with ``schema`` (``"(Tensor q, ...) ->
    (Tensor, Tensor)"``) and return its overload, ``torch.ops.repro_torch.<name>.default``."""
    _LIB.define(name + schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(torch.ops.repro_torch, name).default


def flop_formula(op, flops):
    """Register ``flops(*args)`` (the op's arguments with every tensor
    replaced by its shape, as ``torch.utils.flop_counter`` passes them) as
    the op's formula for ``FlopCounterMode`` and ``core.op_cost``."""
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(op.overloadpacket)
    def _formula(*args, out_shape=None, **kwargs):
        return int(flops(*args))

    return _formula
