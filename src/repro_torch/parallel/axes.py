"""Logical-axis → mesh-axis mapping: the torch twin of ``repro.parallel.axes``.

Models are written against *logical* axis names ("batch", "seq", "heads",
"embed", ...).  A rule set installed by :func:`logical_axis_rules` maps
them to mesh axes, and :func:`logical_to_spec` translates a tensor's names
into a spec (a tuple, as in ``repro_torch.parallel.sharding``).

The reference's ``shard`` (a ``with_sharding_constraint``) has no twin:
under the port's plans the layout of every activation follows from its
weights (column-split projections give head-split activations, the
all-reduce after a row-split projection gives replicated ones), so there
is nothing to constrain.  Sequence parallelism, which would need one,
waits (ROADMAP A14b).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Mapping, Sequence

_state = threading.local()


def _rules() -> Mapping[str, tuple[str, ...] | None] | None:
    return getattr(_state, "rules", None)


@contextmanager
def logical_axis_rules(
    rules: Mapping[str, tuple[str, ...] | str | None],
    axis_sizes: Mapping[str, int] | None = None,
) -> Iterator[None]:
    """Install logical→mesh axis rules for the duration of the context.

    ``axis_sizes`` (mesh axis → size) enables divisibility checks: a rule is
    silently dropped for a tensor dim it does not divide (e.g. kv_heads=1
    under MQA can't shard over a 16-way model axis)."""
    norm: dict[str, tuple[str, ...] | None] = {}
    for k, v in rules.items():
        if v is None:
            norm[k] = None
        elif isinstance(v, str):
            norm[k] = (v,)
        else:
            norm[k] = tuple(v)
    prev = _rules()
    prev_sizes = getattr(_state, "sizes", None)
    _state.rules = norm
    _state.sizes = dict(axis_sizes) if axis_sizes else None
    try:
        yield
    finally:
        _state.rules = prev
        _state.sizes = prev_sizes


def logical_to_spec(names: Sequence[str | None],
                    dims: Sequence[int] | None = None) -> tuple:
    """Translate logical axis names to a spec under current rules."""
    rules = _rules()
    if rules is None:
        return ()
    sizes = getattr(_state, "sizes", None)
    parts = []
    used: set[str] = set()
    for i, name in enumerate(names):
        axes = rules.get(name) if name is not None else None
        if axes is None:
            parts.append(None)
            continue
        free = tuple(a for a in axes if a not in used)
        if free and sizes is not None and dims is not None:
            n = 1
            for a in free:
                n *= sizes.get(a, 1)
            if n == 0 or dims[i] % n != 0:
                parts.append(None)
                continue
        used.update(free)
        # a PartitionSpec keeps a lone axis as its name
        parts.append((free if len(free) > 1 else free[0]) if free else None)
    return tuple(parts)
