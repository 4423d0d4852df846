"""Op counter for one rank's eager step: the port's counterpart of
``repro.core.hlo_cost``.

The reference walks the optimized HLO of a jitted step; the port has no
graph, so :class:`OpCounter`, a ``TorchDispatchMode``, counts the ops one
rank runs while the step runs eagerly (on real tensors or on fake ones,
``FakeTensorMode``; the counts agree).  Eager execution runs every layer and
every GA micro-step, so nothing needs a trip-count multiplier, and the count
is per rank by construction: the reference's ``calibrate_cost_scope`` has
no counterpart.

  * dots (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions): 2 x the
    multiply-adds, by ``torch.utils.flop_counter``'s formulas;
  * each ``repro_torch::`` kernel op by its own formula (the kernel
    module's ``fwd_cost`` / ``bwd_cost``, registered with
    ``register_flop_formula``), its calls counted per op;
  * elementwise ops and reductions: about 1 flop per element (the larger of
    the largest input and the output), as the reference counts them;
    copies, gathers and scatters count no flops;
  * collectives per kind, c10d (``allreduce_``, ``_allgather_base_``,
    ``_reduce_scatter_base_``, ``alltoall_base_``, send / recv,
    ``broadcast_``, and what FSDP2 issues) and ``_c10d_functional``, by the
    reference's convention (``repro.core.roofline.collective_bytes``): an
    all-reduce counts 2 x its result bytes, a reduce-scatter its operand
    bytes, the others their result bytes.

Bytes are each op's tensor inputs plus outputs: the traffic of the unfused
eager program, not XLA's fused one (which the reference counts at fusion
boundaries), so the port's bytes are an upper bound on what a fused step
would move.  Views and metadata-only ops (``empty``, ``detach``, reshapes)
count 0; an in-place op counts its mutated operand once read and once
written.

``dot_by_tag`` attributes dot and kernel FLOPs under the reference's tags
(``repro.core.hlo_cost.default_tag``) in the reference's order: the tag of
the ``nn.Module`` path that is running (global module hooks; the path below
the root module), else ``"backward"`` while autograd runs a backward
(remat's recompute included), else ``"other"``; the flash kernels count as
``"attention"``, SSD and WKV6 as ``"ssm"``, forward and backward alike.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute", "broadcast")

# c10d / _c10d_functional op -> the reference's collective kind
_COLLECTIVES = {
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_coalesced_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
    ("c10d", "recv_any_source_"): "collective-permute",
    ("c10d", "broadcast_"): "broadcast",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced_"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional", "broadcast"): "broadcast",
    ("_c10d_functional", "broadcast_"): "broadcast",
}
# Ops that move no data a step needs: namespace -> names.
_FREE_OPS = {"_c10d_functional": ("wait_tensor",), "c10d": ("barrier", "monitored_barrier_")}

# Allocation and metadata: no bytes, no flops.
_METADATA = {"empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like",
             "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type",
             "record_stream", "set_", "resize_", "_record_function_enter_new",
             "_record_function_exit", "_unsafe_view", "_reshape_alias"}
# Data movement: bytes, no flops (the reference's "free" HLO ops).
_MOVES = {"_to_copy", "clone", "copy_", "copy", "cat", "stack", "index", "index_select",
          "gather", "scatter", "scatter_", "scatter_add", "scatter_add_", "index_put",
          "index_put_", "index_add", "index_add_", "embedding", "embedding_dense_backward",
          "slice_scatter", "select_scatter", "diagonal_scatter", "as_strided_scatter",
          "constant_pad_nd", "fill", "fill_", "zero_", "zeros", "zeros_like", "ones",
          "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full", "arange",
          "repeat", "flip", "roll", "tril", "triu", "split_with_sizes_copy",
          "all_gather_copy_in", "chunk_cat", "_foreach_copy_", "masked_scatter"}

KERNEL_TAGS = {"flash_attention_fwd": "attention", "flash_attention_bwd": "attention",
               "ssd_scan_fwd": "ssm", "ssd_scan_bwd": "ssm", "wkv6_fwd": "ssm",
               "wkv6_bwd": "ssm"}


def default_tag(path: str) -> str:
    """The reference's tags (``repro.core.hlo_cost.default_tag``) read off an
    ``nn.Module`` path."""
    m = path.lower()
    for tag, pats in (
        ("attention", ("attn", "attention", "bkgqs", "bqkgd", "mla")),
        ("moe", ("moe", "ecf", "ecd", "router", "expert")),
        ("ssm", ("ssd", "mamba", "wkv", "bhpn", "bihp")),
        ("vocab", ("logits", "cross_entropy", "logsumexp", "chunk_loss", "embed")),
        ("optimizer", ("opt_update", "adam")),
    ):
        if any(p in m for p in pats):
            return tag
    return "other"


@dataclass
class Cost:
    """One rank's count.  ``flops`` holds every op's; ``dot_flops`` the aten
    dots' alone; ``kernel_flops`` / ``kernel_calls`` each ``repro_torch::``
    op's."""
    flops: float = 0.0
    bytes: float = 0.0
    dot_flops: float = 0.0
    coll: dict = field(default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    coll_calls: dict = field(default_factory=lambda: defaultdict(int))
    dot_by_tag: dict = field(default_factory=lambda: defaultdict(float))
    kernel_flops: dict = field(default_factory=lambda: defaultdict(float))
    kernel_calls: dict = field(default_factory=lambda: defaultdict(int))
    n_ops: int = 0

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    def summary(self) -> dict:
        """The fields two counts of one step must share, as plain values."""
        return {"flops": self.flops, "bytes": self.bytes, "dot_flops": self.dot_flops,
                "coll": dict(self.coll), "coll_calls": dict(self.coll_calls),
                "dot_by_tag": dict(self.dot_by_tag),
                "kernel_flops": dict(self.kernel_flops),
                "kernel_calls": dict(self.kernel_calls), "n_ops": self.n_ops}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or result (flat, or in lists and
    tuples one level down, as op schemas have them; deeper via pytree)."""
    out = []
    for x in (tree if isinstance(tree, (list, tuple)) else (tree,)):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor))
    return out


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _coll_bytes(kind: str, name: str, args, out) -> float:
    """Bytes of one collective by the reference's convention."""
    if name in ("send", "recv_", "recv_any_source_", "broadcast_", "allreduce_",
                "allreduce_coalesced_"):
        result = _tensors(args[0])                 # the tensors sent, received or reduced
    elif name in ("allgather_", "allgather_coalesced_", "_allgather_base_",
                  "allgather_into_tensor_coalesced_", "reduce_scatter_", "_reduce_scatter_base_",
                  "reduce_scatter_tensor_coalesced_", "alltoall_", "alltoall_base_"):
        result = _tensors(args[0])                 # c10d: outputs first, then inputs
        if kind == "reduce-scatter":
            return float(sum(_nbytes(t) for t in _tensors(args[1])))
    else:                                          # _c10d_functional: input first, result out
        result = _tensors(out)
        if kind == "reduce-scatter":
            return float(sum(_nbytes(t) for t in _tensors(args[0])))
    res = float(sum(_nbytes(t) for t in result))
    return 2.0 * res if kind == "all-reduce" else res


def _classify(func, registry) -> tuple:
    """What an op is: ("free" | "coll" | "meta" | "formula" | "kernel" |
    "move" | "elementwise", its namespace-less name, the collective kind)."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns == "prim" or name in _FREE_OPS.get(ns, ()):
        return "free", name, None
    kind = _COLLECTIVES.get((ns, name))
    if kind is not None:
        return "coll", name, kind
    if name in _METADATA or _is_view(func):
        return "meta", name, None
    if func.overloadpacket in registry:
        return ("kernel" if ns == "repro_torch" else "formula"), name, None
    if ns == "repro_torch":
        return "kernel", name, None
    return ("move" if name in _MOVES else "elementwise"), name, None


class OpCounter(TorchDispatchMode):
    """Counts the ops run under it into ``self.cost`` (a :class:`Cost`).

    Use as ``with OpCounter() as c: step(...)``; or :func:`count`."""

    def __init__(self, tag_fn=default_tag):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.cost = Cost()
        self.tag_fn = tag_fn
        self.registry = flop_registry
        self._stack: list[str] = []
        self._kinds: dict = {}                 # op overload -> _classify's answer
        self._names = weakref.WeakKeyDictionary()
        self._paths = None

    # The running module's path, from global module hooks (ModTracker would
    # do the same, but its backward hooks keep a train step's graph, and with
    # it the parameters, alive after the step).
    def _pre(self, module, args):
        if module not in self._names:
            for name, sub in module.named_modules():
                self._names.setdefault(sub, name)
        self._stack.append(self._names[module])

    def _post(self, module, args, out):
        if self._stack:
            self._stack.pop()

    @contextlib.contextmanager
    def module_paths(self):
        """Keep the running module's path (``dot_by_tag``'s tag) without
        entering the mode: for another mode that calls :meth:`record`."""
        from torch.nn.modules import module as nn_module

        hooks = (nn_module.register_module_forward_pre_hook(self._pre),
                 nn_module.register_module_forward_hook(self._post, always_call=True))
        try:
            yield self
        finally:
            for h in hooks:
                h.remove()

    def __enter__(self):
        self._paths = self.module_paths()
        self._paths.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._paths.__exit__(None, None, None)
        return out

    def _tag(self) -> str:
        """The innermost module's tag (its path below the root module), then
        "backward" while autograd runs a backward, else "other": the
        reference's order of patterns."""
        tag = self.tag_fn(self._stack[-1]) if self._stack else "other"
        if tag == "other" and torch._C._current_autograd_node() is not None:
            return "backward"
        return tag

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.record(func, args, kwargs, out)
        return out

    def record(self, func, args, kwargs, out) -> None:
        """Count one call of ``func`` (``kwargs`` a dict) that gave ``out``."""
        c = self.cost
        what = self._kinds.get(func)
        if what is None:
            what = self._kinds[func] = _classify(func, self.registry)
        role, name, kind = what
        if role == "free":
            return
        c.n_ops += 1
        if role == "coll":
            c.coll[kind] += _coll_bytes(kind, name, args, out)
            c.coll_calls[kind] += 1
            c.bytes += sum(_nbytes(t) for t in _tensors(out))
            return
        if role == "meta":
            return
        ins = _tensors(args) + (_tensors(list(kwargs.values())) if kwargs else [])
        outs = _tensors(out)
        c.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if role == "formula" or (role == "kernel" and func.overloadpacket in self.registry):
            f = float(self.registry[func.overloadpacket](*args, **kwargs, out_val=out))
            c.flops += f
            if role == "kernel":
                c.kernel_flops[name] += f
                c.kernel_calls[name] += 1
                c.dot_by_tag[KERNEL_TAGS.get(name, "other")] += f
            else:
                c.dot_flops += f
                c.dot_by_tag[self._tag()] += f
            return
        if role == "kernel":
            c.kernel_calls[name] += 1
            return
        if role == "move" or not outs:
            return
        c.flops += float(max(max((t.numel() for t in ins), default=0),
                             max(t.numel() for t in outs)))


def count(fn, *args, tag_fn=default_tag, **kwargs):
    """``(fn(*args, **kwargs), Cost)``: one call of ``fn`` counted."""
    with OpCounter(tag_fn) as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost

