"""ExecutionPlan → placements: the torch twin of ``repro.parallel.sharding``.

Pure functions of leaf names, shapes and a mesh SHAPE (an ordered
``{axis: size}``, e.g. ``{"data": 2, "model": 2}``), not of a live process
group, so the tests hold them to the reference without one.  They give

  * parameter specs (column/row tensor parallelism, vocab-sharded embeddings,
    FSDP: ``param_specs``);
  * optimizer-state specs (ZeRO-1 over the data axes: ``opt_state_specs``),
    and their memory (``opt_sharding``: host memory under ``plan.offload``,
    the reference's ``pinned_host``);
  * activation logical-axis rules and batch specs.

A spec is a tuple with one entry per dim: ``None``, a mesh axis name, or a
tuple of names (a ``PartitionSpec``'s entries).

The reference stacks each group of layers on a leading axis and skips that
axis when it adds FSDP (``_is_stacked``); the port keeps an
``nn.ModuleList`` (``repro_torch.convert`` unstacks).  So each spec is
computed on the reference's stacked leaf (``layers.3.attn.wq`` is path
``("layers", "attn", "wq")`` of shape ``(L, D, Hq·hd)``, the hybrid's
``shared.`` block a stack of 1) and its leading entry dropped: a layer's
leaf lands on the dim the reference shards.  A plan under which the
reference would shard the layer axis itself raises.

``cache_specs`` places the serving caches (batch over the data axes, heads
or sequence over "model"); the ``"seq"`` rule of ``activation_rules``
(sequence parallelism) waits for ROADMAP A14b.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

from repro_torch.convert import SINGLETON, STACKED
from repro_torch.parallel.plan import ExecutionPlan

Spec = tuple
MeshShape = Mapping[str, int]

# Leaf-name rule tables.  COL: shard output dim over "model"; ROW: input dim.
_COL = {"wq", "wk", "wv", "wqkv", "wi", "wg", "q_a", "q_b", "kv_a", "kv_b",
        "mix_a", "decay_a", "decay_b", "mix_b", "head", "patch_proj",
        "frame_proj", "wr"}
_ROW = {"wo", "out_proj"}
_EXPERT = {"we_in", "we_out"}
_REPLICATED = {"router", "conv_w", "conv_b", "in_proj", "A_log", "D_skip",
               "dt_bias", "enc_pos"}


def data_axes(mesh: MeshShape) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh)


def batch_axes(mesh: MeshShape, plan: ExecutionPlan) -> tuple[str, ...]:
    """Axes carrying data parallelism.  With tp==1 the model axis would sit
    idle, so DP/FSDP spans it too (pure-DP plans use the full machine)."""
    ax = data_axes(mesh)
    if plan.tp == 1 and "model" in mesh:
        ax = ax + ("model",)
    return ax


def axis_size(mesh: MeshShape, axes: tuple[str, ...] | str | None) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh[a]
    return n


def _fit(spec_parts: list, shape: tuple[int, ...], mesh: MeshShape) -> Spec:
    """Drop axes that don't divide the corresponding dim."""
    out = []
    for dim, part in zip(shape, spec_parts):
        if part is None:
            out.append(None)
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        if axes and dim % axis_size(mesh, axes) == 0:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


def _base_spec(path: tuple[str, ...], shape: tuple[int, ...],
               mesh: MeshShape, plan: ExecutionPlan) -> Spec:
    """TP/EP spec for one param leaf (before FSDP)."""
    name = path[-1]
    nd = len(shape)
    model = "model" if ("model" in mesh and plan.tp > 1) else None

    def last2(in_axis, out_axis):
        parts = [None] * nd
        if nd >= 2:
            parts[-2], parts[-1] = in_axis, out_axis
        elif nd == 1:
            parts[-1] = out_axis
        return parts

    if name == "emb":
        return _fit([model, None], shape, mesh)
    if name in _EXPERT:
        parts = [None] * nd
        parts[-3] = model                      # expert dim
        return _fit(parts, shape, mesh)
    if name in _REPLICATED or model is None or nd == 0:
        return (None,) * nd
    if name in _ROW:
        return _fit(last2(model, None), shape, mesh)
    if name in _COL:
        # rwkv channel-mix wv is (F, D): row-parallel despite the name
        if name == "wv" and "cm" in path:
            return _fit(last2(model, None), shape, mesh)
        return _fit(last2(None, model), shape, mesh)
    if name == "u":                            # rwkv bonus (·,H,hd)
        parts = [None] * nd
        if nd >= 2:
            parts[-2] = model
        return _fit(parts, shape, mesh)
    return (None,) * nd


_STACKED_GROUPS = ("layers", "dense_layers", "moe_layers", "ssm_layers",
                   "enc_layers", "dec_layers", "mixer", "tm", "cm")


def _is_stacked(path: tuple[str, ...]) -> bool:
    return any(p in _STACKED_GROUPS for p in path[:-1])


def _add_fsdp(spec: Spec, path, shape, mesh: MeshShape, plan: ExecutionPlan) -> Spec:
    """Shard the largest free dim over the data axes (ZeRO-3/FSDP)."""
    daxes = batch_axes(mesh, plan)
    dsz = axis_size(mesh, daxes)
    if dsz == 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    start = 1 if (_is_stacked(path) and len(shape) >= 3) else 0
    best, best_dim = None, -1
    for i in range(start, len(shape)):
        if parts[i] is None and shape[i] % dsz == 0 and shape[i] > best_dim:
            best, best_dim = i, shape[i]
    if best is not None:
        parts[best] = daxes if len(daxes) > 1 else daxes[0]
    return tuple(parts)


# ---------------------------------------------------------------------------
# The port's leaves as the reference's stacked ones
# ---------------------------------------------------------------------------

def reference_leaf(name: str, shape: tuple[int, ...],
                   n_stack: Mapping[str, int]) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """(path, shape) of the reference's leaf that holds the port's leaf
    ``name``: ``layers.3.attn.wq`` → ``("layers", "attn", "wq")`` with the
    layer count ``n_stack["layers"]`` in front; ``shared.attn.wq`` with 1."""
    head, _, rest = name.partition(".")
    if head in STACKED and rest:
        _, _, leaf = rest.partition(".")
        return (head, *leaf.split(".")), (n_stack[head], *shape)
    if head in SINGLETON and rest:
        return (head, *rest.split(".")), (1, *shape)
    return tuple(name.split(".")), tuple(shape)


def stack_sizes(names) -> dict[str, int]:
    """Layers in each stacked group, from the port's leaf names."""
    seen: dict[str, set] = {}
    for name in names:
        head, _, rest = name.partition(".")
        if head in STACKED and rest:
            seen.setdefault(head, set()).add(rest.partition(".")[0])
    return {head: len(idx) for head, idx in seen.items()}


def _per_layer(name: str, spec: Spec) -> Spec:
    head = name.partition(".")[0]
    if head in STACKED or head in SINGLETON:
        if spec[0] is not None:
            raise NotImplementedError(
                f"{name}: the reference shards the layer axis of this leaf ({spec}); the port "
                f"keeps one tensor per layer (ROADMAP A14b)")
        return spec[1:]
    return spec


def _specs(shapes: Mapping[str, tuple], mesh: MeshShape, plan: ExecutionPlan,
           fsdp: bool) -> dict[str, Spec]:
    n_stack = stack_sizes(shapes)
    out = {}
    for name, shape in shapes.items():
        path, full = reference_leaf(name, tuple(shape), n_stack)
        spec = _base_spec(path, full, mesh, plan)
        if fsdp:
            spec = _add_fsdp(spec, path, full, mesh, plan)
        out[name] = _per_layer(name, spec)
    return out


def param_specs(shapes: Mapping[str, tuple], mesh: MeshShape,
                plan: ExecutionPlan) -> dict[str, Spec]:
    """Spec of every parameter, by the port's leaf name (``{name: shape}``)."""
    return _specs(shapes, mesh, plan, fsdp=plan.zero_stage == 3)


def opt_state_specs(shapes: Mapping[str, tuple], mesh: MeshShape,
                    plan: ExecutionPlan) -> dict[str, Spec]:
    """Optimizer-moment specs: param spec + ZeRO-1 data-axis sharding."""
    return _specs(shapes, mesh, plan, fsdp=plan.zero_stage >= 1)


@dataclass(frozen=True)
class Sharding:
    """The twin of a ``NamedSharding``: a spec and the memory it lives in
    (``"device"``, or ``"pinned_host"`` for offloaded optimizer state)."""
    spec: Spec
    memory_kind: str = "device"


def opt_sharding(spec: Spec, plan: ExecutionPlan) -> Sharding:
    """Sharding of one optimizer leaf; host memory when offloading."""
    return Sharding(spec, "pinned_host" if plan.offload else "device")


# ---------------------------------------------------------------------------
# Activation rules / batch specs
# ---------------------------------------------------------------------------

def activation_rules(mesh: MeshShape, plan: ExecutionPlan) -> dict:
    if plan.sp:
        raise NotImplementedError("sequence parallelism (plan.sp) is not ported yet "
                                  "(ROADMAP A14b)")
    daxes = batch_axes(mesh, plan)
    model = ("model",) if ("model" in mesh and plan.tp > 1) else None
    return {
        "batch": daxes,
        "seq": None,
        "embed": None,
        "heads": model,
        "kv_heads": model,
        "ffn": model,
        "experts": model,
        "vocab": model,
    }


def batch_specs(batch_shapes: Mapping[str, tuple], mesh: MeshShape,
                plan: ExecutionPlan) -> dict[str, Spec]:
    """Each batch leaf's rows over the longest prefix of the batch axes that
    divides them."""
    daxes = batch_axes(mesh, plan)

    def one(shape):
        parts = [None] * len(shape)
        ax = list(daxes)
        while ax and (not parts or shape[0] % axis_size(mesh, tuple(ax))):
            ax.pop()
        if parts and ax:
            parts[0] = tuple(ax) if len(ax) > 1 else ax[0]
        return tuple(parts)
    return {k: one(tuple(s)) for k, s in batch_shapes.items()}


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None`` → no axis)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# Decode-cache specs
# ---------------------------------------------------------------------------

_CACHE_KV = {"k", "v", "self_k", "self_v", "cross_k", "cross_v"}


def cache_specs(cache_shapes: Mapping, mesh: MeshShape, plan: ExecutionPlan) -> dict:
    """Decode-state specs of a cache tree (``{key: shape tuple | subtree |
    other}``; a leaf that is not a shape, such as ``"pos"``, gets ``()``).
    KV caches: (stack, B, S, H, hd) — batch over data (falling back to S when
    batch doesn't divide), heads over model (falling back to S).  MLA
    latents: (stack, B, S, r) — S over model.  Recurrent states (stack, B,
    ...): batch over data, an SSM's or WKV's heads over model."""
    all_b = batch_axes(mesh, plan)
    model = "model" if "model" in mesh and plan.tp > 1 else None
    msz = axis_size(mesh, model)

    def fit_batch(dim: int):
        ax = list(all_b)
        while ax and dim % axis_size(mesh, tuple(ax)):
            ax.pop()
        if not ax or axis_size(mesh, tuple(ax)) == 1:
            return None, 1
        return (tuple(ax) if len(ax) > 1 else ax[0]), axis_size(mesh, tuple(ax))

    def one(name: str, shape: tuple[int, ...]) -> Spec:
        nd = len(shape)
        parts: list = [None] * nd
        if nd == 0:
            return ()
        if name in _CACHE_KV and nd == 5:
            _, B, S, H, _ = shape
            bspec, bsz = fit_batch(B)
            parts[1] = bspec
            if model and H % msz == 0:
                parts[3] = model
            elif model and S % msz == 0:
                parts[2] = model
            if bsz == 1 and parts[2] is None:
                # batch unshardable (e.g. long_500k B=1): shard S over the
                # unused axes instead (flash-decoding split-KV style)
                used = {parts[3]} if parts[3] else set()
                rem = tuple(a for a in all_b if a not in used)
                if rem and S % axis_size(mesh, rem) == 0 and axis_size(mesh, rem) > 1:
                    parts[2] = rem if len(rem) > 1 else rem[0]
            return tuple(parts)
        if name in ("c", "pe") and nd == 4:                 # MLA latents
            _, B, S, _ = shape
            parts[1], _ = fit_batch(B)
            if model and S % msz == 0:
                parts[2] = model
            return tuple(parts)
        # recurrent states / shifts: (stack, B, ...) — batch over data
        if nd >= 2:
            parts[1], _ = fit_batch(shape[1])
            if name in ("ssm", "wkv") and model and nd >= 3 and shape[2] % msz == 0:
                parts[2] = model                            # heads
        return tuple(parts)

    def walk(tree: Mapping) -> dict:
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, Mapping):
                out[key] = walk(leaf)
            elif isinstance(leaf, tuple):
                out[key] = one(key, leaf)
            else:
                out[key] = ()
        return out
    return walk(cache_shapes)
