"""One rank's share of a model under an execution plan: the runtime side of
``compile_train_step``'s placements.

``repro_torch.parallel.sharding`` says, for each leaf, which dim is split
over which mesh axes.  A :class:`Layout` applies that on this rank:

  * tensor parallelism (``"model"``): the rank keeps its slice of a split
    leaf (``wi`` packs ``[u | g]``: the rank keeps its columns of both
    halves, so the gated product stays local; the reference's order comes
    back when the leaf is gathered);
  * ZeRO-1 (a data-axis dim in the optimizer spec only): the parameter
    stays whole, the moments hold the rank's slice, the update writes the
    rank's slice of the parameter and an all-gather over the data group
    makes it whole again;
  * ZeRO-3 (a data-axis dim in the parameter spec): FSDP2 ``fully_shard``
    on each layer and on the root, each parameter sharded on the spec's
    dim.  Two kinds of leaf stay whole on every rank and take the ZeRO-1
    route: a leaf with no dim the data group divides (the reference
    replicates it), and a leaf in another dtype than the model's (FSDP2
    gathers a group in one dtype; these are the f32 leaves the SSM families
    keep beside bf16 weights).  On a one-rank data group every leaf of the
    model's dtype goes to FSDP2, sharded on dim 0.

The data group is the ranks that share this rank's ``"model"``
coordinate; its index orders ranks pod-major, as a spec entry that names
several axes does.  Every collective skips a group of one rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn as tnn

from repro_torch.launch.mesh import mesh_shape
from repro_torch.models import nn
from repro_torch.models.api import family_of
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.plan import ExecutionPlan

# The dense decoder's tensor-parallel leaves and the dim each is split on
# (the reference's rule tables, sharding._COL/_ROW and "emb").
_TP_DIMS = {"attn.wq": 1, "attn.wk": 1, "attn.wv": 1, "attn.wo": 0,
            "mlp.wi": 1, "mlp.wo": 0, "emb": 0, "head": 1}


@dataclass(frozen=True)
class Leaf:
    """Where one leaf lives on this rank."""
    tp_dim: int | None      # dim split over "model"
    dp_dim: int | None      # dim of the optimizer state split over the data axes
    fsdp: bool              # FSDP2 holds the parameter (sharded on dp_dim, or dim 0)
    owned: bool             # this rank's piece counts in the global norm


def _owner(module: tnn.Module, name: str) -> tuple[tnn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (module.get_submodule(path) if path else module), attr


def _all_gather(t: torch.Tensor, group, size: int) -> list[torch.Tensor]:
    if size == 1:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t, group=group)
    return out


def mesh_ranks(mesh) -> list[int]:
    """The mesh's ranks in row-major order, as plain integers (read outside
    any fake-tensor mode, which would refuse to hand a tensor's data over)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return [int(r) for r in mesh.mesh.flatten().tolist()]


def rank_groups(mesh, axes: tuple[str, ...]) -> list[list[int]]:
    """The ranks of ``mesh`` grouped by their coordinates on the axes not in
    ``axes``: one list per group, each ordered by its index over ``axes``
    (row-major, as a spec entry naming several axes orders them)."""
    names = list(mesh.mesh_dim_names)
    sizes = [int(n) for n in mesh.mesh.shape]
    ranks = mesh_ranks(mesh)
    groups: dict[tuple, list[tuple[int, int]]] = {}
    for flat, rank in enumerate(ranks):
        coord, rest = {}, flat
        for name, n in zip(reversed(names), reversed(sizes)):
            coord[name], rest = rest % n, rest // n
        key = tuple(coord[a] for a in names if a not in axes)
        index = 0
        for a in axes:
            index = index * sizes[names.index(a)] + coord[a]
        groups.setdefault(key, []).append((index, rank))
    return [[r for _, r in sorted(g)] for _, g in sorted(groups.items())]


class Layout:
    def __init__(self, model, plan: ExecutionPlan, mesh):
        cfg = model.cfg
        self.plan, self.mesh, self.cfg = plan, mesh, cfg
        self.device, self.dtype = model.device, model.dtype
        self.shape = mesh_shape(mesh)
        if mesh.device_type != model.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot hold a model on "
                             f"{model.device.type}")
        # With tp == 1 the "model" axis carries data parallelism too
        # (``sharding.batch_axes``), so the plan's dp spans it.
        self.daxes = sh.batch_axes(self.shape, plan)
        self.dsz = sh.axis_size(self.shape, self.daxes)
        tp = sh.axis_size(self.shape, tuple(a for a in ("model",) if a not in self.daxes
                                            and a in self.shape))
        if (self.dsz, tp) != (plan.dp, plan.tp):
            raise ValueError(f"mesh {self.shape} does not match the plan's dp={plan.dp}, "
                             f"tp={plan.tp}")
        meta = family_of(cfg).module(cfg, "meta", model.dtype)
        named = dict(meta.named_parameters())
        shapes = {n: tuple(p.shape) for n, p in named.items()}
        self.param_specs = sh.param_specs(shapes, self.shape, plan)
        self.opt_specs = sh.opt_state_specs(shapes, self.shape, plan)

        self.coord = coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.rank = dist.get_rank()
        self.data_index = self._index(self.daxes, coord)
        # One data group per "model" coordinate (one group of every rank when
        # the model axis carries data), created in the same order on every
        # rank (new_group is collective).  The rank lists are plain integers,
        # read outside any fake-tensor mode.
        for ranks in rank_groups(mesh, self.daxes):
            group = dist.new_group(ranks)
            if self.rank in ranks:
                self.data_group, self.data_ranks = group, ranks
        self.tp = (nn.TP(mesh.get_group("model"), coord["model"], plan.tp)
                   if plan.tp > 1 else None)
        self.world = None if dist.get_world_size() == 1 else dist.group.WORLD

        self.leaves = {}
        for name, p in named.items():
            pspec, ospec = self.param_specs[name], self.opt_specs[name]
            tp_dim = self._tp_dim(name, pspec)
            dp_dim = next((i for i, e in enumerate(ospec)
                           if sh.spec_axes(e) and set(sh.spec_axes(e)) <= set(self.daxes)),
                          None)
            fsdp = (plan.zero_stage == 3 and p.dtype == model.dtype
                    and (dp_dim is not None or self.dsz == 1))
            axes = {a for e in ospec for a in sh.spec_axes(e)}
            owned = all(coord[a] == 0 for a, n in self.shape.items() if n > 1 and a not in axes)
            self.leaves[name] = Leaf(tp_dim, dp_dim, fsdp, owned)
        self.gated = cfg.act in ("swiglu", "geglu")

    def _index(self, axes, coord) -> int:
        i = 0
        for a in axes:
            i = i * self.shape[a] + coord[a]
        return i

    def _tp_dim(self, name: str, spec) -> int | None:
        """The dim split over "model"; the spec must split the dense
        decoder's TP leaves as the port computes them."""
        if self.tp is None:
            return None
        key = name.split(".", 2)[-1] if name.startswith("layers.") else name
        want = _TP_DIMS.get(key)
        got = next((i for i, e in enumerate(spec) if e == "model"), None)
        if got != want:
            raise ValueError(f"{name}: spec {spec} splits dim {got} over 'model'; the port's "
                             f"tensor parallelism needs dim {want}")
        return got

    # ------------------------------------------------------------------
    # Pieces of a leaf
    # ------------------------------------------------------------------
    def tp_local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's tensor-parallel slice of a whole leaf."""
        d = self.leaves[name].tp_dim
        if d is None:
            return full
        n, t = self.tp.size, self.tp.rank
        if name.endswith("mlp.wi") and self.gated:
            u, g = full.chunk(2, dim=-1)
            return torch.cat([u.chunk(n, dim=-1)[t], g.chunk(n, dim=-1)[t]], dim=-1)
        return full.chunk(n, dim=d)[t]

    def tp_whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A leaf whole again from this rank's slice (collective over the
        tensor-parallel group), in the reference's order."""
        d = self.leaves[name].tp_dim
        if d is None:
            return t
        pieces = _all_gather(t.to(self.device), self.tp.group, self.tp.size)
        if name.endswith("mlp.wi") and self.gated:
            halves = [p.chunk(2, dim=-1) for p in pieces]
            return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=-1)
        return torch.cat(pieces, dim=d)

    def dp_part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's data-axis slice of a (tensor-parallel local) leaf: a view."""
        d = self.leaves[name].dp_dim
        if d is None:
            return t
        n = t.shape[d] // self.dsz
        return t.narrow(d, self.data_index * n, n)

    def dp_whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A leaf's data-axis slices gathered (collective over the data group)."""
        d = self.leaves[name].dp_dim
        if d is None or self.dsz == 1:
            return t
        return torch.cat(_all_gather(t.to(self.device), self.data_group, self.dsz), dim=d)

    # ------------------------------------------------------------------
    # The model
    # ------------------------------------------------------------------
    @torch.no_grad()
    def shard_module(self, params: tnn.Module) -> tnn.Module:
        """Lay out a whole module in place: tensor-parallel slices, then
        FSDP2 under ZeRO-3."""
        for name, p in list(params.named_parameters()):
            if self.leaves[name].tp_dim is not None:
                owner, attr = _owner(params, name)
                setattr(owner, attr, tnn.Parameter(self.tp_local(name, p).contiguous().clone()))
        if self.tp is not None:
            params.tp = self.tp
        if self.plan.zero_stage == 3:
            self._fully_shard(params)
        return params

    def _fully_shard(self, params: tnn.Module) -> None:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        named = dict(params.named_parameters())
        dims = {id(p): Shard(self.leaves[n].dp_dim or 0) for n, p in named.items()
                if self.leaves[n].fsdp}
        ignored = {p for n, p in named.items() if not self.leaves[n].fsdp} or None
        mesh = DeviceMesh.from_group(self.data_group, self.mesh.device_type,
                                     mesh=self.data_ranks, mesh_dim_names=("data",))
        kw = dict(mesh=mesh, shard_placement_fn=lambda p: dims[id(p)], ignored_params=ignored)
        for child in params.children():
            if isinstance(child, tnn.ModuleList):
                for layer in child:
                    fully_shard(layer, **kw)
        fully_shard(params, **kw)

    def local(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """The piece of a parameter (or of its gradient) this rank updates: a
        view, written in place by the optimizer."""
        if self.leaves[name].fsdp:
            return p.detach().to_local()
        return self.dp_part(name, p.detach())

    def sync_after_update(self, params: tnn.Module) -> None:
        """All-gather the ZeRO-1 slices each rank wrote back into whole
        parameters."""
        with torch.no_grad():
            for name, p in params.named_parameters():
                leaf = self.leaves[name]
                if not leaf.fsdp and leaf.dp_dim is not None and self.dsz > 1:
                    p.copy_(self.dp_whole(name, self.dp_part(name, p.detach())))

    def full_params(self, params: tnn.Module) -> dict[str, torch.Tensor]:
        """Every parameter whole, in the reference's layout (collective)."""
        out = {}
        for name, p in params.named_parameters():
            t = p.full_tensor() if self.leaves[name].fsdp else p
            out[name] = self.tp_whole(name, t.detach())
        return out

    @torch.no_grad()
    def load_params(self, params: tnn.Module, state: dict[str, torch.Tensor]) -> None:
        """Copy whole leaves (the reference's layout) into this rank's pieces."""
        for name, p in params.named_parameters():
            local = self.tp_local(name, state[name].to(p.device))
            if self.leaves[name].fsdp:
                p.to_local().copy_(self.dp_part(name, local))
            else:
                p.copy_(local)

    # ------------------------------------------------------------------
    # Optimizer state
    # ------------------------------------------------------------------
    def full_opt(self, opt_state: dict) -> dict:
        """The moments whole (collective), each leaf on the host as soon as
        it is gathered: ``{"count", "m"[, "v"]}``."""
        out = {"count": opt_state["count"]}
        for k in ("m", "v"):
            if k in opt_state:
                out[k] = {n: self.tp_whole(n, self.dp_whole(n, t)).cpu()
                          for n, t in opt_state[k].items()}
        return out

    def opt_piece(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole moment."""
        return self.dp_part(name, self.tp_local(name, whole))

    # ------------------------------------------------------------------
    # Batch
    # ------------------------------------------------------------------
    def batch_shard(self, spec) -> tuple[int, int]:
        """(index, count) of this rank's rows under a batch spec."""
        axes = sh.spec_axes(spec[0]) if spec else ()
        return self._index(axes, self.coord), sh.axis_size(self.shape, axes)
