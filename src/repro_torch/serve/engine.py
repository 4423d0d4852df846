"""Serving runtime for the port: a batched greedy-decoding engine, the torch
twin of ``repro.serve.engine.ServeEngine``, and the sharded prefill and
decode steps, the twins of its ``compile_prefill`` / ``compile_decode_step``.

PyTorch runs eagerly, so there is no compile step: prefill and decode are
the model's own functions, and the KV cache is allocated once per
``generate`` call and updated in place.

``compile_prefill`` and ``compile_decode_step`` lay a model out on a mesh by
a plan and return a step that runs on every rank: the parameters whole on
each rank (``tp = 1``, ``zero_stage <= 1``, through ``parallel.layout``),
each rank's rows of the batch and of the cache by ``sharding.cache_specs``
(the batch over the longest prefix of the batch axes that divides it; at a
batch that no axis divides, the KV caches' sequence over the batch axes, each
rank attending over its slice and the slices combined as flash-decoding's
split-KV does: ``models.attention.seq_shard``), and the logits gathered
whole on every rank, as the reference's ``out_shardings=None`` gives them.
``tp > 1``, ZeRO-3, ``pp``, ``sp`` and the MoE family raise
``NotImplementedError`` naming ROADMAP A14b; offload has no effect on
serving, as in the reference.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import attention
from repro_torch.models.api import Model
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.layout import Layout, rank_groups
from repro_torch.parallel.plan import ExecutionPlan


class ServeEngine:
    """Minimal batched greedy-decoding engine (single-process runtime)."""

    def __init__(self, model: Model, params, max_len: int = 256):
        self.model = model
        self.params = params
        self.max_len = max_len

    @torch.no_grad()
    def generate(self, batch, steps: int) -> torch.Tensor:
        """batch: the prompt on the model's device, {"tokens": (B, S)} plus
        the config's modality stub ("frames" or "patches", as
        ``Model.prefill`` takes it), or a bare token tensor.  Returns the
        greedy continuation (B, steps + 1): the token after the prompt, then
        one per decode step."""
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        cache = self.model.init_cache(tokens.shape[0], self.max_len)
        cache, logits = self.model.prefill(self.params, cache, batch)
        out = []
        tok = logits.argmax(dim=-1)
        for _ in range(steps):
            out.append(tok)
            cache, logits = self.model.decode_step(self.params, cache, tok)
            tok = logits.argmax(dim=-1)
        out.append(tok)
        return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Sharded serving steps
# ---------------------------------------------------------------------------

def check_serve_plan(model: Model, plan: ExecutionPlan) -> None:
    """Raise for the serving plans the port does not run yet."""
    plan.validate()
    cfg = model.cfg
    for bad, what in ((cfg.n_experts, f"{cfg.name}: the MoE family's plans across a mesh"),
                      (plan.tp > 1, f"tp={plan.tp}: tensor-parallel serving"),
                      (plan.zero_stage == 3, "zero_stage=3: ZeRO-3 serving"),
                      (plan.pp > 1, f"pp={plan.pp}: pipeline-parallel serving"),
                      (plan.sp, "sp: sequence-parallel serving")):
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP A14b)")


def _meta_cache(model: Model, batch: int, max_len: int) -> dict:
    return model.family.init_cache(model.cfg, batch, max_len, device="meta", dtype=model.dtype)


def _shapes(tree: dict) -> dict:
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape) if isinstance(v, torch.Tensor) else v) for k, v in tree.items()}


def cache_shapes(model: Model, batch: int, max_len: int) -> dict:
    """The cache tree with every tensor leaf replaced by its shape (built on
    the meta device: nothing is allocated)."""
    return _shapes(_meta_cache(model, batch, max_len))


class _ServeShard:
    """One rank's share of a served cell: its rows, its cache slice, the
    groups its logits and split-KV attention reduce over."""

    def __init__(self, model: Model, plan: ExecutionPlan, mesh, shape: ShapeConfig):
        check_serve_plan(model, plan)
        self.model, self.shape = model, shape
        self.layout = layout = Layout(model, plan, mesh)
        self._meta = _meta_cache(model, shape.global_batch, shape.seq_len)
        full = _shapes(self._meta)
        self.cache_specs = sh.cache_specs(full, layout.shape, plan)
        # every cache leaf splits its batch dim the same way (the same B)
        entries = {spec[1] for _, spec in _named_leaves(self.cache_specs) if len(spec) > 1}
        seq = {spec[2] for name, spec in _named_leaves(self.cache_specs)
               if name in sh._CACHE_KV and len(spec) == 5 and spec[2] is not None}
        if len(entries) > 1 or len(seq) > 1:
            raise NotImplementedError(f"cache leaves split differently: {self.cache_specs}")
        self.row_axes = sh.spec_axes(entries.pop() if entries else None)
        self.seq_axes = sh.spec_axes(seq.pop() if seq else None)
        self.rows = sh.axis_size(layout.shape, self.row_axes)
        self.row_index = layout._index(self.row_axes, layout.coord)
        if shape.global_batch % self.rows:
            raise ValueError(f"{shape.global_batch} rows over {self.rows} ranks")
        self.local_batch = shape.global_batch // self.rows
        # new_group is collective: every rank creates every group, in order
        self.row_group = self._group(self.row_axes) if self.rows > 1 else None
        self.seq = None
        if self.seq_axes:
            cfg = model.cfg
            if cfg.is_encdec or cfg.mla or cfg.sliding_window:
                raise NotImplementedError(f"{cfg.name}: a sequence-split cache of this "
                                          f"family is not ported yet (ROADMAP A14b)")
            n = sh.axis_size(layout.shape, self.seq_axes)
            index = layout._index(self.seq_axes, layout.coord)
            S = next(spec_shape[2] for name, spec_shape in _named_leaves(full)
                     if name in sh._CACHE_KV and len(spec_shape) == 5)
            self.seq = attention.SeqShard(offset=index * (S // n), size=n,
                                          group=self._group(self.seq_axes))

    def _group(self, axes):
        mine = None
        for ranks in rank_groups(self.layout.mesh, axes):
            group = dist.new_group(ranks)
            if self.layout.rank in ranks:
                mine = group
        return mine

    def local_cache(self) -> dict:
        """This rank's zeroed cache: each leaf's local shape by its spec."""
        dev = self.model.device

        def walk(tree, specs):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = walk(v, specs[k])
                elif isinstance(v, torch.Tensor):
                    local = tuple(n // sh.axis_size(self.layout.shape, sh.spec_axes(e))
                                  for n, e in zip(v.shape, specs[k]))
                    out[k] = torch.zeros(local, dtype=v.dtype, device=dev)
                else:
                    out[k] = v
            return out
        return walk(self._meta, self.cache_specs)

    def rows_of(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch leaf."""
        n = self.local_batch
        return t[self.row_index * n:(self.row_index + 1) * n]

    def run(self, fn, *args):
        """``fn(*args) -> (cache, local logits)`` with the split-KV context
        set; returns (cache, the logits of the whole batch)."""
        with attention.seq_shard(self.seq):
            cache, logits = fn(*args)
        if self.row_group is None:
            return cache, logits
        out = logits.new_empty((self.rows * logits.shape[0],) + tuple(logits.shape[1:]))
        dist.all_gather_into_tensor(out, logits.contiguous(), group=self.row_group)
        return cache, out


def _named_leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v)
        else:
            yield k, v


def _shardings(specs):
    return {k: _shardings(v) if isinstance(v, dict) else sh.Sharding(v)
            for k, v in specs.items()}


def _params(shard: _ServeShard, state: dict | None):
    model = shard.model
    return shard.layout.shard_module(model.load(state) if state is not None else model.init())


def compile_prefill(model: Model, plan: ExecutionPlan, mesh, shape: ShapeConfig,
                    state: dict | None = None):
    """The full-prompt prefill step on ``mesh`` (populates the cache).
    Returns ``(step, param_shardings, cache_shardings, batch_shardings,
    params, cache)``: ``step(params, cache, batch)`` takes this rank's rows
    of the batch (``step.rows_of`` cuts them from the global batch) and its
    cache, and returns ``(cache, logits (B, V))`` with every row's logits."""
    shard = _ServeShard(model, plan, mesh, shape)
    specs = {k: tuple(v.shape) for k, v in model.input_specs(shape).items()}
    b_specs = sh.batch_specs(specs, shard.layout.shape, plan)
    if any(sh.spec_axes(s[0] if s else None) != shard.row_axes for s in b_specs.values()):
        raise NotImplementedError(f"batch {b_specs} and cache rows {shard.row_axes} differ")
    params = _params(shard, state)

    def step(params, cache, batch):
        return shard.run(model.prefill, params, cache, batch)

    step.layout, step.rows_of, step.shard = shard.layout, shard.rows_of, shard
    p_shard = {n: sh.Sharding(s) for n, s in shard.layout.param_specs.items()}
    return (step, p_shard, _shardings(shard.cache_specs),
            {k: sh.Sharding(s) for k, s in b_specs.items()}, params, shard.local_cache())


def compile_decode_step(model: Model, plan: ExecutionPlan, mesh, shape: ShapeConfig,
                        state: dict | None = None):
    """The one-token decode step on ``mesh`` against a ``shape.seq_len``
    cache.  Returns ``(step, param_shardings, cache_shardings,
    token_sharding, params, cache)``: ``step(params, cache, tokens)`` takes
    this rank's rows of the tokens (those of its cache rows) and returns
    ``(cache, logits (B, V))`` with every row's logits."""
    shard = _ServeShard(model, plan, mesh, shape)
    params = _params(shard, state)

    def step(params, cache, tokens):
        return shard.run(model.decode_step, params, cache, tokens)

    step.layout, step.rows_of, step.shard = shard.layout, shard.rows_of, shard
    p_shard = {n: sh.Sharding(s) for n, s in shard.layout.param_specs.items()}
    row = shard.row_axes
    tok = sh.Sharding(((row if len(row) > 1 else row[0]) if row else None,))
    return step, p_shard, _shardings(shard.cache_specs), tok, params, shard.local_cache()
