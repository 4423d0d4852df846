"""Train step: the torch twin of ``repro.train.step.make_train_step``.

The plan's ``ga_steps`` splits the batch into equal microbatches along its
first axis.  Each microbatch runs its own backward, with gradients in the
parameters' dtype (as JAX takes them), and adds them to an f32 accumulator
before the next one; the sum is divided by ``ga_steps`` and the reported
loss is the mean of the microbatch losses.  ``gc`` acts through the model's
``ModelOpts(remat="full")``, which the launcher sets from the plan.
``make_train_step`` runs on one device and acts on ``ga_steps`` alone, as
the reference's does (its launcher jits it with no shardings).

``compile_train_step`` is the twin of the reference's: it lays the params,
the optimizer state and the batch out over a mesh by the plan
(``repro_torch.parallel.sharding`` for the specs,
``repro_torch.parallel.layout`` for this rank's pieces) and returns a step
that runs on every rank of the mesh:

  * DP: each rank's rows of the batch, gradients averaged over the data
    group (all-reduce);
  * ZeRO-1: the moments hold the rank's slice (``opt_state_specs``), the
    rank updates its slice of each parameter and all-gathers the rest;
  * ZeRO-3: FSDP2 ``fully_shard`` per layer, each parameter sharded on its
    ``param_specs`` dim (gradients arrive reduce-scattered);
  * TP (dense decoders): Megatron's column/row split, vocab-parallel
    embedding and loss (``repro_torch.models.nn``);
  * offload: the moments in host memory (``opt_sharding``'s
    ``pinned_host``), streamed through the device for the update;
  * GA and GC as in ``make_train_step``.

``pp > 1`` (GPipe), ``sp`` and TP outside the dense family raise
``NotImplementedError`` naming ROADMAP A14b; so does a TP degree that would
split a head, and any plan of the MoE family (whose layout across a mesh,
expert sharding among it, has not been held to the reference's): it trains
through ``make_train_step`` on one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import DECODER, Model, family_of
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.layout import Layout
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update


def _loss_and_grads(model: Model, params, batch: dict, ga: int, grad_of):
    """(loss, metrics, {name: gradient}) of a batch.  With ``ga > 1`` the
    batch is cut into ``ga`` microbatches along its first axis, each one's
    gradients (``grad_of(param)``) added into f32 and the sum divided by
    ``ga``; the loss is the mean of theirs.  Every ``.grad`` is left for the
    caller to clear."""
    named = dict(params.named_parameters())
    if ga == 1:
        loss, metrics = model.loss(params, batch)
        loss.backward()
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                {n: grad_of(p) for n, p in named.items()})
    rows = next(iter(batch.values())).shape[0]
    if rows % ga:
        raise ValueError(f"{rows} rows do not split into {ga} microbatches")
    grads, losses = {}, []
    for i in range(ga):
        mb = {k: x.reshape((ga, x.shape[0] // ga) + x.shape[1:])[i] for k, x in batch.items()}
        loss, _ = model.loss(params, mb)
        loss.backward()
        for n, p in named.items():
            g = grad_of(p).float()
            grads[n] = g if i == 0 else grads[n].add_(g)
            p.grad = None
        losses.append(loss.detach())
    for g in grads.values():
        g /= ga
    return torch.stack(losses).mean(), {}, grads


def make_train_step(model: Model, plan: ExecutionPlan, optcfg: OptConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    params (the model's ``nn.Module``) and the optimizer state are updated
    in place, and every ``.grad`` is cleared again before it returns."""

    def train_step(params, opt_state, batch: dict):
        loss, metrics, grads = _loss_and_grads(model, params, batch, plan.ga_steps,
                                               lambda p: p.grad)
        params, opt_state, opt_metrics = opt_update(grads, opt_state, params, optcfg)
        for p in params.parameters():
            p.grad = None
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def check_plan(cfg: ModelConfig, plan: ExecutionPlan) -> None:
    """Raise for what the port's plans do not do yet: nothing is ignored."""
    plan.validate()
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: the MoE family's plans across a mesh (DP, "
                                  f"ZeRO, offload, TP, expert sharding) are not ported yet "
                                  f"(ROADMAP A14b); make_train_step trains it on one device")
    if plan.pp > 1:
        raise NotImplementedError(f"pp={plan.pp}: pipeline parallelism (GPipe, "
                                  f"parallel/pipeline.py) is not ported yet (ROADMAP A14b)")
    if plan.sp:
        raise NotImplementedError("sp: sequence parallelism is not ported yet (ROADMAP A14b)")
    if plan.tp == 1:
        return
    if family_of(cfg) is not DECODER:
        raise NotImplementedError(f"{cfg.name}: tensor parallelism of the {cfg.family} family "
                                  f"is not ported yet (ROADMAP A14b)")
    hd = cfg.resolved_head_dim
    for leaf, heads in (("attn.wq", cfg.n_heads), ("attn.wk", cfg.n_kv_heads),
                        ("attn.wv", cfg.n_kv_heads)):
        if heads % plan.tp:
            raise NotImplementedError(
                f"{cfg.name}: tp={plan.tp} would split layers.*.{leaf} ({heads} heads of {hd}, "
                f"{heads * hd} columns) inside a head; the port computes whole heads only")
    for leaf, n in (("mlp.wi", cfg.d_ff), ("emb", cfg.vocab_size)):
        if n % plan.tp:
            raise NotImplementedError(f"{cfg.name}: tp={plan.tp} does not divide {leaf}'s "
                                      f"{n}; the port splits it evenly")


def compile_train_step(model: Model, plan: ExecutionPlan, mesh, optcfg: OptConfig,
                       batch_specs: dict, state: dict | None = None):
    """Lay the model out on ``mesh`` (a ``DeviceMesh`` from
    ``repro_torch.launch.mesh``) by ``plan`` and build its train step.

    ``batch_specs``: the batch's leaves (e.g. ``model.input_specs(shape)``),
    whose shapes are the global batch's.  ``state``: whole weights in the
    reference's layout (``repro_torch.convert``); the model's own ``init()``
    when not given.  Returns ``(step, param_shardings, opt_shardings,
    batch_shardings, params, opt_state)``; ``step(params, opt_state, batch)``
    takes this rank's rows of the batch (``step.layout.batch_shard``) and
    returns ``(params, opt_state, metrics)`` with the loss and grad norm of
    the global batch; ``step.layout`` gathers and scatters whole leaves
    (``repro_torch.train.checkpoint``)."""
    check_plan(model.cfg, plan)
    layout = Layout(model, plan, mesh)
    params = layout.shard_module(model.load(state) if state is not None else model.init())
    named = dict(params.named_parameters())
    opt_state = opt_init({n: layout.local(n, p) for n, p in named.items()}, optcfg,
                         host=plan.offload)
    p_shard = {n: sh.Sharding(s) for n, s in layout.param_specs.items()}
    o_shard = {"count": sh.Sharding(())}
    for k in ("m", "v"):
        if k in opt_state:
            o_shard[k] = {n: sh.opt_sharding(s, plan) for n, s in layout.opt_specs.items()}
    b_specs = sh.batch_specs({k: tuple(v.shape) for k, v in batch_specs.items()},
                             layout.shape, plan)
    b_shard = {k: sh.Sharding(s) for k, s in b_specs.items()}
    leaves = layout.leaves
    owned = {n: leaf.owned for n, leaf in leaves.items()}

    def grad_of(p):
        return p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad

    def mean_over_data(t):
        if layout.dsz > 1:
            dist.all_reduce(t, group=layout.data_group)
            t.div_(layout.dsz)
        return t

    def train_step(params, opt_state, batch: dict):
        loss, metrics, grads = _loss_and_grads(model, params, batch, plan.ga_steps, grad_of)
        for n, g in grads.items():
            if not leaves[n].fsdp:
                mean_over_data(g)
        named = dict(params.named_parameters())
        pieces = {n: layout.local(n, p) for n, p in named.items()}
        grads = {n: g if leaves[n].fsdp else layout.dp_part(n, g) for n, g in grads.items()}
        _, opt_state, opt_metrics = opt_update(grads, opt_state, pieces, optcfg, owned=owned,
                                               group=layout.world)
        layout.sync_after_update(params)
        for p in named.values():
            p.grad = None
        metrics = {k: mean_over_data(v.clone()) for k, v in {"loss": loss, **metrics}.items()}
        return params, opt_state, {**metrics, **opt_metrics}

    train_step.layout = layout
    return train_step, p_shard, o_shard, b_shard, params, opt_state
