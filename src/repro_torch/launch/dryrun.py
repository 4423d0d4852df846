"""Dry run: count one rank's step of every (architecture x input-shape) cell
on the production mesh and price it with the H100's figures — the port's
counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for 512 placeholder devices and
reads the HLO.  The port has no graph: a cell builds the full-width model
under ``FakeTensorMode`` (no weights are allocated) on the fake 16 x 16 or 2
x 16 x 16 mesh of ``launch.mesh.make_production_mesh`` (a fake process group
of 256 or 512 ranks, this process rank 0), runs one step of
``compile_train_step`` (a train cell) or one call of ``serve.engine``'s
``compile_prefill`` / ``compile_decode_step`` (a prefill or decode cell, the
decode at the last slot of a full ``seq_len`` cache) as rank 0, counts it
with ``core.op_cost`` and prices it with ``core.roofline`` (whose
constants are the H100 SXM's spec figures).  Each kernel op is counted by
its formula through its fake implementation.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]

Rows go to ``build/repro_torch/dryrun/dryrun_<tag>.json``.  Statuses are the
reference's (``ok``, ``skipped`` with ``shape_applicable``'s reason,
``error``) and ``not_ported``: a cell the port cannot run yet, its reason
naming the ROADMAP item.  Only ``error`` makes the exit code nonzero.  The
reference's ``--schedule`` has no counterpart (the port has no
``attn_schedule``: ``models.transformer.ModelOpts``); each row records
``"schedule": "band"``.  ``trace_s`` (seconds to build and run the cell under
fake tensors) stands where the reference has ``lower_s`` / ``compile_s``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from repro_torch.core import costs, op_cost, roofline
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.train.optimizer import OptConfig

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun"

# The reference's ARCHS[:10], in its order: the cells of ``--all``.
ARCHS = ("zamba2-7b", "phi-3-vision-4.2b", "gemma-2b", "starcoder2-3b", "qwen2-72b",
         "phi3-medium-14b", "moonshot-v1-16b-a3b", "deepseek-v3-671b", "rwkv6-1.6b",
         "seamless-m4t-large-v2")
NOT_PORTED = {
    "qwen2-72b": "ROADMAP A8: the config is not ported (and needs TP across the mesh, A14b)",
    "phi3-medium-14b": "ROADMAP A8: the config is not ported",
    "moonshot-v1-16b-a3b": "ROADMAP A14b: the MoE family's plans across a mesh are not ported",
    "deepseek-v3-671b": "ROADMAP A14b: the MoE family's plans across a mesh are not ported",
}

# Activation-carry budget per device used to derive the GA factor (bytes).
ACT_BUDGET = 4e9


def default_plan(cfg: ModelConfig, shape: ShapeConfig, mesh: dict,
                 overrides: dict | None = None):
    """Paper-faithful baseline plan for a dry-run cell + optimizer config
    (the reference's ``default_plan``; ``mesh`` is ``{axis: size}``).

    Small models use ZeRO-DP across the whole machine (TP activation
    all-reduces would dominate); big models use Megatron-style TP over the
    model axis + FSDP over the data axes; the 671B class uses Lion with bf16
    momentum."""
    n_params = costs.param_count(cfg)
    big = n_params > 8e9
    tp = mesh.get("model", 1) if big else 1
    daxes = [a for a in ("pod", "data") if a in mesh]
    dp_phys = int(math.prod(mesh[a] for a in daxes))
    dp = dp_phys if big else dp_phys * mesh.get("model", 1)
    ga = 1
    if shape.kind == "train":
        b_loc = max(1, shape.global_batch // min(dp, shape.global_batch))
        act = b_loc * shape.seq_len * cfg.d_model * 2 * max(cfg.n_layers, 1)
        while act / ga > ACT_BUDGET and ga < b_loc:
            ga *= 2
    plan = ExecutionPlan(dp=dp, tp=tp, zero_stage=3 if big else 1, ga_steps=ga,
                         gc=(shape.kind == "train"))
    if n_params > 1e11:
        opt = OptConfig(name="lion", moment_dtype="bfloat16", b1=0.95, b2=0.98, lr=1e-4)
    else:
        opt = OptConfig()
    if overrides:
        od = dict(overrides)
        opt_over = {k[4:]: od.pop(k) for k in list(od) if k.startswith("opt_")}
        plan = plan.with_(**od)
        if opt_over:
            opt = replace(opt, **opt_over)
    plan.validate()
    return plan, opt


def step_of(cfg: ModelConfig, shape: ShapeConfig, mesh, plan: ExecutionPlan, optcfg,
            device="cpu"):
    """Build the cell's model and step on ``mesh`` (call under
    ``FakeTensorMode``: nothing is allocated) and return ``(run, held)``:
    ``run()`` runs the rank's one step; ``held`` is what the rank holds
    before it (weights, optimizer state or cache, inputs)."""
    from repro_torch.models import ModelOpts, build

    opts = ModelOpts(remat="full" if plan.gc else "none", loss_chunk=min(2048, shape.seq_len))
    model = build(cfg, device=device, opts=opts)
    if shape.kind == "train":
        from repro_torch.train.step import compile_train_step

        specs = model.input_specs(shape)
        step, _, _, b_sh, params, opt_state = compile_train_step(model, plan, mesh, optcfg,
                                                                 specs)
        batch = {}
        for k, spec in specs.items():
            _, count = step.layout.batch_shard(b_sh[k].spec)
            rows = spec.shape[0] // count
            batch[k] = _fake_input(model, spec, (rows,) + tuple(spec.shape[1:]))
        return (lambda: step(params, opt_state, batch)), (params, opt_state, batch)
    if shape.kind == "prefill":
        from repro_torch.serve.engine import compile_prefill

        step, _, _, _, params, cache = compile_prefill(model, plan, mesh, shape)
        batch = {k: _fake_input(model, spec, (step.shard.local_batch,) + tuple(spec.shape[1:]))
                 for k, spec in model.input_specs(shape).items()}
        return (lambda: step(params, cache, batch)), (params, cache, batch)
    from repro_torch.serve.engine import compile_decode_step

    step, _, _, _, params, cache = compile_decode_step(model, plan, mesh, shape)
    cache["pos"] = shape.seq_len - 1                  # the last slot of a full cache
    tokens = _fake_input(model, model.input_specs(shape)["tokens"],
                         (step.shard.local_batch,))
    return (lambda: step(params, cache, tokens)), (params, cache, tokens)


def _fake_input(model, spec, shape) -> torch.Tensor:
    """Zeros of ``spec``'s dtype and ``shape`` on the model's device (fake
    under FakeTensorMode)."""
    return torch.zeros(shape, dtype=spec.dtype, device=model.device)


def _step_mem_tracker(counter: op_cost.OpCounter):
    """A ``MemTracker`` over one step that also hands every op to
    ``counter``: one dispatch mode for both, since each mode a fake
    tensor's op passes through costs about as much again as the op.  The
    step may enter the root module more than once (GA's micro-steps): each
    new forward of the root starts the per-module stats afresh, which
    MemTracker otherwise refuses.  Only the
    whole step's peak is read, so the per-module peaks, which MemTracker
    updates over every tracked module at every op, are not kept.

    The two methods overridden are MemTracker's private ones, as in torch
    2.11 and 2.13 (the versions this was checked against); a torch without
    them raises here rather than track the step some other way."""
    from torch.distributed._tools.mem_tracker import MemTracker

    for name in ("_pre_fw_hook", "_update_peak_stats"):
        if not callable(getattr(MemTracker, name, None)):
            raise RuntimeError(f"torch {torch.__version__}: MemTracker has no {name}, "
                               f"which the step's tracker overrides")

    class StepMemTracker(MemTracker):
        def _pre_fw_hook(self, module, inputs):
            if module in self.memory_tracking and not self._mod_tracker.is_bw:
                name = self._mod_tracker.get_known_fqn(module)
                if set(self._mod_tracker.parents) - {name} == {"Global"}:
                    self.reset_mod_stats()
            super()._pre_fw_hook(module, inputs)

        def _update_peak_stats(self, peak_state):
            for dev, snap in self._curr_mem_snap.items():
                if self._peak_mem.get(dev, 0) < snap["Total"]:
                    self._peak_mem[dev] = snap["Total"]
                    self._peak_mem_snap[dev] = dict(snap)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            # A device query allocates nothing, and a fake tensor makes
            # about one an op.
            if func is torch.ops.prim.device.default:
                return func(*args, **(kwargs or {}))
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented:
                counter.record(func, args, kwargs or {}, out)
            return out

    return StepMemTracker()


def count_step(run, held=()) -> tuple[op_cost.Cost, float]:
    """(count, peak live bytes under MemTracker) of one call of ``run``;
    the peak includes the tensors and modules of ``held`` (any nesting of
    dicts, lists and tuples), which exist before the call."""
    from torch.utils._pytree import tree_flatten

    counter = op_cost.OpCounter()
    tracker = _step_mem_tracker(counter)
    tracker.track_external(*(x for x in tree_flatten(held)[0]
                             if isinstance(x, (torch.Tensor, torch.nn.Module))))
    with tracker, counter.module_paths():
        run()
    peak = max((snap.get("Total", 0) for snap in tracker.get_tracker_snapshot("peak").values()),
               default=0)
    return counter.cost, float(peak)


def run_cell(arch: str, shape_name: str, mesh, *, plan_overrides: dict | None = None,
             verbose: bool = True, device="cpu") -> dict:
    """Count and price one cell on ``mesh`` (a fake production mesh).
    Returns a result-row dict."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import mesh_shape

    mshape = mesh_shape(mesh)
    mesh_name = "x".join(str(v) for v in mshape.values())
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if arch in NOT_PORTED:
        return {**base, "status": "not_ported", "reason": NOT_PORTED[arch]}
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    okay, why = shape_applicable(cfg, shape)
    if not okay:
        return {**base, "status": "skipped", "reason": why}
    plan, optcfg = default_plan(cfg, shape, mshape, plan_overrides)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        run, held = step_of(cfg, shape, mesh, plan, optcfg, device=device)
        cost, peak = count_step(run, held)
    trace_s = time.perf_counter() - t0
    rep = roofline.analyze(cost, arch=arch, shape=shape, mesh=mshape,
                           model_flops=costs.model_flops(cfg, shape),
                           attn_flops=costs.attention_flops(cfg, shape), peak_bytes=peak)
    row = rep.row()
    row.update({
        "status": "ok", "plan": plan.strategy,
        "plan_tuple": {"dp": plan.dp, "tp": plan.tp, "ga": plan.ga_steps,
                       "zero": plan.zero_stage, "gc": plan.gc, "offload": plan.offload,
                       "sp": plan.sp},
        "schedule": "band", "trace_s": round(trace_s, 1),
        "kernel_calls": dict(cost.kernel_calls), "kernel_flops": dict(cost.kernel_flops),
        "dot_flops": cost.dot_flops, "n_ops": cost.n_ops,
    })
    if verbose:
        print(f"[{mesh_name}] {arch} x {shape_name}: plan={plan.strategy} "
              f"trace={trace_s:.0f}s Tc={rep.t_compute * 1e3:.1f}ms "
              f"Tm={rep.t_memory * 1e3:.1f}ms Tcoll={rep.t_collective * 1e3:.1f}ms -> "
              f"{rep.bottleneck} useful={rep.useful_ratio:.2f} "
              f"roofline_frac={rep.roofline_fraction:.2f}", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--plan-override", default=None,
                    help='JSON, e.g. {"ga_steps": 4}')
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    pods = [False, True] if args.both_meshes else [args.multi_pod]
    overrides = json.loads(args.plan_override) if args.plan_override else None
    arch_list = ARCHS if (args.all or not args.arch) else [args.arch]
    shape_list = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out = RESULTS_DIR / f"dryrun_{args.tag}.json"
    rows = []
    try:
        for multi_pod in pods:
            mesh = make_production_mesh(multi_pod=multi_pod)
            mesh_name = "x".join(str(n) for n in mesh.mesh.shape)
            for arch in arch_list:
                for shape_name in shape_list:
                    try:
                        row = run_cell(arch, shape_name, mesh, plan_overrides=overrides)
                    except Exception as e:  # a cell failure is a bug — surface it
                        traceback.print_exc()
                        row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                               "status": "error", "error": f"{type(e).__name__}: {e}"}
                    rows.append(row)
                    out.write_text(json.dumps(rows, indent=1, default=str))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    n = {s: sum(r.get("status") == s for r in rows)
         for s in ("ok", "skipped", "not_ported", "error")}
    print(f"\ndry-run complete: {n['ok']} ok, {n['skipped']} skipped (documented), "
          f"{n['not_ported']} not ported, {n['error']} errors -> {out}")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
