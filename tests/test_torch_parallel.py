"""The port's execution plans against the JAX package, on the CPU.

* Placements: ``repro_torch.parallel.sharding``'s param, optimizer and
  batch specs (and the optimizer's host memory under offload) equal the
  reference's leaf for leaf, for reduced llama2-7b, gpt2-1.5b, zamba2-7b
  and rwkv6-1.6b under DP4, DP2 + TP2 ZeRO-1, DP4 ZeRO-3 and DP4 ZeRO-1 +
  offload.  The reference's specs come from one subprocess with 4 host
  devices, on a ``jax.sharding.Mesh`` (Auto axes: ``jax.make_mesh`` builds
  Explicit ones under jax 0.9.0, which the reference's own sharded tests
  trip over).
* Gloo worlds: 4 CPU ranks (one spawned process each, rendezvous through a
  ``file://`` store) run ``compile_train_step`` for 3 AdamW steps of a
  reduced model in f32, from a step-0 checkpoint that
  ``repro.train.checkpoint`` wrote.  Loss and grad norm are held to the
  single-device JAX ``make_train_step`` at rel 1e-4 and the updated params,
  gathered whole, at 2e-4 (max|Δ| / max|JAX| per leaf) plus twice the
  single-device port's own distance from JAX on that leaf: Adam's
  normalised step turns f32 rounding in a small gradient into a visible
  difference of a small leaf (reduced zamba2's ``ssm_layers.1.mixer.gamma``
  lies 2.03e-4 from JAX after 3 single-device port steps; llama's leaves
  under 1e-5), which no plan causes.  Plans: dp=4;
  dp=2 tp=2 ZeRO-1; dp=4 ZeRO-3; tp=4; dp=2 ZeRO-1 + offload + GA 2 (the
  JAX step with GA 2); ZeRO-3 for zamba2 and rwkv6; and on 2 ranks, with
  the modality stub the launcher draws split with the tokens,
  seamless-m4t-large-v2 under ZeRO-3 and phi-3-vision-4.2b under ZeRO-1.
* Reconfiguration: 2 steps under dp=2 tp=2 ZeRO-1, a checkpoint, a restore
  under dp=4 ZeRO-3 and 2 more steps equal 4 single-device JAX steps, and
  the port's sharded checkpoint restores in the JAX package.
* Refusals: pp > 1, sp, TP of the hybrid, RWKV-6, the encoder-decoder and
  the vision decoder, TP that would split a
  head (gpt2-1.5b's full config at tp=2, no weights built), a world too
  small for the mesh, a process group of the wrong backend, a failed pin.
* ``gpu``: offload on the card keeps pinned host moments and matches the
  step with the moments on the device.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ModelOpts as JModelOpts
from repro.models import build as jbuild
from repro.parallel.plan import ExecutionPlan as JExecutionPlan
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import opt_init as jopt_init
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.convert import params_from_jax_numpy, read_checkpoint
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch.train import train_batch
from repro_torch.models import build, nn
from repro_torch.models.api import family_of
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.train.step import check_plan

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ["llama2-7b", "gpt2-1.5b", "zamba2-7b", "rwkv6-1.6b"]
PLANS = {"dp4": {"dp": 4}, "dp2tp2z1": {"dp": 2, "tp": 2, "zero_stage": 1},
         "dp4z3": {"dp": 4, "zero_stage": 3},
         "dp4z1off": {"dp": 4, "zero_stage": 1, "offload": True}}
BATCH, SEQ, LR = 8, 32, 1e-3
TOL_LOSS, TOL_PARAMS = 1e-4, 2e-4


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------

# Run in a subprocess with 4 host devices, after PLANS, ARCHS and BATCH are set.
REFERENCE_SPECS = r"""
import json
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro import configs
from repro.models import build
from repro.parallel import sharding as sh
from repro.parallel.plan import ExecutionPlan

def entry(e):
    return None if e is None else (e if isinstance(e, str) else list(e))

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (PartitionSpec, NamedSharding)))[0]
    return {"/".join(sh._key_name(k) for k in path): leaf for path, leaf in leaves}

out = {}
for arch in ARCHS:
    shapes = jax.eval_shape(build(configs.get_reduced(arch)).init, jax.random.PRNGKey(0))
    for label, kw in PLANS.items():
        plan = ExecutionPlan(**kw)
        mesh = Mesh(np.array(jax.devices()[:plan.dp * plan.tp]).reshape(plan.dp, plan.tp),
                    ("data", "model"))
        ospecs = flat(sh.opt_state_specs(shapes, mesh, plan))
        out[f"{arch}|{label}"] = {
            "params": {k: [entry(e) for e in v]
                       for k, v in flat(sh.param_specs(shapes, mesh, plan)).items()},
            "opt": {k: [entry(e) for e in v] for k, v in ospecs.items()},
            "opt_memory": {k: sh.opt_sharding(v, mesh, plan).memory_kind
                           for k, v in ospecs.items()},
            "batch": [entry(e) for e in sh.batch_specs(
                {"tokens": jax.ShapeDtypeStruct(tuple(BATCH), np.int32)}, mesh, plan)["tokens"]],
        }
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    from conftest import run_multidevice

    code = f"PLANS, ARCHS, BATCH = {PLANS!r}, {ARCHS!r}, {[BATCH, SEQ]!r}\n" + REFERENCE_SPECS
    return json.loads(run_multidevice(code, n_devices=4).strip().splitlines()[-1])


def _entries(spec):
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


@pytest.mark.parametrize("label", list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_match_reference(arch, label, reference_specs):
    want = reference_specs[f"{arch}|{label}"]
    plan = ExecutionPlan(**PLANS[label])
    cfg = configs.get_reduced(arch)
    module = family_of(cfg).module(cfg, "meta", nn.dtype_of(cfg.dtype))
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    mesh = {"data": plan.dp, "model": plan.tp}
    n_stack = sh.stack_sizes(shapes)
    for kind, specs in (("params", sh.param_specs(shapes, mesh, plan)),
                        ("opt", sh.opt_state_specs(shapes, mesh, plan))):
        seen = set()
        for name, spec in specs.items():
            path, full_shape = sh.reference_leaf(name, shapes[name], n_stack)
            key = "/".join(path)
            seen.add(key)
            stacked = len(full_shape) == len(spec) + 1
            got = _entries(((None,) + spec) if stacked else spec)
            assert got == want[kind][key], (kind, name, got, want[kind][key])
        assert seen == set(want[kind]), (kind, sorted(seen ^ set(want[kind])))
    for name, spec in sh.opt_state_specs(shapes, mesh, plan).items():
        key = "/".join(sh.reference_leaf(name, shapes[name], n_stack)[0])
        assert sh.opt_sharding(spec, plan).memory_kind == want["opt_memory"][key]
    assert _entries(sh.batch_specs({"tokens": (BATCH, SEQ)}, mesh, plan)["tokens"]) == \
        want["batch"]


@pytest.mark.parametrize("label", ["dp4", "dp2tp2z1"])
def test_logical_axis_rules_match_reference(label):
    """activation_rules feeding logical_to_spec, with and without the
    divisibility check, as the reference's (whose rules read only the mesh's
    axis names)."""
    from types import SimpleNamespace

    from repro.parallel import axes as jaxes
    from repro.parallel import sharding as jsh
    from repro_torch.parallel import axes

    plan = PLANS[label]
    mesh = {"data": plan["dp"], "model": plan.get("tp", 1)}
    jmesh = SimpleNamespace(axis_names=tuple(mesh), shape=mesh)
    rules = sh.activation_rules(mesh, ExecutionPlan(**plan))
    assert rules == jsh.activation_rules(jmesh, JExecutionPlan(**plan))
    cases = [(("batch", "seq", "embed"), (8, 32, 64)), (("batch", "seq", "heads", None),
                                                        (8, 32, 4, 16)),
             (("batch", "kv_heads"), (8, 1)), (("vocab", "embed"), (256, 64))]
    for names, dims in cases:
        for sizes in (None, mesh):
            with axes.logical_axis_rules(rules, sizes), jaxes.logical_axis_rules(rules, sizes):
                want = _entries(tuple(jaxes.logical_to_spec(names, dims)))
                assert _entries(axes.logical_to_spec(names, dims)) == want, (names, sizes)
    assert axes.logical_to_spec(("batch",)) == ()


# ---------------------------------------------------------------------------
# Gloo worlds
# ---------------------------------------------------------------------------

# One rank: restores a checkpoint under the plan, trains, gathers the params
# whole and (rank 0) writes them with the per-step metrics.
WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
args, rank = json.loads(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + args["store"], rank=rank,
                        world_size=args["world"])
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train_batch
from repro_torch.models import ModelOpts, build
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import compile_train_step

cfg = configs.get_reduced(args["arch"]).with_(dtype="float32")
plan = ExecutionPlan(**args["plan"])
model = build(cfg, device="cpu", opts=ModelOpts(loss_chunk=0))
data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=args["seq"],
                                  global_batch=args["batch"], seed=0))
specs = {k: torch.empty(a.shape, device="meta")
         for k, a in train_batch(cfg, data.batch(0), 0).items()}
# One run per mesh shape (dp x tp by default; a tp=1 plan may also lay its
# data parallelism over a "model" axis), each from the same checkpoint.
for m, shape in enumerate(args["meshes"] or [[plan.dp, plan.tp]]):
    mesh = make_mesh(*shape, device="cpu")
    step, p_sh, o_sh, b_sh, params, opt = compile_train_step(model, plan, mesh,
                                                             OptConfig(lr=args["lr"]), specs)
    mgr = CheckpointManager(args["ckpt"], async_save=False)
    params, opt, meta = mgr.restore(params, opt, step=args["from"], layout=step.layout)
    if plan.offload:
        assert {s.memory_kind for s in o_sh["m"].values()} == {"pinned_host"}
        assert all(t.device.type == "cpu" for k in ("m", "v") for t in opt[k].values())
    index, count = step.layout.batch_shard(b_sh["tokens"].spec)
    out = {}
    for i in range(meta["step"], meta["step"] + args["steps"]):
        rows = train_batch(cfg, data.batch(i), i)
        per = args["batch"] // count
        batch = {k: torch.from_numpy(a[index * per:(index + 1) * per]) for k, a in rows.items()}
        batch["tokens"] = batch["tokens"].long()
        params, opt, mt = step(params, opt, batch)
        out[f"loss/{i}"] = mt["loss"].item()
        out[f"grad_norm/{i}"] = mt["grad_norm"].item()
    end = meta["step"] + args["steps"]
    if args["save"]:
        mgr.save(end, params, opt, meta={"plan": plan.strategy}, block=True, layout=step.layout)
    full = step.layout.full_params(params)
    if rank == 0:
        np.savez(args["out"] + (f".mesh{m}" if m else ""),
                 **{k: np.float64(v) for k, v in out.items()},
                 **{"p/" + k: v.numpy() for k, v in full.items()})
dist.destroy_process_group()
"""


def run_world(tmp_path: Path, name: str, arch: str, plan: dict, ckpt: Path, start: int,
              steps: int, save: bool = False, world: int = 4, meshes=None):
    """Run ``WORKER`` on ``world`` gloo ranks; rank 0's results (a list of
    them, one per mesh shape, when ``meshes`` is given)."""
    out = tmp_path / f"{name}.npz"
    args = dict(store=str(tmp_path / f"{name}.store"), world=world, arch=arch, plan=plan,
                batch=BATCH, seq=SEQ, lr=LR, ckpt=str(ckpt), steps=steps, save=save,
                out=str(out), meshes=meshes, **{"from": start})
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, json.dumps(args), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = []
    for m in range(len(meshes or [None])):
        with np.load(f"{out}.mesh{m}.npz" if m else out) as z:
            results.append(dict(z))
    return results if meshes else results[0]


class JaxRun:
    """The single-device JAX run a world is held to: its step-0 checkpoint
    and the loss, grad norm and params after each step; beside it, the
    single-device port's params after each step from the same checkpoint."""

    def __init__(self, arch: str, ga_steps: int, steps: int, ckpt: Path):
        from repro_torch.models import ModelOpts
        from repro_torch.train.optimizer import OptConfig, opt_init
        from repro_torch.train.step import make_train_step

        cfg = jconfigs.get_reduced(arch).with_(dtype="float32")
        self.cfg = configs.get_reduced(arch).with_(dtype="float32")
        self.ckpt = ckpt
        model = jbuild(cfg, JModelOpts(loss_chunk=0))
        optcfg = JOptConfig(lr=LR)
        params = model.init(jax.random.PRNGKey(0))
        opt = jopt_init(params, optcfg)
        JCheckpointManager(ckpt).save(0, params, opt, block=True)
        step = jax.jit(jmake_train_step(model, JExecutionPlan(ga_steps=ga_steps), optcfg))
        port = build(self.cfg, device="cpu", opts=ModelOpts(loss_chunk=0))
        pp = port.load(params_from_jax_numpy(jax.tree.map(np.asarray, params), self.cfg))
        popt = opt_init(pp, OptConfig(lr=LR))
        pstep = make_train_step(port, ExecutionPlan(ga_steps=ga_steps), OptConfig(lr=LR))
        data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                          global_batch=BATCH, seed=0))
        self.loss, self.grad_norm, self.params, self.port_params = [], [], [], []
        for i in range(steps):
            batch = train_batch(self.cfg, data.batch(i), i)
            params, opt, m = step(params, opt, {k: jnp.asarray(a) for k, a in batch.items()})
            self.loss.append(float(m["loss"]))
            self.grad_norm.append(float(m["grad_norm"]))
            self.params.append(params_from_jax_numpy(jax.tree.map(np.asarray, params),
                                                     self.cfg))
            tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
            tbatch["tokens"] = tbatch["tokens"].long()
            pp, popt, _ = pstep(pp, popt, tbatch)
            self.port_params.append({n: t.detach().clone() for n, t in pp.state_dict().items()})


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    cache = {}

    def get(arch: str, ga_steps: int = 1) -> JaxRun:
        if (arch, ga_steps) not in cache:
            ckpt = tmp_path_factory.mktemp(f"jax-{arch}-ga{ga_steps}")
            cache[arch, ga_steps] = JaxRun(arch, ga_steps, 4, ckpt)
        return cache[arch, ga_steps]
    return get


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def check_world(got: dict, ref: JaxRun, steps, metrics: bool = True) -> None:
    for i in steps if metrics else ():
        assert _rel(got[f"loss/{i}"], ref.loss[i]) < TOL_LOSS, (i, got[f"loss/{i}"], ref.loss[i])
        assert _rel(got[f"grad_norm/{i}"], ref.grad_norm[i]) < TOL_LOSS, \
            (i, got[f"grad_norm/{i}"], ref.grad_norm[i])
    want, single = ref.params[steps[-1]], ref.port_params[steps[-1]]
    assert sorted(k[2:] for k in got if k.startswith("p/")) == sorted(want)
    for n, w in want.items():
        bound = TOL_PARAMS + 2 * _rel(single[n].numpy(), w.numpy())
        assert _rel(got["p/" + n], w.numpy()) < bound, (n, bound)


WORLDS = {
    "dp4": ("llama2-7b", {"dp": 4}),
    "dp2tp2z1": ("llama2-7b", {"dp": 2, "tp": 2, "zero_stage": 1}),
    "dp4z3": ("llama2-7b", {"dp": 4, "zero_stage": 3}),
    "tp4": ("llama2-7b", {"tp": 4}),
    "dp2z1off_ga2": ("llama2-7b", {"dp": 2, "zero_stage": 1, "offload": True, "ga_steps": 2}),
    "zamba2_dp4z3": ("zamba2-7b", {"dp": 4, "zero_stage": 3}),
    "rwkv6_dp4z3": ("rwkv6-1.6b", {"dp": 4, "zero_stage": 3}),
    # the modality stubs split with the tokens: frames under ZeRO-3 (each
    # encoder and decoder block its own FSDP2 unit), patches under ZeRO-1
    "seamless_dp2z3": ("seamless-m4t-large-v2", {"dp": 2, "zero_stage": 3}),
    "phi3v_dp2z1": ("phi-3-vision-4.2b", {"dp": 2, "zero_stage": 1}),
}


# Worlds that also run their plan on other mesh shapes, in the same
# processes: dp=4 (tp=1) on a 2 x 2 mesh spans the "model" axis with data
# parallelism, as the reference's batch_axes does.
WORLD_MESHES = {"dp4": [[4, 1], [2, 2]]}


@pytest.mark.parametrize("label", list(WORLDS))
def test_gloo_world_matches_single_device_jax(label, tmp_path, jax_runs):
    arch, plan = WORLDS[label]
    ref = jax_runs(arch, plan.get("ga_steps", 1))
    world = plan.get("dp", 1) * plan.get("tp", 1)
    meshes = WORLD_MESHES.get(label)
    got = run_world(tmp_path, label, arch, plan, ref.ckpt, 0, 3, world=world, meshes=meshes)
    for one in got if meshes else [got]:
        check_world(one, ref, [0, 1, 2])


def test_reconfiguration_across_plans(tmp_path, jax_runs):
    """dp=2 tp=2 ZeRO-1 for 2 steps, a checkpoint, dp=4 ZeRO-3 for 2 more:
    4 single-device JAX steps; the port's checkpoint restores in JAX."""
    ref = jax_runs("llama2-7b")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "step_000000000").symlink_to(ref.ckpt / "step_000000000")
    first = run_world(tmp_path, "a", "llama2-7b", {"dp": 2, "tp": 2, "zero_stage": 1}, ckpt,
                      0, 2, save=True)
    check_world(first, ref, [0, 1])
    second = run_world(tmp_path, "b", "llama2-7b", {"dp": 4, "zero_stage": 3}, ckpt, 2, 2)
    check_world(second, ref, [2, 3])

    jm = jbuild(jconfigs.get_reduced("llama2-7b").with_(dtype="float32"),
                JModelOpts(loss_chunk=0))
    jp = jm.init(jax.random.PRNGKey(1))
    jst = jopt_init(jp, JOptConfig(lr=LR))
    jp, jst, meta = JCheckpointManager(ckpt).restore(jp, jst, step=2)
    assert meta["step"] == 2 and int(jst["count"]) == 2
    restored = params_from_jax_numpy(jax.tree.map(np.asarray, jp), ref.cfg)
    saved = params_from_jax_numpy(read_checkpoint(ckpt / "step_000000002"), ref.cfg)
    for name, t in saved.items():
        assert torch.equal(restored[name], t), name
    check_world({"p/" + n: t.numpy() for n, t in saved.items()}, ref, [1], metrics=False)


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------

# One rank: for each model, compile_prefill and compile_decode_step on a 2 x 2
# mesh under dp=4 (tp=1), this rank's rows of the prompt, a prefill and 3
# greedy decode steps; rank 0 writes the gathered logits.
SERVE_WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
args, rank = json.loads(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + args["store"], rank=rank,
                        world_size=args["world"])
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.serve.engine import compile_decode_step, compile_prefill

plan = ExecutionPlan(dp=4)
mesh = make_mesh(2, 2, device="cpu")
out = {}
for arch, case in args["cases"].items():
    cfg = configs.get_reduced(arch).with_(dtype="float32")
    model = build(cfg, device="cpu")
    state = torch.load(case["state"])
    tokens = torch.from_numpy(np.load(case["tokens"])).long()
    B, S = tokens.shape
    pre = ShapeConfig("serve", case["max_len"], B, "prefill")
    dec = ShapeConfig("serve", case["max_len"], B, "decode")
    pstep, _, c_sh, b_sh, params, cache = compile_prefill(model, plan, mesh, pre, state)
    dstep, *_ = compile_decode_step(model, plan, mesh, dec, state)
    cache, logits = pstep(params, cache, {"tokens": pstep.rows_of(tokens)})
    out[f"{arch}/0"] = logits.numpy()
    out[f"{arch}/spec"] = json.dumps(c_sh["attn" if "attn" in c_sh else "layers"]["k"].spec)
    for i in range(1, 4):
        nxt = logits.argmax(-1)
        cache, logits = dstep(params, cache, dstep.rows_of(nxt))
        out[f"{arch}/{i}"] = logits.numpy()
if rank == 0:
    np.savez(args["out"], **out)
dist.destroy_process_group()
"""

# Reduced llama2-7b at batch 2 (its rows over the "data" axis, each pair of
# "model" ranks holding the same rows: 2 x 2 = 4 does not divide 2), reduced
# zamba2-7b at batch 1 (no axis divides it: its shared attention's KV cache
# is split over the sequence, 8 slots a rank, combined as split-KV decode).
SERVE_CASES = {"llama2-7b": (2, 32), "zamba2-7b": (1, 32)}
SERVE_PROMPT = 12


def test_gloo_serve_world_matches_single_device_jax(tmp_path):
    cases, want = {}, {}
    for arch, (B, max_len) in SERVE_CASES.items():
        cfg = jconfigs.get_reduced(arch).with_(dtype="float32")
        jm = jbuild(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (B, SERVE_PROMPT)).astype(np.int32)
        jc, jl = jax.jit(jm.prefill)(jp, jm.init_cache(B, max_len), {"tokens": jnp.asarray(tokens)})
        want[f"{arch}/0"] = np.asarray(jl)
        step = jax.jit(jm.decode_step)
        for i in range(1, 4):
            jc, jl = step(jp, jc, jnp.argmax(jl, -1).astype(jnp.int32))
            want[f"{arch}/{i}"] = np.asarray(jl)
        tcfg = configs.get_reduced(arch).with_(dtype="float32")
        torch.save(params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg),
                   tmp_path / f"{arch}.pt")
        np.save(tmp_path / f"{arch}.npy", tokens)
        cases[arch] = {"state": str(tmp_path / f"{arch}.pt"),
                       "tokens": str(tmp_path / f"{arch}.npy"), "max_len": max_len}
    out = tmp_path / "serve.npz"
    args = dict(store=str(tmp_path / "serve.store"), world=4, cases=cases, out=str(out))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", SERVE_WORKER, json.dumps(args), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with np.load(out) as z:
        got = dict(z)
    # the placements the cases are there for
    assert json.loads(str(got["llama2-7b/spec"])) == [None, "data", None, None, None]
    assert json.loads(str(got["zamba2-7b/spec"])) == [None, None, ["data", "model"], None, None]
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert _rel(got[key], w) < TOL_LOSS, (key, _rel(got[key], w))


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

REFUSED = {
    "pp": ("llama2-7b", {"pp": 2}, "pipeline parallelism.*ROADMAP A14b"),
    "sp": ("llama2-7b", {"sp": True}, "sequence parallelism.*ROADMAP A14b"),
    "tp hybrid": ("zamba2-7b", {"tp": 2}, "tensor parallelism of the hybrid.*ROADMAP A14b"),
    "tp rwkv6": ("rwkv6-1.6b", {"tp": 2}, "tensor parallelism of the ssm.*ROADMAP A14b"),
    "tp vision": ("phi-3-vision-4.2b", {"tp": 2},
                  "tensor parallelism of the vision decoder.*ROADMAP A14b"),
    "tp encdec": ("seamless-m4t-large-v2", {"dp": 2, "tp": 2},
                  "tensor parallelism of the audio.*ROADMAP A14b"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_plan_fields_raise(case):
    arch, plan, match = REFUSED[case]
    with pytest.raises(NotImplementedError, match=match):
        check_plan(configs.get_reduced(arch), ExecutionPlan(**plan))


def test_tp_that_splits_a_head_raises():
    """gpt2-1.5b: 25 heads of 64; the reference's column split at tp=2 cuts
    its 1,600 columns at 800, inside head 12.  Checked on the config alone."""
    cfg = configs.get("gpt2-1.5b")
    with pytest.raises(NotImplementedError, match=r"layers\.\*\.attn\.wq \(25 heads of 64"):
        check_plan(cfg, ExecutionPlan(tp=2))


MESH_REFUSALS = r"""
import torch, torch.distributed as dist
from repro_torch.launch.mesh import make_mesh, single_device_mesh
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
for call, match in ((lambda: make_mesh(2, 1, device="cpu"), "need 2 ranks, have 1"),
                    (lambda: make_mesh(1, 1), "no CUDA device")):
    try:
        call()
    except (ValueError, RuntimeError) as e:
        assert match in str(e), e
    else:
        raise AssertionError(match)
torch.cuda.is_available = lambda: True
try:
    single_device_mesh()
except RuntimeError as e:
    assert "runs gloo; a cuda mesh needs nccl" in str(e), e
else:
    raise AssertionError("wrong backend accepted")
mesh = make_mesh(1, 1, device="cpu")
assert mesh.mesh_dim_names == ("data", "model") and mesh.device_type == "cpu"
print("OK")
"""


def test_mesh_refuses_a_small_world_a_wrong_backend_and_no_card():
    """The default device is cuda; a world smaller than the mesh and a gloo
    group under a cuda mesh raise (in a subprocess: a process group lives
    for the process)."""
    res = subprocess.run([sys.executable, "-c", MESH_REFUSALS], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert res.returncode == 0 and "OK" in res.stdout, res.stdout + res.stderr


def test_offloaded_moments_are_host_tensors_and_a_failed_pin_raises():
    from repro_torch.train.optimizer import OptConfig, _host_zeros, opt_init

    params = {"a": torch.ones(3, 4), "b": torch.ones(5)}
    state = opt_init(params, OptConfig(), host=True)
    for k in ("m", "v"):
        assert all(t.device.type == "cpu" and not t.is_pinned() for t in state[k].values())
        assert state[k]["a"].shape == (3, 4) and state[k]["b"].untyped_storage().data_ptr() == \
            state[k]["a"].untyped_storage().data_ptr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _host_zeros({"a": (3,)}, torch.float32, pin=True)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_offload_on_the_card_matches_device_moments(cuda_device):
    """Cut llama (head dim 128) on one card: 3 steps under ZeRO-1 + offload
    through compile_train_step on a one-rank NCCL group keep every moment in
    pinned host memory and match 3 steps of make_train_step with the
    moments on the device (losses rel 1e-5, params rel 1e-5)."""
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.step import compile_train_step, make_train_step

    cfg = configs.get("llama2-7b").with_(vocab_size=512, dtype="float32", n_layers=2,
                                         d_model=256, n_heads=2, n_kv_heads=2, d_ff=512)
    model = build(cfg, device=cuda_device)
    mesh = single_device_mesh()
    data = SyntheticTokens(DataConfig(vocab_size=512, seq_len=100, global_batch=2, seed=0))
    optcfg = OptConfig(lr=1e-3)
    specs = {"tokens": torch.empty((2, 100), dtype=torch.long, device="meta")}
    step, _, o_sh, _, params, opt = compile_train_step(
        model, ExecutionPlan(zero_stage=1, offload=True), mesh, optcfg, specs)
    ref = model.load({k: v.detach().clone() for k, v in params.state_dict().items()})
    ref_opt = opt_init(ref, optcfg)
    ref_step = make_train_step(model, ExecutionPlan(), optcfg)
    for i in range(3):
        tokens = torch.from_numpy(data.batch(i)).long().to(cuda_device)
        params, opt, m = step(params, opt, {"tokens": tokens})
        ref, ref_opt, mr = ref_step(ref, ref_opt, {"tokens": tokens})
        assert abs(m["loss"].item() - mr["loss"].item()) <= 1e-5 * abs(mr["loss"].item())
    assert {s.memory_kind for s in o_sh["m"].values()} == {"pinned_host"}
    assert all(t.device.type == "cpu" and t.is_pinned() for k in ("m", "v")
               for t in opt[k].values())
    for (n, p), q in zip(params.named_parameters(), ref.parameters()):
        assert _rel(p.detach().cpu().numpy(), q.detach().cpu().numpy()) < 1e-5, n
