"""The port's dry run against the JAX package's, on the CPU.

* ``core.op_cost`` against ``repro.core.hlo_cost`` on the reference's own
  two programs (``tests/test_infra.py``: a matmul, 2 n^3, and L matmuls, L
  2 n^3, which the port runs as a Python loop and the reference as a scan);
* one train step of reduced llama2-7b and gemma-2b (B 2 x S 256), with
  ``remat`` "none" and "full": the port's aten dot FLOPs equal the
  reference's ``dot_by_tag["other"] + ["backward"]`` on the jitted
  single-device step (relative 1e-9); the attention dots differ by
  construction (the reference's dense schedule against the port's kernel,
  counted by its formula), and the reference's are its dense schedule's to
  the flop, whether tagged "attention" or, as XLA:CPU emits gemma-2b's,
  with no ``op_name`` (which ``default_tag`` would file under "other", so
  the test tags such dots apart); each kernel op's FLOPs equal its formula;
* each registered kernel formula against the kernel module's ``fwd_cost`` /
  ``bwd_cost`` at the main paths' shapes;
* per-kind collective bytes of ``dist.all_reduce`` /
  ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` on a fake 4-rank
  world against ``repro.core.roofline.collective_bytes`` on HLO lines of the
  same shapes;
* ``RooflineReport``'s arithmetic against the reference's on the same
  fields, with the reference's constants swapped for the port's;
* ``cache_specs`` against the reference's on the same cache shapes;
* the same step counted on real CPU tensors and on fake ones (the latter
  as the dry run counts, under its MemTracker): equal counts;
* the dry run's tracker over GA's repeated entries of the root module,
  counting as the counter alone does;
* the twin of ``tests/test_parallel.py::test_dryrun_entry_tiny``: gemma-2b,
  train_4k, dp 4 tp 1 GA 16 on a fake 2 x 2 mesh;
* the ``not_ported`` cells name their ROADMAP item.

Fake process groups live in this process and are torn down after each test.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.core import hlo_cost
from repro.core import roofline as jroofline
from repro.models import ModelOpts as JModelOpts
from repro.models import build as jbuild
from repro.parallel.plan import ExecutionPlan as JExecutionPlan
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import opt_init as jopt_init
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.core import op_cost, roofline
from repro_torch.kernels import flash_attention, ssd_scan, wkv6
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import ModelOpts, build
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.serve.engine import cache_shapes
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.step import make_train_step

B, S = 2, 256


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tensors here are small, and the suite runs
    several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_world():
    """A fake process group, torn down after the test."""
    yield make_fake_mesh
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's two programs
# ---------------------------------------------------------------------------

def test_matmul_counts_like_the_reference():
    n = 128
    c = jax.jit(lambda a, b: a @ b).lower(jnp.zeros((n, n)), jnp.zeros((n, n))).compile()
    want = hlo_cost.analyze_text(c.as_text())
    a, b = torch.zeros(n, n), torch.zeros(n, n)
    _, got = op_cost.count(lambda: a @ b)
    assert got.dot_flops == got.flops == 2 * n ** 3
    assert got.flops == pytest.approx(want.flops, rel=0.01)
    assert got.bytes == 3 * n * n * 4


def test_layer_loop_counts_like_the_scan():
    n, L = 64, 10

    def f(x, w):
        return jax.lax.scan(lambda c, wi: (c @ wi, None), x, w)[0]
    c = jax.jit(f).lower(jnp.zeros((n, n)), jnp.zeros((L, n, n))).compile()
    want = hlo_cost.analyze_text(c.as_text())
    x, w = torch.zeros(n, n), torch.zeros(L, n, n)

    def loop():
        c = x
        for i in range(L):
            c = c @ w[i]
        return c
    _, got = op_cost.count(loop)
    assert got.dot_flops == L * 2 * n ** 3
    assert got.flops == pytest.approx(want.flops, rel=0.05)


# ---------------------------------------------------------------------------
# Train steps: the port's dots against the reference's HLO
# ---------------------------------------------------------------------------

def _reference_dots(arch: str, remat: str) -> dict:
    """``dot_by_tag`` of the reference's jitted single-device step, under
    ``default_tag`` except that a dot whose HLO carries no ``op_name`` is
    tagged "unnamed" (``default_tag`` would call it "other").  The step is
    compiled with the LLVM backend at optimization level 0: the optimized
    HLO that is read has the same dots, and the compile takes a third of
    the CPU time."""
    cfg = jconfigs.get_reduced(arch)
    model = jbuild(cfg, JModelOpts(remat=remat))
    params = model.init(jax.random.PRNGKey(0))
    optcfg = JOptConfig()
    step = jax.jit(jmake_train_step(model, JExecutionPlan(gc=remat == "full"), optcfg))
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
    lowered = step.lower(params, jopt_init(params, optcfg), batch)
    text = lowered.compile({"xla_backend_optimization_level": 0}).as_text()
    tag = lambda meta: hlo_cost.default_tag(meta) if meta else "unnamed"  # noqa: E731
    return dict(hlo_cost.analyze_text(text, tag).dot_by_tag)


def _port_step(arch: str, remat: str, seq: int = S):
    cfg = configs.get_reduced(arch)
    model = build(cfg, device="cpu", opts=ModelOpts(remat=remat))
    params = model.init()
    opt_state = opt_init(params, OptConfig())
    step = make_train_step(model, ExecutionPlan(gc=remat == "full"), OptConfig())
    batch = {"tokens": torch.zeros((B, seq), dtype=torch.long)}
    return cfg, lambda: step(params, opt_state, batch)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["llama2-7b", "gemma-2b"])
def test_train_step_dots_equal_the_reference_hlo(arch, remat):
    want = _reference_dots(arch, remat)
    cfg, run = _port_step(arch, remat)
    _, got = op_cost.count(run)
    ref = want.get("other", 0.0) + want.get("backward", 0.0)
    assert got.dot_flops == pytest.approx(ref, rel=1e-9), (got.dot_flops, want)
    # The reference's attention dots (its dense schedule: every (q, k) pair,
    # QK^T and PV forward, twice that backward, the forward again under
    # remat) are tagged "attention", or carry no op_name at all (gemma-2b's,
    # under XLA:CPU), which default_tag would file under "other".
    L, hd = cfg.n_layers, cfg.resolved_head_dim
    dense = 2.0 * B * cfg.n_heads * S * S * 2 * hd * L * (4 if remat == "full" else 3)
    assert want.get("attention", 0.0) + want.get("unnamed", 0.0) == dense, want
    # the kernel ops: every layer's forward (twice under remat), one backward
    shape = (B, S, S, cfg.n_heads, cfg.n_kv_heads, hd, True, cfg.sliding_window, torch.float32)
    n_fwd = L * (2 if remat == "full" else 1)
    assert got.kernel_calls == {"flash_attention_fwd": n_fwd, "flash_attention_bwd": L}
    assert got.kernel_flops["flash_attention_fwd"] == n_fwd * flash_attention.fwd_cost(*shape)[0]
    assert got.kernel_flops["flash_attention_bwd"] == L * flash_attention.bwd_cost(*shape)[0]


# ---------------------------------------------------------------------------
# The kernel formulas
# ---------------------------------------------------------------------------

def _fake(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype)


# The main paths' shapes (chip_smoke.py's serve and train phases, batch 4 x 512).
FORMULA_CASES = {
    "flash fwd llama2-7b": (lambda: flash_attention.flash_attention_fwd(
        _fake(4, 512, 32, 128), _fake(4, 512, 32, 128), _fake(4, 512, 32, 128)),
        "flash_attention_fwd",
        flash_attention.fwd_cost(4, 512, 512, 32, 32, 128, True, 0, torch.bfloat16)),
    "flash fwd seamless cross": (lambda: flash_attention.flash_attention_fwd(
        _fake(4, 512, 16, 64), _fake(4, 1024, 16, 64), _fake(4, 1024, 16, 64), causal=False),
        "flash_attention_fwd",
        flash_attention.fwd_cost(4, 512, 1024, 16, 16, 64, False, 0, torch.bfloat16)),
    "flash bwd llama2-7b": (lambda: flash_attention.flash_attention_bwd(
        *(_fake(4, 512, 32, 128) for _ in range(4)), _fake(4, 32, 512, dtype=torch.float32),
        _fake(4, 512, 32, 128)), "flash_attention_bwd",
        flash_attention.bwd_cost(4, 512, 512, 32, 32, 128, True, 0, torch.bfloat16)),
    "ssd fwd zamba2-7b": (lambda: ssd_scan.ssd_scan_fwd(
        _fake(4, 512, 112, 64), _fake(4, 512, 112, dtype=torch.float32),
        _fake(112, dtype=torch.float32), _fake(4, 512, 64), _fake(4, 512, 64)),
        "ssd_scan_fwd", ssd_scan.fwd_cost(4, 512, 112, 64, 64, False, torch.bfloat16)),
    "ssd bwd zamba2-7b": (lambda: ssd_scan.ssd_scan_bwd(
        _fake(4, 512, 112, 64), _fake(4, 512, 112, dtype=torch.float32),
        _fake(112, dtype=torch.float32), _fake(4, 512, 64), _fake(4, 512, 64), None,
        _fake(4, 512, 112, 64), None),
        "ssd_scan_bwd", ssd_scan.bwd_cost(4, 512, 112, 64, 64, False, torch.bfloat16)),
    "wkv fwd rwkv6-1.6b": (lambda: wkv6.wkv6_fwd(
        *(_fake(4, 512, 32, 64) for _ in range(3)), _fake(4, 512, 32, 64, dtype=torch.float32),
        _fake(32, 64, dtype=torch.float32)),
        "wkv6_fwd", wkv6.fwd_cost(4, 512, 32, 64, False, torch.bfloat16)),
    "wkv decode rwkv6-1.6b": (lambda: wkv6.wkv6_fwd(
        *(_fake(4, 1, 32, 64) for _ in range(3)), _fake(4, 1, 32, 64, dtype=torch.float32),
        _fake(32, 64, dtype=torch.float32), _fake(4, 32, 64, 64, dtype=torch.float32)),
        "wkv6_fwd", wkv6.fwd_cost(4, 1, 32, 64, True, torch.bfloat16)),
    "wkv bwd rwkv6-1.6b": (lambda: wkv6.wkv6_bwd(
        *(_fake(4, 512, 32, 64) for _ in range(3)), _fake(4, 512, 32, 64, dtype=torch.float32),
        _fake(32, 64, dtype=torch.float32), None, _fake(4, 512, 32, 64, dtype=torch.float32),
        None), "wkv6_bwd", wkv6.bwd_cost(4, 512, 32, 64, False, torch.bfloat16)),
}


@pytest.mark.parametrize("case", list(FORMULA_CASES))
def test_registered_formula_is_the_kernel_modules(case):
    call, name, (flops, _) = FORMULA_CASES[case]
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        with FlopCounterMode(display=False) as fc:
            call()
        _, cost = op_cost.count(call)
    assert fc.get_total_flops() == int(flops)
    assert cost.kernel_flops == {name: flops} and cost.kernel_calls == {name: 1}


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

HLO_LINES = """\
  %ar = f32[128,1024]{1,0} all-reduce(f32[128,1024]{1,0} %x), replica_groups={{0,1,2,3}}
  %ag = f32[512,1024]{1,0} all-gather(f32[128,1024]{1,0} %x), dimensions={0}
  %rs = f32[32,1024]{1,0} reduce-scatter(f32[128,1024]{1,0} %x), dimensions={0}
"""


def test_collective_bytes_follow_the_reference(fake_world):
    fake_world((4,), ("data",))
    want = jroofline.collective_bytes(HLO_LINES)
    with FakeTensorMode():
        x = torch.empty(128, 1024)

        def run():
            dist.all_reduce(x)
            dist.all_gather_into_tensor(torch.empty(512, 1024), x)
            dist.reduce_scatter_tensor(torch.empty(32, 1024), x)
        _, got = op_cost.count(run)
    for kind in ("all-reduce", "all-gather", "reduce-scatter"):
        assert got.coll[kind] == want[kind] > 0, kind
        assert got.coll_calls[kind] == 1
    assert got.coll_bytes == sum(want.values())


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def test_roofline_report_matches_the_reference(monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK_BF16", roofline.PEAK_BF16)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", roofline.NET_BW)
    fields = dict(arch="gemma-2b", shape="train_4k", mesh="16x16", chips=256,
                  hlo_flops=3.1e18, hlo_bytes=7.7e15, coll_bytes=4.4e13,
                  coll_breakdown={"all-reduce": 4e13, "all-gather": 4e12},
                  model_flops=2.5e18, attn_flops=1e17, per_device_peak_bytes=3e10,
                  dot_by_tag={"other": 1e18, "backward": 2e18})
    got, want = roofline.RooflineReport(**fields), jroofline.RooflineReport(**fields)
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck", "t_bound",
                 "useful_ratio", "roofline_fraction"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.row() == want.row()
    # one more regime: collectives bound it
    fields.update(coll_bytes=9e15)
    got, want = roofline.RooflineReport(**fields), jroofline.RooflineReport(**fields)
    assert got.bottleneck == want.bottleneck == "collective"
    assert got.t_bound == want.t_bound


# ---------------------------------------------------------------------------
# Cache placements
# ---------------------------------------------------------------------------

def _ref_cache_specs(arch, batch, max_len, mesh):
    from repro.parallel import sharding as jsh

    jm = jbuild(jconfigs.get_reduced(arch))
    shapes = jax.eval_shape(lambda: jm.init_cache(batch, max_len))
    jmesh = SimpleNamespace(axis_names=tuple(mesh), shape=mesh)
    specs = jsh.cache_specs(shapes, jmesh, JExecutionPlan(dp=256))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(jsh._key_name(k) for k in path): tuple(
        e if e is None or isinstance(e, str) else tuple(e) for e in leaf)
        for path, leaf in flat}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ["llama2-7b", "zamba2-7b", "rwkv6-1.6b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("batch", [128, 32, 1])
def test_cache_specs_match_the_reference(arch, batch):
    mesh = {"data": 16, "model": 16}
    max_len = 512
    model = build(configs.get_reduced(arch), device="cpu")
    got = _flat(sh.cache_specs(cache_shapes(model, batch, max_len), mesh,
                               ExecutionPlan(dp=256)))
    want = _ref_cache_specs(arch, batch, max_len, mesh)
    got = {k: v for k, v in got.items() if k != "pos"}
    assert got == {k: v for k, v in want.items() if k != "pos"}


# ---------------------------------------------------------------------------
# Real and fake tensors give the same count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama2-7b", "zamba2-7b", "rwkv6-1.6b"])
def test_real_and_fake_steps_count_the_same(arch):
    _, run = _port_step(arch, "full", seq=80)      # two SSD chunks, three WKV chunks
    _, real = op_cost.count(run)
    with FakeTensorMode():
        _, run = _port_step(arch, "full", seq=80)
        fake, _ = dryrun.count_step(run)            # as the dry run counts
    assert real.summary() == fake.summary()
    assert real.kernel_calls and real.flops > real.dot_flops > 0


# ---------------------------------------------------------------------------
# The dry run's cells
# ---------------------------------------------------------------------------

def test_dryrun_entry_tiny(fake_world):
    """The entry point itself (fake mesh, fake step, count, roofline) on a
    small mesh: the twin of the reference's test of the same name."""
    mesh = fake_world((2, 2), ("data", "model"))
    row = dryrun.run_cell("gemma-2b", "train_4k", mesh, verbose=False,
                          plan_overrides={"dp": 4, "tp": 1, "ga_steps": 16})
    assert row["status"] == "ok", row
    assert row["hlo_flops"] > 0 and row["coll_bytes"] > 0
    assert row["kernel_calls"] == {"flash_attention_fwd": 2 * 16 * 18,
                                   "flash_attention_bwd": 16 * 18}
    assert row["per_device_peak_bytes"] > 0


def test_step_tracker_takes_repeated_root_entries():
    """GA's micro-steps enter the root module more than once, which a plain
    MemTracker refuses; the dry run's tracker (which overrides two private
    MemTracker methods) tracks the whole step, and its peak holds at least
    the weights, the input and the gradient."""
    lin = torch.nn.Linear(64, 64, bias=False)
    x = torch.zeros(8, 64)

    def micro_steps(n):
        def run():
            lin.weight.grad = None
            for _ in range(n):
                lin(x).sum().backward()
        return run
    one, _ = dryrun.count_step(micro_steps(1), (lin, x))
    two, peak = dryrun.count_step(micro_steps(2), (lin, x))
    assert two.dot_flops == 2 * one.dot_flops == 2 * 2 * (2 * 8 * 64 * 64)  # forward, dW
    assert peak >= (2 * 64 * 64 + 8 * 64) * 4
    _, alone = op_cost.count(micro_steps(2))      # the counter as a mode of its own
    assert two.summary() == alone.summary()


@pytest.mark.parametrize("arch", sorted(dryrun.NOT_PORTED))
def test_not_ported_cells_name_their_roadmap_item(arch, fake_world):
    mesh = fake_world((2, 2), ("data", "model"))
    want = "A8" if arch in ("qwen2-72b", "phi3-medium-14b") else "A14b"
    for shape in ("train_4k", "long_500k"):
        row = dryrun.run_cell(arch, shape, mesh, verbose=False)
        assert row["status"] == "not_ported" and f"ROADMAP {want}" in row["reason"], row


def test_skipped_cells_keep_the_reference_reason(fake_world):
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import shape_applicable as jshape_applicable

    mesh = fake_world((2, 2), ("data", "model"))
    row = dryrun.run_cell("gemma-2b", "long_500k", mesh, verbose=False)
    ok, why = jshape_applicable(jconfigs.get("gemma-2b"), JSHAPES["long_500k"])
    assert not ok and row == {"arch": "gemma-2b", "shape": "long_500k", "mesh": "2x2",
                              "status": "skipped", "reason": why}
