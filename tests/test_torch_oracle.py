"""``repro_torch.core.oracle.TorchMicroOracle`` against the reference's
``JaxMicroOracle``, on the CPU.

* Its constructor's steps (one untimed, then ``steps`` timed, through
  ``make_train_step(model, ExecutionPlan(), OptConfig())`` at batch 4 ×
  seq 64) reach the params of the reference's sequence
  (``repro/core/oracle.py:237-248``), replayed here with JAX from the same
  ``PRNGKey(0)`` weights (carried across by ``convert.params_from_jax_numpy``)
  and the same dummy batch, within tests/test_torch_train.py's f32 gradient
  bound (rel 2e-4; 1e-3 for leaves that start at zero, see TOL_ZERO_INIT),
  on the reduced llama2-7b, zamba2-7b and rwkv6-1.6b in f32.
* ``tokens`` and ``t_fwd_unit`` follow the reference's formula.
* ``measure``: multi-card plans and allocations raise, a plan the memory
  model calls infeasible is ``inf``, another model's profile raises, off the
  card it needs an ``env``, and GA, GC, ZeRO-3 and offload plans give a
  finite positive time and finite losses (the last two on a one-rank gloo
  mesh, in a subprocess: a process group lives for its process).
* ``gpu``: a cut llama (head dim 128, which the kernels take) measured
  under two plans on the card.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.oracle import JaxMicroOracle
from repro.models import ModelOpts as JModelOpts
from repro.models import build as jbuild
from repro.parallel.plan import ExecutionPlan as JExecutionPlan
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import opt_init as jopt_init
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.convert import params_from_jax_numpy
from repro_torch.core.oracle import TorchMicroOracle
from repro_torch.core import oracle as toracle
from repro_torch.core.perfmodel import Alloc, Env, ModelProfile, env_for_gpu
from repro_torch.models.api import Model
from repro_torch.parallel.plan import ExecutionPlan

SRC = Path(__file__).resolve().parents[1] / "src"
BATCH, SEQ, STEPS = 4, 64, 3
TOL_PARAMS = 2e-4                # tests/test_torch_train.py's f32 gradient bound
# A leaf that starts at zero (norm offsets, zamba2's dt_bias) holds nothing
# but the 4 AdamW steps, and AdamW divides each element's moment by its own
# RMS: an element whose gradients nearly cancel across steps carries the two
# frameworks' gradient rounding (2e-4 of the leaf's largest gradient) into a
# step-sized share of its value.  Such leaves are held at 1e-3 of their
# largest element; one step more or less, or another learning rate, moves
# them by about a quarter of it.
TOL_ZERO_INIT = 1e-3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _f32(arch):
    return (configs.get_reduced(arch).with_(dtype="float32"),
            jconfigs.get_reduced(arch).with_(dtype="float32"))


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", ["llama2-7b", "zamba2-7b", "rwkv6-1.6b"])
def test_micro_oracle_steps_reach_reference_params(arch, monkeypatch):
    cfg, jcfg = _f32(arch)
    jm = jbuild(jcfg, JModelOpts(loss_chunk=0))
    jp = jm.init(jax.random.PRNGKey(0))
    jbatch = jm.dummy_batch(JShapeConfig("micro", SEQ, BATCH, "train"))
    start = params_from_jax_numpy(jax.tree.map(np.asarray, jp), cfg)
    tokens = torch.from_numpy(np.array(jbatch["tokens"])).long()

    # the reference's sequence: one step, then STEPS more
    jo = jopt_init(jp, JOptConfig())
    step = jax.jit(jmake_train_step(jm, JExecutionPlan(), JOptConfig()))
    for _ in range(1 + STEPS):
        jp, jo, _ = step(jp, jo, jbatch)
    want = params_from_jax_numpy(jax.tree.map(np.asarray, jp), cfg)

    # the port's oracle from the same weights and batch; the module it
    # trains is kept here (its steps update it in place)
    held = {}

    def init(self):
        held["params"] = self.load(start)
        return held["params"]

    monkeypatch.setattr(Model, "init", init)
    monkeypatch.setattr(Model, "dummy_batch", lambda self, shape: {"tokens": tokens})
    oracle = TorchMicroOracle(cfg, BATCH, SEQ, STEPS, device="cpu")
    assert math.isfinite(oracle.t_step) and oracle.t_step > 0
    got = {n: p.detach() for n, p in held["params"].named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert not torch.equal(got[name], start[name]), name
        bound = TOL_PARAMS if start[name].any() else TOL_ZERO_INIT
        assert _rel(got[name].numpy(), w.numpy()) < bound, name


@pytest.fixture(scope="module")
def llama_oracle():
    cfg = configs.get_reduced("llama2-7b").with_(dtype="float32")
    return cfg, TorchMicroOracle(cfg, BATCH, SEQ, STEPS, device="cpu", env=env_for_gpu("h100"))


def test_tokens_and_t_fwd_unit_follow_reference_formula(llama_oracle):
    _, oracle = llama_oracle
    assert oracle.tokens == BATCH * SEQ
    for k_bwd in (1.0, 2.0, 3.5):
        # the reference's method, run on this oracle's measured step
        assert oracle.t_fwd_unit(k_bwd) == JaxMicroOracle.t_fwd_unit(oracle, k_bwd)
    assert oracle.t_fwd_unit() == oracle.t_step / (BATCH * SEQ * 3.2)


def test_micro_oracle_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchMicroOracle(configs.get_reduced("llama2-7b"))


@pytest.mark.parametrize("plan,alloc", [(ExecutionPlan(dp=2), Alloc(2, 24)),
                                        (ExecutionPlan(tp=2), Alloc(2, 24)),
                                        (ExecutionPlan(), Alloc(2, 24))],
                         ids=["dp2", "tp2", "alloc2"])
def test_measure_refuses_multi_card(llama_oracle, plan, alloc):
    cfg, oracle = llama_oracle
    prof = ModelProfile.from_config(cfg, seq=32, batch=4)
    with pytest.raises(NotImplementedError, match="A14b"):
        oracle.measure(prof, plan, alloc)


def test_measure_infeasible_is_inf_and_other_model_raises(llama_oracle):
    cfg, oracle = llama_oracle
    prof = ModelProfile.from_config(cfg, seq=32, batch=4)
    assert oracle.measure(prof, ExecutionPlan(), Alloc(1, 12), env=Env(gpu_mem=1e6)) == math.inf
    assert oracle.measure(prof, ExecutionPlan(ga_steps=3), Alloc(1, 12)) == math.inf
    other = ModelProfile.from_config(configs.get_reduced("gpt2-1.5b"), seq=32, batch=4)
    with pytest.raises(ValueError, match="gpt2-1.5b"):
        oracle.measure(other, ExecutionPlan(), Alloc(1, 12))


def test_measure_off_card_needs_env(llama_oracle):
    """On the CPU no memory model is derived: measure asks for an env, and
    takes one per call as well as from the constructor."""
    cfg, oracle = llama_oracle
    prof = ModelProfile.from_config(cfg, seq=32, batch=4)
    assert toracle._device_env(torch.device("cpu")) is None
    bare = object.__new__(TorchMicroOracle)
    bare.cfg, bare.device, bare.env = cfg, torch.device("cpu"), None
    with pytest.raises(ValueError, match="env"):
        bare.measure(prof, ExecutionPlan(), Alloc(1, 12))
    assert bare.measure(prof, ExecutionPlan(), Alloc(1, 12), env=Env(gpu_mem=1e6)) == math.inf


def test_release_pinned_cache_names_torch_version(monkeypatch):
    """With neither host-cache API present the release raises, naming the
    torch version, instead of an AttributeError."""
    monkeypatch.delattr(torch.accelerator, "empty_host_cache", raising=False)
    monkeypatch.delattr(torch._C, "_host_emptyCache", raising=False)
    with pytest.raises(RuntimeError, match=torch.__version__.replace("+", r"\+")):
        toracle._release_pinned_cache()
    called = []
    monkeypatch.setattr(torch._C, "_host_emptyCache", lambda: called.append(1), raising=False)
    toracle._release_pinned_cache()
    assert called == [1]


MEASURED = {"plain": {}, "ga2": {"ga_steps": 2}, "gc": {"gc": True},
            "zero3_gc": {"zero_stage": 3, "gc": True},
            "offload": {"zero_stage": 1, "offload": True},
            "offload_ga2_gc": {"zero_stage": 1, "offload": True, "ga_steps": 2, "gc": True}}


@pytest.fixture(scope="module")
def measured():
    """Every plan of MEASURED timed by one oracle in a subprocess, whose
    ZeRO-3 and offload plans start a one-rank gloo group."""
    code = (
        "import json\n"
        "from repro_torch import configs\n"
        "from repro_torch.core.oracle import TorchMicroOracle\n"
        "from repro_torch.core.perfmodel import Alloc, ModelProfile, env_for_gpu\n"
        "from repro_torch.parallel.plan import ExecutionPlan\n"
        "import torch.distributed as dist\n"
        "cfg = configs.get_reduced('llama2-7b').with_(dtype='float32')\n"
        "o = TorchMicroOracle(cfg, 2, 16, 2, device='cpu', env=env_for_gpu('h100'))\n"
        "prof = ModelProfile.from_config(cfg, seq=32, batch=4)\n"
        f"plans = {MEASURED!r}\n"
        "out = {}\n"
        "for k, kw in plans.items():\n"
        "    t = o.measure(prof, ExecutionPlan(**kw), Alloc(1, 12))\n"
        "    out[k] = {'t': t, 'steps': len(o.last['step_s']), 'loss': o.last['loss'],\n"
        "              'pinned': o.last['pinned_host_bytes'],\n"
        "              'group': dist.is_initialized() and dist.get_world_size()}\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("plan", sorted(MEASURED))
def test_measure_times_one_card_plans(measured, plan):
    got = measured[plan]
    assert math.isfinite(got["t"]) and got["t"] > 0 and got["steps"] == 2
    assert len(got["loss"]) == 2 and all(map(math.isfinite, got["loss"]))
    assert got["pinned"] == 0          # moments on the CPU are not pinned
    if MEASURED[plan].get("offload") or MEASURED[plan].get("zero_stage") == 3:
        assert got["group"] == 1       # the one-rank gloo group was started


@pytest.mark.gpu
def test_measure_cut_llama_on_card(cuda_device):
    """A cut llama (2 layers, d_model 256, 2 heads of 128) measured under
    two plans on the card: finite positive times and peaks, and the second
    plan (GC) at a lower peak than the first."""
    cfg = configs.get("llama2-7b").with_(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2,
                                         d_ff=512)
    oracle = TorchMicroOracle(cfg, 2, 256, 2, device=cuda_device)
    assert oracle.t_step > 0
    prof = ModelProfile.from_config(cfg, seq=1024, batch=8)
    peaks = []
    for plan in (ExecutionPlan(), ExecutionPlan(gc=True)):
        t = oracle.measure(prof, plan, Alloc(1, 12))
        assert math.isfinite(t) and t > 0
        peaks.append(oracle.last["peak_device_bytes"])
    assert 0 < peaks[1] < peaks[0]
