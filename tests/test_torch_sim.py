"""The port's cluster simulator (``repro_torch.core.simulator``) and
baselines against the reference's ``repro.core``, on the CPU.

Each scenario is built by each package from its own modules (the two
packages' dataclasses are distinct types), with the same fitted params in
both fit caches: the reference's fit of every model type in the trace,
converted field by field.  The port's ``SimResult`` must equal the
reference's field by field, exactly (per-job JCTs, makespan, every
counter, paused seconds, per-class JCTs), on:

* ``generate(n_jobs=50, hours=4, seed=2)`` and ``(seed=3, load_scale=3.0,
  large_fraction=0.6)`` on ``Cluster(n_nodes=8)`` under all seven
  ``baselines.ALL`` schedulers, in both engines;
* a heterogeneous trace on an a800 / v100 / a100-40g cluster;
* a ``failure_storm`` + ``spot_churn`` run (both recovery policies);
* a ``degradation_storm`` run with a ``HealthMonitor`` and ``FlakyOps``;
* a drifting analytic oracle feeding a ``CalibrationManager``: the refits
  match at relative 1e-9 (the two fit engines agree to that, not bit for
  bit), so floats are held at 1e-9 and the rest exactly.

The reference's incremental-vs-full JCT fault (ROADMAP Quirks) is not a
property here: the copy is held to the reference's outputs.

Then the port's ``TorchMicroOracle`` drives a two-job simulation on a
one-GPU node (a reduced gpt2 on the CPU, in a subprocess with its one-rank
gloo group): both jobs finish, only one-card plans are measured, and a cold
``_prefit`` raises ``NotImplementedError`` (its profiling set holds
multi-card plans).  ``gpu``: the same on the card with gpt2-1.5b cut in
depth and width.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro import calibration as jcal
from repro import health as jhealth
from repro.core import baselines as jbaselines
from repro.core import cluster as jcluster
from repro.core import oracle as joracle
from repro.core import perfmodel as jpm
from repro.core import sensitivity as jsens
from repro.core import simulator as jsimulator
from repro.core import trace as jtrace
from repro.core.fitting import fit_batch as jfit_batch
from repro_torch import calibration as tcal
from repro_torch import health as thealth
from repro_torch.core import baselines as tbaselines
from repro_torch.core import cluster as tcluster
from repro_torch.core import oracle as toracle
from repro_torch.core import perfmodel as tpm
from repro_torch.core import sensitivity as tsens
from repro_torch.core import simulator as tsimulator
from repro_torch.core import trace as ttrace

SRC = Path(__file__).resolve().parents[1] / "src"
REF = SimpleNamespace(baselines=jbaselines, cluster=jcluster, oracle=joracle, pm=jpm,
                      sens=jsens, sim=jsimulator, trace=jtrace, health=jhealth, cal=jcal)
PORT = SimpleNamespace(baselines=tbaselines, cluster=tcluster, oracle=toracle, pm=tpm,
                       sens=tsens, sim=tsimulator, trace=ttrace, health=thealth, cal=tcal)
SCHEDULERS = sorted(jbaselines.ALL)
HET_SPEC = [("a800", 2), ("v100", 1), ("a100-40g", 1)]
RTOL_REFIT = 1e-9
_FITS: dict = {}     # fit_key -> (reference FitParams, port FitParams)


def _plain(x):
    """Dataclasses as dicts, recursively (the flight recorder left out), so
    that the two packages' values compare by content."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "telemetry"}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _fit_caches(ref_jobs) -> tuple[dict, dict]:
    """Fit caches for both packages holding the reference's fit of every
    model type of ``ref_jobs`` (``profiling_requests`` + ``fit_batch``, as
    the reference's ``_prefit`` does), so that neither simulator fits."""
    missing = {jpm.fit_key(j.profile): j.profile for j in ref_jobs}
    missing = {k: p for k, p in missing.items() if k not in _FITS}
    if missing:
        reqs, skipped = joracle.profiling_requests(list(missing.values()),
                                                   joracle.AnalyticOracle())
        fitted = [(r.profile, k) for r, k in zip(reqs, jfit_batch(reqs))]
        fitted += [(p, jpm.FitParams()) for p, _ in skipped]
        for p, k in fitted:
            _FITS[jpm.fit_key(p)] = (k, tpm.FitParams(**dataclasses.asdict(k)))
    keys = {jpm.fit_key(j.profile) for j in ref_jobs}
    return ({k: _FITS[k][0] for k in keys}, {k: _FITS[k][1] for k in keys})


def _world(ns, scenario: str):
    """(cluster, jobs, Simulator keywords, run keywords) of one scenario,
    built from one package's modules."""
    if scenario == "seed2":
        return (ns.cluster.Cluster(n_nodes=8),
                ns.trace.generate(n_jobs=50, hours=4, seed=2, load_scale=1.0), {}, {})
    if scenario == "seed3":
        return (ns.cluster.Cluster(n_nodes=8),
                ns.trace.generate(n_jobs=50, hours=4, seed=3, load_scale=3.0,
                                  large_fraction=0.6), {}, {})
    if scenario == "hetero":
        return (ns.cluster.hetero_cluster(HET_SPEC),
                ns.trace.generate(n_jobs=30, hours=4, seed=5, variant="hetero", load_scale=2.0,
                                  gpu_types=[t for t, _ in HET_SPEC]), {}, {})
    if scenario == "capacity":
        cluster = ns.cluster.Cluster(n_nodes=5)
        spot = cluster.add_spot_nodes(1)
        cap = (ns.trace.failure_storm(5, 86400.0, seed=5, mtbf_s=6 * 3600.0, mttr_s=1800.0,
                                      storm=(3600.0, 5 * 3600.0, 8.0))
               + ns.trace.spot_churn(spot, 86400.0, seed=6, period_s=6 * 3600.0,
                                     window_frac=0.5, jitter_s=600.0))
        return (cluster, ns.trace.philly(n_jobs=20, hours=4, seed=4, load_scale=3.0,
                                         variant="base"),
                {"capacity": cap}, {"max_time": 4 * 86400.0})
    if scenario == "gray":
        deg = ns.trace.degradation_storm(4, 86400.0, seed=10, mtbd_s=4 * 3600.0,
                                         mttr_s=2 * 3600.0, slowdown=(3.0, 6.0),
                                         storm=(0.0, 8 * 3600.0, 4.0))
        cap = ns.trace.failure_storm(4, 86400.0, seed=16, mtbf_s=12 * 3600.0, mttr_s=1800.0)
        return (ns.cluster.Cluster(n_nodes=4),
                ns.trace.philly(n_jobs=14, hours=4, seed=7, load_scale=3.0, variant="base"),
                {"capacity": cap, "degradation": deg, "health": ns.health.HealthMonitor(),
                 "flaky": ns.health.FlakyOps(ns.health.FlakyConfig(fail_p=0.5, seed=2))},
                {"max_time": 4 * 86400.0})
    if scenario == "drift":
        cal = ns.cal.CalibrationManager(detector=ns.cal.DriftDetector(ns.cal.DriftConfig(
            threshold=0.05, min_observations=6, cooldown_s=3600.0)))
        return (ns.cluster.Cluster(n_nodes=4),
                ns.trace.generate(n_jobs=20, hours=3, seed=8, load_scale=2.0),
                {"oracle": ns.oracle.AnalyticOracle(drifting=True, drift_tau=7200.0),
                 "calibration": cal, "telemetry_interval": 300.0},
                {"max_time": 3 * 86400.0})
    raise KeyError(scenario)


def _simulate(ns, scenario: str, sched_name: str, mode: str, fit_cache: dict,
              recovery: str | None = None, sched_kw: dict | None = None):
    cluster, jobs, sim_kw, run_kw = _world(ns, scenario)
    sched = ns.baselines.ALL[sched_name](**(sched_kw or {}))
    if recovery is not None:
        sched.cfg.recovery = recovery
    sim = ns.sim.Simulator(cluster, sched, fit_cache=fit_cache, mode=mode, **sim_kw)
    return sim.run(jobs, **run_kw), sim


def _both(scenario: str, sched_name: str, mode: str, **kw):
    """The reference's and the port's result of one scenario, from fresh
    curve caches and the same fits."""
    ref_fits, port_fits = _fit_caches(_world(REF, scenario)[1])
    out = []
    for ns, fits in ((REF, ref_fits), (PORT, port_fits)):
        ns.sens.CURVES.clear()
        cache = dict(fits)
        res, sim = _simulate(ns, scenario, sched_name, mode, cache, **kw)
        assert cache.keys() == fits.keys(), "a model type was fitted inside the run"
        out.append((res, sim))
    return out


def _same(got, want, rtol: float = 0.0, path="") -> list[str]:
    """Paths where two plain values differ: floats at ``rtol``, the rest
    exactly."""
    if isinstance(want, dict):
        if got.keys() != want.keys():
            return [f"{path}: keys {sorted(got)} != {sorted(want)}"]
        return [e for k in want for e in _same(got[k], want[k], rtol, f"{path}.{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [f"{path}: {len(got)} items, want {len(want)}"]
        return [e for i, (g, w) in enumerate(zip(got, want))
                for e in _same(g, w, rtol, f"{path}[{i}]")]
    if isinstance(want, float) and rtol:
        ok = got == want or math.isclose(got, want, rel_tol=rtol, abs_tol=0.0)
        return [] if ok else [f"{path}: {got!r} != {want!r}"]
    return [] if got == want and type(got) is type(want) else [f"{path}: {got!r} != {want!r}"]


def _assert_equal(ref, port, rtol: float = 0.0) -> None:
    bad = _same(_plain(port), _plain(ref), rtol)
    assert not bad, bad[:8]
    assert port.summary().keys() == ref.summary().keys()


@pytest.mark.parametrize("mode", ["event", "discrete"])
@pytest.mark.parametrize("sched_name", SCHEDULERS)
@pytest.mark.parametrize("scenario", ["seed2", "seed3"])
def test_simresult_matches_reference(scenario, sched_name, mode):
    (ref, _), (port, _) = _both(scenario, sched_name, mode)
    _assert_equal(ref, port)
    assert len(port.jcts) == 50


@pytest.mark.parametrize("mode", ["event", "discrete"])
@pytest.mark.parametrize("sched_name", ["rubick", "sia", "synergy", "antman"])
def test_hetero_trace_matches_reference(sched_name, mode):
    (ref, _), (port, psim) = _both("hetero", sched_name, mode)
    _assert_equal(ref, port)
    assert port.jcts and psim.cluster.is_hetero


@pytest.mark.parametrize("mode", ["event", "discrete"])
@pytest.mark.parametrize("sched_name,recovery", [("rubick", "shrink"), ("rubick", "kill"),
                                                 ("sia", "shrink"), ("synergy", "shrink")])
def test_capacity_churn_matches_reference(sched_name, recovery, mode):
    (ref, _), (port, _) = _both("capacity", sched_name, mode, recovery=recovery)
    _assert_equal(ref, port)
    assert port.n_cap_events > 0
    assert port.n_shrink_recover + port.n_kill_requeue > 0


@pytest.mark.parametrize("mode", ["event", "discrete"])
@pytest.mark.parametrize("engine", ["incremental", "full"])
def test_degradation_storm_matches_reference(engine, mode):
    (ref, rsim), (port, psim) = _both("gray", "rubick", mode,
                                      sched_kw={"pass_engine": engine})
    _assert_equal(ref, port)
    assert port.n_degrade_events > 0 and port.n_quarantined > 0
    assert port.n_op_retries > 0
    hm, jhm = psim.health, rsim.health
    assert (hm.n_blames, hm.n_releases) == (jhm.n_blames, jhm.n_releases)
    assert _plain(hm.ledger) == _plain(jhm.ledger)
    assert (psim.flaky.n_retries, psim.flaky.n_rollbacks) == \
        (rsim.flaky.n_retries, rsim.flaky.n_rollbacks)


@pytest.mark.parametrize("mode", ["event", "discrete"])
def test_drifting_oracle_with_calibration_matches_reference(mode):
    (ref, rsim), (port, psim) = _both("drift", "rubick", mode)
    _assert_equal(ref, port, rtol=RTOL_REFIT)
    assert port.n_refits > 0
    got = [(r.profile.name, r.version, r.t) for r in psim.calibration.history]
    assert got == [(r.profile.name, r.version, r.t) for r in rsim.calibration.history]
    for r, jr in zip(psim.calibration.history, rsim.calibration.history):
        assert not _same(list(r.new.as_vector()), list(jr.new.as_vector()), RTOL_REFIT)


def test_summary_matches_reference():
    (ref, _), (port, _) = _both("gray", "rubick", "event")
    assert port.summary() == ref.summary()
    assert {"n_cap_events", "n_degrade_events", "n_quarantined", "n_op_retries",
            "avg_jct_guaranteed_h"} <= port.summary().keys()


# ---------------------------------------------------------------------------
# TorchMicroOracle driving the simulator: one-card plans only
# ---------------------------------------------------------------------------

SIMULATE = r"""
import json, sys
import torch
from repro_torch import configs
from repro_torch.core.cluster import Cluster, Job
from repro_torch.core.oracle import TorchMicroOracle
from repro_torch.core.perfmodel import FitParams, ModelProfile, env_for_gpu, fit_key
from repro_torch.core.baselines import ALL
from repro_torch.core.simulator import Simulator
from repro_torch.parallel.plan import ExecutionPlan

device, full = sys.argv[1], sys.argv[2] == "cut"
if full:
    cfg = configs.get("gpt2-1.5b").with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                                         d_ff=1024)
    batch, seq, micro = 8, 512, (4, 128)
else:
    cfg = configs.get_reduced("gpt2-1.5b").with_(dtype="float32")
    batch, seq, micro = 4, 32, (2, 16)
env = env_for_gpu("h100")
profile = ModelProfile.from_config(cfg, seq=seq, batch=batch)
oracle = TorchMicroOracle(cfg, *micro, steps=1, device=device, env=env)


class Asked:
    def __init__(self, oracle):
        self.oracle, self.table = oracle, {}

    def measure(self, profile, plan, alloc, seed=0, env=None, now=0.0):
        key = (plan, alloc)
        if key not in self.table:
            self.table[key] = self.oracle.measure(profile, plan, alloc, env=env)
        return self.table[key]


memo = Asked(oracle)
static = ExecutionPlan(zero_stage=1, offload=True, gc=True)
jobs = [Job(name=f"J{i}", profile=profile, submit=30.0 * i, target_iters=200.0, req_gpus=1,
            req_cpus=12, orig_plan=static, guaranteed=True) for i in range(2)]
out = {}
for name in ("rubick", "rubick-n"):
    sim = Simulator(Cluster(n_nodes=1, gpus_per_node=1, cpus_per_node=12), ALL[name](env=env),
                    oracle=memo, env=env, reconfig_cost=5.0,
                    fit_cache={fit_key(profile): FitParams()})
    res = sim.run(jobs)
    out[name] = {"jcts": res.jcts, "makespan": res.makespan,
                 "plans": {s.job.name: [s.plan.n_gpus, s.plan.strategy, s.alloc.gpus]
                           for s in sim.last_states}}
out["asked"] = [[p.n_gpus, p.strategy, a.gpus, t] for (p, a), t in memo.table.items()]
cold = Simulator(Cluster(n_nodes=1, gpus_per_node=1, cpus_per_node=12), ALL["rubick"](env=env),
                 oracle=oracle, env=env)
try:
    cold._prefit(jobs)
    out["prefit"] = "no error"
except NotImplementedError as e:
    out["prefit"] = "NotImplementedError: " + str(e)
print(json.dumps(out))
"""


def _simulate_with_micro_oracle(device: str, size: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", SIMULATE, device, size], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def _check_micro_run(got: dict) -> None:
    for name in ("rubick", "rubick-n"):
        run = got[name]
        assert sorted(run["jcts"]) == ["J0", "J1"], run
        assert all(math.isfinite(t) and t > 0 for t in run["jcts"].values())
        assert math.isfinite(run["makespan"])
        assert all(p[0] == 1 and p[2] == 1 for p in run["plans"].values()), run
    assert {p[1] for p in got["rubick-n"]["plans"].values()} == {"ZeRO-Offload+GC"}
    assert got["asked"] and all(n == 1 and g == 1 for n, _, g, _ in got["asked"])
    assert all(math.isfinite(t) and t > 0 for *_, t in got["asked"])
    assert got["prefit"].startswith("NotImplementedError") and "GPU" in got["prefit"]


def test_micro_oracle_drives_a_one_card_simulation_on_cpu():
    _check_micro_run(_simulate_with_micro_oracle("cpu", "reduced"))


@pytest.mark.gpu
def test_micro_oracle_drives_a_one_card_simulation_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check_micro_run(_simulate_with_micro_oracle("cuda", "cut"))
