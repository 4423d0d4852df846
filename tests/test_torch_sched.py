"""The port's scheduling stack against the reference's, on the CPU.

``repro_torch.core.{cluster,sensitivity,scheduler,trace}`` and the analytic
oracle's drift and batched methods are copies of ``repro.core``'s; each is
held to the reference on the same inputs, computed in this process:

* curves: for every Table 2 profile under the reference's fit of its
  analytic profiling samples, on the A800 ``Env`` and on an ``Env`` with
  the port's ``h100`` fields, both curve engines: envelope, best plan,
  both GPU slopes, the CPU slope, ``best_plan_at_most``, ``min_resources``
  and ``grow_target`` at every g <= 16 (relative 1e-12);
* traces: ``generate`` (every variant), ``philly`` and the capacity and
  degradation streams, equal for 3 seeds;
* the scheduler: three traces (a homogeneous and a heterogeneous cluster of
  32 GPUs, and a quota trace) driven pass by pass through arrivals,
  completions, one capacity loss handled by ``recover`` and one refit,
  under both pass engines and both curve engines; after every pass each
  job's status, plan, alloc, placement, minRes, baseline and
  reconfiguration count equal the reference's;
* the oracle's additions (``true_params_at``, drifting ``measure``,
  ``measure_batch``, ``throughput_batch``, ``true_curve``), exactly.

The reference's two known faults (ROADMAP Quirks: ``fit_batch`` above the
scalar fit, and the incremental pass engine apart from the full one on
some draws) are not properties here: the copies are held to the
reference's outputs on fixed inputs, faults included.

Then the mechanism ``chip_smoke.py``'s ``schedule`` phase runs on the card,
on a reduced gpt2-1.5b on the CPU (a one-rank gloo group in a subprocess):
two steps under ZeRO-Offload + GC, a checkpoint, a restore under the plain
plan that is bit-equal, two more steps, against four uninterrupted steps.
A sanitized scheduler (the config flag or ``REPRO_SANITIZE``) decides as an
unsanitized one.  ``gpu``: the same on a cut gpt2 on the card, with the plan
a scheduler pass picks.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import cluster as jcluster
from repro.core import oracle as joracle
from repro.core import paper_models as jpaper
from repro.core import perfmodel as jpm
from repro.core import scheduler as jscheduler
from repro.core import sensitivity as jsens
from repro.core import trace as jtrace
from repro.core.fitting import fit_batch as jfit_batch
from repro.parallel import plan as jplan
from repro.parallel import plan_table as jplan_table
from repro_torch.core import cluster as tcluster
from repro_torch.core import oracle as toracle
from repro_torch.core import paper_models as tpaper
from repro_torch.core import perfmodel as tpm
from repro_torch.core import scheduler as tscheduler
from repro_torch.core import sensitivity as tsens
from repro_torch.core import trace as ttrace
from repro_torch.parallel import plan as tplan
from repro_torch.parallel import plan_table as tplan_table

SRC = Path(__file__).resolve().parents[1] / "src"
PROFILES = sorted(tpaper.TABLE2)
RTOL = 1e-12
G_MAX = 16
SEEDS = (0, 1, 2)
REF = SimpleNamespace(cluster=jcluster, scheduler=jscheduler, trace=jtrace, pm=jpm,
                      plan=jplan, sens=jsens, paper=jpaper)
PORT = SimpleNamespace(cluster=tcluster, scheduler=tscheduler, trace=ttrace, pm=tpm,
                       plan=tplan, sens=tsens, paper=tpaper)


def _plain(x):
    """Dataclasses as dicts, recursively, so that the two packages' values
    compare by content."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _close(got: float, want: float) -> bool:
    return got == want or math.isclose(got, want, rel_tol=RTOL, abs_tol=0.0)


@pytest.fixture(scope="module")
def fits():
    """The reference's fit of each Table 2 profile to its analytic
    profiling samples (``profiling_requests`` + ``fit_batch``; default
    ``FitParams`` where too few samples are feasible), as each package's
    ``FitParams``."""
    reqs, skipped = joracle.profiling_requests(list(jpaper.TABLE2.values()),
                                               joracle.AnalyticOracle())
    vals = {r.profile.name: k for r, k in zip(reqs, jfit_batch(reqs))}
    vals.update((p.name, jpm.FitParams()) for p, _ in skipped)
    return {name: (k, tpm.FitParams(**dataclasses.asdict(k))) for name, k in vals.items()}


def _envs(name: str):
    """(port Env, reference Env) pairs the curves are held on."""
    h100 = tpm.env_for_gpu("h100")
    return {"a800": (tpm.Env(), jpm.Env()),
            "h100": (h100, jpm.Env(**dataclasses.asdict(h100)))}[name]


def _point(pt) -> tuple:
    return (pt.gpus, _plain(pt.plan), pt.throughput)


def _same_point(got, want) -> bool:
    return got[:2] == want[:2] and _close(got[2], want[2])


# ---------------------------------------------------------------------------
# Sensitivity curves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["batch", "scalar"])
@pytest.mark.parametrize("env_name", ["a800", "h100"])
@pytest.mark.parametrize("name", PROFILES)
def test_curve_matches_reference(name, env_name, engine, fits):
    env, jenv = _envs(env_name)
    k, jk = fits[name][1], fits[name][0]
    tsens.CURVES.clear()
    jsens.CURVES.clear()
    c = tsens.get_curve(tpaper.TABLE2[name], k, env, max_gpus=G_MAX, engine=engine)
    jc = jsens.get_curve(jpaper.TABLE2[name], jk, jenv, max_gpus=G_MAX, engine=engine)
    e, je = c.materialize(), jc.materialize()
    np.testing.assert_allclose(e.exact, je.exact, rtol=RTOL, atol=0)
    np.testing.assert_allclose(e.env, je.env, rtol=RTOL, atol=0)
    assert e.env_g.tolist() == je.env_g.tolist()
    assert _plain(e.plans) == _plain(je.plans)
    bad = []
    for g in range(0, G_MAX + 2):
        scalars = {"throughput": (c.throughput(g), jc.throughput(g)),
                   "throughput_cpus": (c.throughput(g, 6 * g), jc.throughput(g, 6 * g)),
                   "slope_gpu": (c.slope_gpu(g), jc.slope_gpu(g)),
                   "slope_gpu_down": (c.slope_gpu_down(g), jc.slope_gpu_down(g)),
                   "slope_cpu": (c.slope_cpu(g, 12 * g), jc.slope_cpu(g, 12 * g)),
                   "grow_target": (c.grow_target(g, G_MAX), jc.grow_target(g, G_MAX))}
        bad += [(g, key, got, want) for key, (got, want) in scalars.items()
                if not _close(got, want)]
        points = {"best_plan": (c.best_plan(g), jc.best_plan(g)),
                  "best_plan_few_cpus": (c.best_plan(g, 4 * g), jc.best_plan(g, 4 * g)),
                  "best_plan_at_most": (c.best_plan_at_most(g), jc.best_plan_at_most(g)),
                  "best_plan_at_most_cpus": (c.best_plan_at_most(g, 12 * g),
                                             jc.best_plan_at_most(g, 12 * g)),
                  "best_plan_at_most_spread": (c.best_plan_at_most(g, 12 * g, (2,) * (g // 2)),
                                               jc.best_plan_at_most(g, 12 * g, (2,) * (g // 2)))}
        bad += [(g, key, _point(got), _point(want)) for key, (got, want) in points.items()
                if not _same_point(_point(got), _point(want))]
        if g >= 1:
            base, jbase = c.best_plan(g).throughput, jc.best_plan(g).throughput
            for cpus in (12 * g, 6 * g):
                got = tsens.min_resources(c, g, cpus, 0.95 * base)
                want = jsens.min_resources(jc, g, cpus, 0.95 * jbase)
                if got != want:
                    bad.append((g, f"min_resources cpus {cpus}", got, want))
    assert not bad, bad[:10]


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------

HET_TYPES = ["a800", "v100", "a100-40g"]


def _job(job) -> tuple:
    return (job.name, job.profile.name, job.submit, job.target_iters, job.req_gpus,
            job.req_cpus, _plain(job.orig_plan), job.guaranteed, job.tenant, job.gpu_type)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", ["base", "mt", "bp", "hetero"])
def test_generate_matches_reference(variant, seed):
    kw = dict(n_jobs=24, hours=6.0, seed=seed, variant=variant,
              gpu_types=HET_TYPES if variant == "hetero" else None)
    got = [_job(j) for j in ttrace.generate(**kw)]
    assert got and got == [_job(j) for j in jtrace.generate(**kw)]


@pytest.mark.parametrize("seed", SEEDS)
def test_philly_and_event_streams_match_reference(seed):
    kw = dict(n_jobs=30, hours=12.0, seed=seed, load_scale=2.0, gpu_types=HET_TYPES)
    got = [_job(j) for j in ttrace.philly(**kw)]
    assert got and got == [_job(j) for j in jtrace.philly(**kw)]
    streams = {
        "failure_storm": ((8, 3 * 86400.0), dict(seed=seed, storm=(3600.0, 7200.0, 20.0))),
        "spot_churn": (([8, 9, 10], 3 * 86400.0), dict(seed=seed)),
        "degradation_storm": ((8, 3 * 86400.0), dict(seed=seed, nodes=[0, 2, 5])),
    }
    for fn, (args, kw) in streams.items():
        got = _plain(getattr(ttrace, fn)(*args, **kw))
        assert got and got == _plain(getattr(jtrace, fn)(*args, **kw)), fn


def test_trace_inputs_are_refused_like_the_reference():
    for fn, args, kw in (("failure_storm", (4, 0.0), {}), ("spot_churn", ([], 10.0), {}),
                         ("degradation_storm", (4, 100.0), {"slowdown": (0.5, 2.0)})):
        with pytest.raises(ValueError) as got:
            getattr(ttrace, fn)(*args, **kw)
        with pytest.raises(ValueError) as want:
            getattr(jtrace, fn)(*args, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The scheduler, pass by pass
# ---------------------------------------------------------------------------

TRACES = {   # trace kind: (generate's variant, cluster, quotas)
    "base": ("base", lambda c: c.Cluster(n_nodes=4), None),
    "hetero": ("hetero", lambda c: c.hetero_cluster([("a800", 2), ("v100", 1),
                                                     ("a100-40g", 1)]), None),
    "mt": ("mt", lambda c: c.Cluster(n_nodes=4), {"A": 16}),
}
PASSES = 12
DT = 900.0            # simulated seconds between passes
CAPACITY_LOSS_PASS = 5
REFIT_PASS = 7


def _snapshot(states) -> list[tuple]:
    return [(s.job.name, s.status, _plain(s.plan), _plain(s.alloc),
             sorted(s.placement.items()), s.min_res, s.baseline_perf, s.n_reconfig)
            for s in states]


def _drive(ns, kind: str, pass_engine: str, curve_engine: str, fits, sanitize: bool = False,
           made: list | None = None) -> list:
    """Arrivals three at a time, the oldest running job completing every
    other pass, node 1 lost at CAPACITY_LOSS_PASS (its residents through
    ``recover``), and at REFIT_PASS the first running job's model type refit
    (its params scaled by 1.2, every live job of the type swapped to them,
    minRes and baseline reset, as the reference's simulator does).  The
    snapshot of every job after every pass; the scheduler, sanitized when
    asked, is appended to ``made``."""
    variant, make_cluster, quotas = TRACES[kind]
    side = 0 if ns is REF else 1
    jobs = ns.trace.generate(n_jobs=24, hours=3.0, seed=5, variant=variant, load_scale=2.0,
                             gpu_types=HET_TYPES if variant == "hetero" else None)
    cluster = make_cluster(ns.cluster)
    sched = ns.scheduler.RubickScheduler(
        cfg=ns.scheduler.SchedulerConfig(pass_engine=pass_engine, curve_engine=curve_engine,
                                         sanitize=sanitize),
        quotas=quotas)
    if made is not None:
        made.append(sched)
    fitted = {name: pair[side] for name, pair in fits.items()}
    pinned = list(fitted.values())      # the scheduler's memos key on id(fitted)
    states, snaps, now = [], [], 0.0
    pending = list(jobs)
    for i in range(PASSES):
        ev = ns.cluster.SchedEvents()
        active = [s for s in states if s.status != "done"]
        for s in active:
            if s.status == "running":
                s.run_time += DT
        running = [s for s in active if s.status == "running"]
        if i % 2 == 1 and running:
            s = running[0]
            ev.completed.append((s, dict(s.placement)))
            s.status, s.placement, s.finish_time = "done", {}, now
        if i == CAPACITY_LOSS_PASS:
            cluster.nodes[1].up = False
            ev.node_down.append(1)
            for s in [s for s in states if s.status == "running" and 1 in s.placement]:
                before = dict(s.placement)
                sched.recover(s, [a for a in states if a.status != "done"], cluster, {1}, now)
                ev.evicted.append((s, before))
        if i == REFIT_PASS and running:
            name = running[-1].job.profile.name
            old = fitted[name]
            new = fitted[name] = ns.pm.FitParams.from_vector(old.as_vector() * 1.2)
            pinned.append(new)
            for s in states:
                if s.fitted is old and s.status != "done":
                    s.fitted, s.min_res, s.baseline_perf = new, None, 0.0
                    ev.refit.append((s, old))
        for job in pending[:3]:
            s = ns.cluster.JobState(job=job, fitted=fitted[job.profile.name])
            states.append(s)
            ev.arrived.append(s)
        pending = pending[3:]
        active = [s for s in states if s.status != "done"]
        sched.schedule(active, cluster, now, events=ev)
        assert ns.cluster.check_capacity(cluster, active)
        snaps.append(_snapshot(states))
        now += DT
    return snaps


@pytest.mark.parametrize("curve_engine", ["batch", "scalar"])
@pytest.mark.parametrize("pass_engine", ["incremental", "full"])
@pytest.mark.parametrize("kind", sorted(TRACES))
def test_scheduler_matches_reference_pass_by_pass(kind, pass_engine, curve_engine, fits):
    tsens.CURVES.clear()
    jsens.CURVES.clear()
    got = _drive(PORT, kind, pass_engine, curve_engine, fits)
    want = _drive(REF, kind, pass_engine, curve_engine, fits)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"pass {i}: " + str([(a, b) for a, b in zip(g, w) if a != b][:3])
    last = got[-1]
    assert {row[1] for row in last} >= {"running", "done"}
    assert any(row[7] > 0 for row in last)          # some job was reconfigured


def test_throughput_of_matches_reference(fits):
    prof, jprof = tpaper.TABLE2["gpt2-1.5b"], jpaper.TABLE2["gpt2-1.5b"]
    k, jk = fits["gpt2-1.5b"][1], fits["gpt2-1.5b"][0]
    job = tcluster.Job("a", prof, 0.0, 100.0, 2, 24, tplan.ExecutionPlan(dp=2))
    jjob = jcluster.Job("a", jprof, 0.0, 100.0, 2, 24, jplan.ExecutionPlan(dp=2))
    s = tcluster.JobState(job, "running", tplan.ExecutionPlan(dp=2), tpm.Alloc(2, 24), fitted=k)
    js = jcluster.JobState(jjob, "running", jplan.ExecutionPlan(dp=2), jpm.Alloc(2, 24),
                           fitted=jk)
    got = tscheduler.throughput_of(s, tpm.Env())
    assert got > 0 and got == jscheduler.throughput_of(js, jpm.Env())


@pytest.mark.parametrize("how", ["config", "env"])
@pytest.mark.parametrize("pass_engine", ["incremental", "full"])
def test_sanitized_scheduler_matches_unsanitized(pass_engine, how, fits, monkeypatch):
    """Sanitizing on (``SchedulerConfig(sanitize=True)``, or
    ``REPRO_SANITIZE=1``) cross-checks every pass and changes no decision:
    the pass-by-pass drive of the hetero trace equals the unsanitized one and
    the reference's."""
    from repro_torch.analysis.sanitizer import SchedSanitizer

    made = []
    if how == "env":
        monkeypatch.setenv("REPRO_SANITIZE", "1")
    tsens.CURVES.clear()
    got = _drive(PORT, "hetero", pass_engine, "batch", fits, sanitize=how == "config",
                 made=made)
    assert isinstance(made[0]._san, SchedSanitizer) and made[0]._san._tick == PASSES
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    tsens.CURVES.clear()
    assert got == _drive(PORT, "hetero", pass_engine, "batch", fits, made=made)
    assert made[1]._san is None
    jsens.CURVES.clear()
    assert got == _drive(REF, "hetero", pass_engine, "batch", fits)


# ---------------------------------------------------------------------------
# The analytic oracle's additions
# ---------------------------------------------------------------------------

def test_oracle_additions_match_reference():
    o = toracle.AnalyticOracle(drifting=True, drift_scale=0.8, drift_tau=3600.0)
    jo = joracle.AnalyticOracle(drifting=True, drift_scale=0.8, drift_tau=3600.0)
    for name in PROFILES:
        prof, jprof = tpaper.TABLE2[name], jpaper.TABLE2[name]
        for now in (0.0, 600.0, 7200.0, 1e6):
            assert _plain(o.true_params_at(name, now)) == _plain(jo.true_params_at(name, now))
            for kw, g in (({"dp": 2}, 2), ({"dp": 1, "zero_stage": 1, "offload": True}, 1)):
                args = (tplan.ExecutionPlan(**kw), tpm.Alloc(g, 12 * g))
                jargs = (jplan.ExecutionPlan(**kw), jpm.Alloc(g, 12 * g))
                assert o.measure(prof, *args, seed=3, now=now) == \
                    jo.measure(jprof, *jargs, seed=3, now=now)
                assert o.throughput(prof, *args, now=now) == jo.throughput(jprof, *jargs, now=now)
        for g in (1, 4, 8):
            tbl = tplan_table.get(prof.b, g, 8)
            jtbl = jplan_table.get(jprof.b, g, 8)
            np.testing.assert_array_equal(o.measure_batch(prof, tbl, g, 12 * g, seed=1),
                                          jo.measure_batch(jprof, jtbl, g, 12 * g, seed=1))
            np.testing.assert_array_equal(o.throughput_batch(prof, tbl, g, 12 * g),
                                          jo.throughput_batch(jprof, jtbl, g, 12 * g))
        c = toracle.true_curve(prof, max_gpus=8)
        jc = joracle.true_curve(jprof, max_gpus=8)
        np.testing.assert_array_equal(c.materialize().env, jc.materialize().env)
        assert _plain(c.materialize().plans) == _plain(jc.materialize().plans)
        assert _plain(c.fitted) == _plain(joracle.true_params(name))


# ---------------------------------------------------------------------------
# The reconfiguration mechanism: checkpoint under one plan, restore under another
# ---------------------------------------------------------------------------

TOL_PARAMS = 2e-4      # tests/test_torch_parallel.py's reconfiguration bound

RECONFIGURE = r"""
import json, sys, tempfile
import torch
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.oracle import build_train_step, reconfigure, run_steps
from repro_torch.parallel.plan import ExecutionPlan

cfg = configs.get_reduced("gpt2-1.5b").with_(dtype="float32")
shape = ShapeConfig("reconfig", 32, 4, "train")
static = ExecutionPlan(zero_stage=1, offload=True, gc=True)
run = build_train_step(cfg, static, shape, "cpu")
batch = run.model.dummy_batch(shape)
_, first = run_steps(run, batch, 2, warmup=0)
with tempfile.TemporaryDirectory() as d:
    run, info = reconfigure(run, ExecutionPlan(), shape, d, step=2)
    steps = sorted(p.name for p in __import__("pathlib").Path(d).iterdir())
_, second = run_steps(run, batch, 2, warmup=0)
ref = build_train_step(cfg, ExecutionPlan(), shape, "cpu")
_, whole = run_steps(ref, batch, 4, warmup=0)
got = dict(run.params.named_parameters())
err = {n: float((got[n] - p).abs().max() / p.abs().max().clamp_min(1e-30))
       for n, p in ref.params.named_parameters()}
print(json.dumps({"losses": first + second, "whole": whole, "differ": info["differ"],
                  "bytes": info["checkpoint_bytes"], "steps": steps,
                  "count": int(run.opt_state["count"]), "err": err}))
"""


def test_reconfiguration_offload_gc_to_plain_on_cpu():
    """2 steps of reduced gpt2-1.5b under ZeRO-Offload + GC on a one-rank
    gloo group, a checkpoint, a restore under the plain plan (bit-equal), 2
    more steps: the losses and parameters of 4 uninterrupted plain steps."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", RECONFIGURE], capture_output=True, text=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["differ"] == []
    assert got["bytes"] > 0 and got["steps"] == ["step_000000002"]
    assert got["count"] == 4
    np.testing.assert_allclose(got["losses"], got["whole"], rtol=1e-4)
    worst = max(got["err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= TOL_PARAMS, worst


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_schedule_and_reconfigure_cut_gpt2_on_card(cuda_device, tmp_path):
    """A cut gpt2 (2 layers, 4 heads of 64) on the card: the static pass
    places it under ZeRO-Offload + GC, a Rubick pass under its curve's plan
    (both pass engines agreeing), and the job is checkpointed under the
    static plan and restored bit for bit under Rubick's, with finite
    losses on both sides."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig

    cfg = configs.get("gpt2-1.5b").with_(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                                         d_ff=1024)
    shape = ShapeConfig("cut", 512, 8, "train")
    prof = tpm.ModelProfile.from_config(cfg, seq=shape.seq_len, batch=shape.global_batch)
    env = tpm.env_for_gpu("h100")
    static = tplan.ExecutionPlan(zero_stage=1, offload=True, gc=True)
    job = tcluster.Job("a", prof, 0.0, 100.0, 1, 12, static)
    k = tpm.FitParams()
    placed = {}
    for label, cfg_kw in (("static", {"reconfigure_plans": False,
                                      "reallocate_resources": False}),
                          ("incremental", {}), ("full", {"pass_engine": "full"})):
        cluster = tcluster.Cluster(n_nodes=1, gpus_per_node=1, cpus_per_node=12)
        s = tcluster.JobState(job, fitted=k)
        tscheduler.RubickScheduler(env, tscheduler.SchedulerConfig(**cfg_kw)).schedule(
            [s], cluster)
        assert s.status == "running"
        placed[label] = (s.plan, s.alloc, s.min_res, s.baseline_perf, s.placement)
    assert placed["static"][0] == static
    assert placed["incremental"] == placed["full"]
    plan = placed["incremental"][0]
    assert plan.n_gpus == 1
    run = toracle.build_train_step(cfg, static, shape, cuda_device)
    batch = run.model.dummy_batch(shape)
    _, first = toracle.run_steps(run, batch, 2)
    run, info = toracle.reconfigure(run, plan, shape, tmp_path / "ckpt", step=3)
    assert info["differ"] == [] and info["checkpoint_bytes"] > 0
    _, second = toracle.run_steps(run, batch, 2)
    assert np.isfinite(first + second).all()
    run.release()
