"""The port's flight recorder (``repro_torch.obs``) against the reference's
``repro.obs``, on the CPU.

One run is made by each package from its own modules, with the same fits
(the reference's ``_prefit`` of the trace, converted field by field): a
failure storm on six nodes under several schedulers and both engines, and a
degradation storm with a health monitor and flaky operations.  Their JSONL
decision logs are equal byte for byte (they carry simulated time only);
their Chrome/Perfetto exports, whose profiler spans are wall clock, have the
same events by name, category and phase.  Then the port's own contracts, as
the reference's ``tests/test_obs.py`` states them: a run with no recorder
makes the decisions of a recorded one; the schema round trip and its
rejections, every kind's required fields; the pause ledger against
``SimResult``; ring buffers and caps; ``report`` summary / diff / validate
(in process and as ``python -m repro_torch.obs.report``), whose output
equals the reference's; ``trace_enabled``.  No assertion reads a clock.
"""

import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro import health as jhealth
from repro import obs as jobs_
from repro.core import baselines as jbaselines
from repro.core import cluster as jcluster
from repro.core import oracle as joracle
from repro.core import perfmodel as jpm
from repro.core import sensitivity as jsens
from repro.core import simulator as jsimulator
from repro.core import trace as jtrace
from repro.core.fitting import fit_batch as jfit_batch
from repro.obs import export as jexport
from repro.obs import report as jreport
from repro_torch import health as thealth
from repro_torch import obs as tobs
from repro_torch.core import baselines as tbaselines
from repro_torch.core import cluster as tcluster
from repro_torch.core import perfmodel as tpm
from repro_torch.core import sensitivity as tsens
from repro_torch.core import simulator as tsimulator
from repro_torch.core import trace as ttrace
from repro_torch.obs import export as texport
from repro_torch.obs import report as treport
from repro_torch.obs.recorder import _Ring

SRC = Path(__file__).resolve().parents[1] / "src"
REF = SimpleNamespace(baselines=jbaselines, cluster=jcluster, sens=jsens, sim=jsimulator,
                      trace=jtrace, health=jhealth, obs=jobs_, export=jexport, report=jreport)
PORT = SimpleNamespace(baselines=tbaselines, cluster=tcluster, sens=tsens, sim=tsimulator,
                       trace=ttrace, health=thealth, obs=tobs, export=texport, report=treport)
_FITS: dict = {}


def _fits(ns) -> dict:
    """The reference's fit of every model type of the two worlds' traces,
    as ``ns``'s ``FitParams``, keyed by ``fit_key``."""
    if not _FITS:
        profiles = {jpm.fit_key(j.profile): j.profile
                    for seed in (11, 12, 7) for j in _world(REF, "storm", seed)[1]}
        profiles.update((jpm.fit_key(j.profile), j.profile) for j in _world(REF, "gray", 0)[1])
        reqs, skipped = joracle.profiling_requests(list(profiles.values()),
                                                   joracle.AnalyticOracle())
        fitted = [(r.profile, k) for r, k in zip(reqs, jfit_batch(reqs))]
        fitted += [(p, jpm.FitParams()) for p, _ in skipped]
        _FITS.update((jpm.fit_key(p), k) for p, k in fitted)
    if ns is REF:
        return dict(_FITS)
    return {key: tpm.FitParams(**dataclasses.asdict(k)) for key, k in _FITS.items()}


def _world(ns, scenario: str, seed: int):
    if scenario == "storm":      # the reference's tests/test_obs.py::_storm_setup
        cap = ns.trace.failure_storm(6, 86400.0, seed=1, mtbf_s=86400.0,
                                     storm=(5000.0, 20000.0, 40.0))
        return (ns.cluster.Cluster(n_nodes=6),
                ns.trace.generate(n_jobs=16, hours=4, seed=seed, load_scale=2.0),
                {"capacity": cap})
    deg = ns.trace.degradation_storm(2, 86400.0, seed=4, mtbd_s=3 * 3600.0, mttr_s=2 * 3600.0,
                                     slowdown=(3.0, 6.0), storm=(0.0, 8 * 3600.0, 5.0))
    return (ns.cluster.Cluster(n_nodes=2),
            ns.trace.generate(n_jobs=10, hours=3, seed=6, load_scale=3.0),
            {"degradation": deg, "health": ns.health.HealthMonitor(),
             "flaky": ns.health.FlakyOps(ns.health.FlakyConfig(fail_p=0.5, seed=2))})


def _run(ns, sched_name="rubick", engine="incremental", mode="event", recorder=None,
         seed=11, scenario="storm"):
    ns.sens.CURVES.clear()
    cluster, jobs, kw = _world(ns, scenario, seed)
    sched = ns.baselines.ALL[sched_name](pass_engine=engine)
    sim = ns.sim.Simulator(cluster, sched, fit_cache=_fits(ns), mode=mode, recorder=recorder,
                           **kw)
    return sim.run(jobs, max_time=4 * 86400.0)


def _decisions(res):
    return (res.jcts, res.makespan, res.n_reconfig, res.n_events, res.guarantee_violations,
            res.n_cap_events, res.n_shrink_recover, res.n_kill_requeue, res.n_degrade_events,
            res.n_quarantined, res.n_migrate, res.n_op_retries, res.n_op_rollbacks)


# --- the exports against the reference's -------------------------------------

CASES = [("storm", "rubick", "incremental", "event"), ("storm", "rubick", "full", "discrete"),
         ("storm", "antman", "incremental", "event"), ("storm", "sia", "full", "event"),
         ("gray", "rubick", "incremental", "event"), ("gray", "rubick", "full", "discrete")]


@pytest.mark.parametrize("scenario,sched_name,engine,mode", CASES)
def test_jsonl_export_matches_reference_byte_for_byte(scenario, sched_name, engine, mode,
                                                      tmp_path):
    files, perfetto = {}, {}
    for side, ns in (("ref", REF), ("port", PORT)):
        rec = ns.obs.FlightRecorder(meta={"case": f"{scenario} {sched_name}"})
        res = _run(ns, sched_name, engine, mode, recorder=rec, scenario=scenario)
        assert res.telemetry is rec and rec.events.n_total > 0
        files[side] = ns.export.write_jsonl(rec, tmp_path / f"{side}.jsonl").read_bytes()
        doc = json.loads(ns.export.write_perfetto(rec, tmp_path / f"{side}.json").read_text())
        perfetto[side] = Counter((e.get("ph"), e["name"], e.get("cat"))
                                 for e in doc["traceEvents"])
    assert files["port"] == files["ref"]
    assert perfetto["port"] == perfetto["ref"]
    assert any(ph == "X" for ph, _, _ in perfetto["port"])       # profiler spans present


def test_each_package_reads_the_others_trace(tmp_path):
    rec = tobs.FlightRecorder(meta={"engine": "event"})
    _run(PORT, recorder=rec)
    path = tobs.write_jsonl(rec, tmp_path / "port.jsonl")
    got, want = tobs.read_jsonl(path), jobs_.read_jsonl(path)
    assert (got.meta, got.events, got.series) == (want.meta, want.events, want.series)
    assert jobs_.validate_events(want.events) == tobs.validate_events(got.events) > 0


# --- zero cost when disabled ---------------------------------------------------

@pytest.mark.parametrize("sched_name", ["rubick", "antman", "synergy"])
@pytest.mark.parametrize("engine", ["incremental", "full"])
def test_recorder_off_bit_exact(sched_name, engine):
    off = _run(PORT, sched_name, engine)
    rec = tobs.FlightRecorder()
    on = _run(PORT, sched_name, engine, recorder=rec)
    assert _decisions(off) == _decisions(on)
    assert rec.events.n_total > 0


@pytest.mark.parametrize("mode", ["event", "discrete"])
def test_recorder_off_bit_exact_under_gray_failures(mode):
    off = _run(PORT, mode=mode, scenario="gray")
    on = _run(PORT, mode=mode, scenario="gray", recorder=tobs.FlightRecorder())
    assert _decisions(off) == _decisions(on)
    assert on.n_degrade_events > 0


# --- schema ---------------------------------------------------------------------

def test_schema_round_trip(tmp_path):
    rec = tobs.FlightRecorder(meta={"engine": "event"})
    _run(PORT, recorder=rec)
    tr = tobs.read_jsonl(tobs.write_jsonl(rec, tmp_path / "t.jsonl"))
    assert tobs.validate_events(tr.events) == len(tr.events) > 0
    assert tr.meta["schema"] == "rubick-flight/1" == texport.SCHEMA_VERSION
    assert tr.meta["meta"]["engine"] == "event"
    assert set(tr.counts) <= set(tobs.KINDS) and tr.counts == rec.counts
    assert set(tr.series) == set(rec.series)
    for name, ring in rec.series.items():
        assert tr.series[name] == [list(pt) for pt in ring]


MALFORMED = [
    {"seq": 1, "t": 0.0, "kind": "no-such-kind"},
    {"seq": 1, "kind": "arrival"},                             # no t
    {"seq": 1, "t": -5.0, "kind": "arrival", "job": "a"},      # t < 0
    {"seq": 1, "t": float("nan"), "kind": "arrival", "job": "a"},
    {"seq": 0, "t": 0.0, "kind": "arrival", "job": "a"},       # seq not positive
    {"seq": 1, "t": 0.0, "kind": "arrival"},                   # missing job
]


@pytest.mark.parametrize("ev", MALFORMED)
def test_schema_rejects_malformed_events_like_the_reference(ev):
    with pytest.raises(texport.TraceSchemaError) as got:
        tobs.validate_event(ev)
    with pytest.raises(jexport.TraceSchemaError) as want:
        jobs_.validate_event(ev)
    assert str(got.value) == str(want.value)


def test_schema_rejects_decreasing_seq():
    with pytest.raises(texport.TraceSchemaError, match="seq not increasing"):
        tobs.validate_events([{"seq": 2, "t": 0.0, "kind": "arrival", "job": "a"},
                              {"seq": 1, "t": 0.0, "kind": "arrival", "job": "b"}])


def test_every_kind_and_its_fields():
    assert tobs.KINDS == jobs_.KINDS
    assert texport.KIND_FIELDS == jexport.KIND_FIELDS
    assert set(texport.KIND_FIELDS) == set(tobs.KINDS)
    values = {"job": "a", "cause": "c", "data": {"x": 1}}
    for kind, fields in texport.KIND_FIELDS.items():
        ev = {"seq": 1, "t": 1.0, "kind": kind, **{f: values[f] for f in fields}}
        tobs.validate_event(ev)
        for f in fields:
            with pytest.raises(texport.TraceSchemaError, match=repr(f)):
                tobs.validate_event({k: v for k, v in ev.items() if k != f})


# --- downtime accounting and provenance ----------------------------------------------

def test_pause_accounting_matches_result_fields():
    rec = tobs.FlightRecorder()
    res = _run(PORT, recorder=rec)
    assert res.telemetry is rec
    assert res.total_paused_s == rec.total_paused_s > 0
    assert res.restore_paused_s == rec.pause_s.get("restore", 0.0)
    assert res.downtime_by_job == rec.downtime_by_job()
    emitted = sum(e["data"]["seconds"] for e in rec.events if e["kind"] == "pause")
    assert emitted == pytest.approx(res.total_paused_s, rel=1e-12)


def test_evictions_attributable_to_capacity_events(tmp_path):
    rec = tobs.FlightRecorder()
    res = _run(PORT, recorder=rec)
    assert res.n_cap_events > 0
    rows = treport.attribution(tobs.read_jsonl(tobs.write_jsonl(rec, tmp_path / "s.jsonl")))
    assert rows and len(rows) == rec.counts.get("evict", 0)
    for r in rows:
        assert r["triggers"] and r["outcome"] in ("shrunk", "killed")
        assert {t["node"] for t in r["triggers"]} <= set(r["lost_nodes"])


def test_pass_profiler_records_phase_spans():
    rec = tobs.FlightRecorder()
    _run(PORT, recorder=rec)
    totals = rec.span_totals()
    assert {"pass", "admission", "slope-walks"} <= set(totals)
    assert all(agg["n"] > 0 for agg in totals.values())


# --- ring buffers ----------------------------------------------------------------

def test_ring_buffer_counts_drops():
    ring = _Ring(4)
    for i in range(10):
        ring.append(i)
    assert (ring.n_total, ring.n_dropped, list(ring)) == (10, 6, [6, 7, 8, 9])


def test_recorder_caps_are_enforced(tmp_path):
    rec = tobs.FlightRecorder(max_events=16, max_samples=8)
    _run(PORT, recorder=rec)
    assert len(rec.events) <= 16 and all(len(r) <= 8 for r in rec.series.values())
    tr = tobs.read_jsonl(tobs.write_jsonl(rec, tmp_path / "t.jsonl"))
    assert tr.meta["n_events_dropped"] == rec.events.n_dropped > 0


# --- report CLI ------------------------------------------------------------------

def _traces(tmp_path) -> tuple[str, str, str]:
    paths = []
    for seed in (11, 12):
        rec = tobs.FlightRecorder()
        _run(PORT, recorder=rec, seed=seed)
        paths.append(str(tobs.write_jsonl(rec, tmp_path / f"s{seed}.jsonl")))
        if seed == 11:
            perfetto = str(tobs.write_perfetto(rec, tmp_path / "s11.perfetto.json"))
    return paths[0], paths[1], perfetto


def test_report_summary_diff_validate(tmp_path, capsys):
    a, b, perfetto = _traces(tmp_path)
    outs = {}
    for side, ns in (("port", PORT), ("ref", REF)):
        assert ns.report.summary(a) == 0
        assert ns.report.diff(a, b) == 0
        assert ns.report.validate([a, b]) == 0
        outs[side] = capsys.readouterr().out
    assert outs["port"] == outs["ref"]
    assert "ok (" in outs["port"]
    assert treport.summary(a, perfetto=perfetto) == 0
    assert "profiler phases" in capsys.readouterr().out


def test_report_cli_runs_as_a_module(tmp_path):
    a, b, _ = _traces(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for args, rc in ((["validate", a, b], 0), (["diff", a, b], 0), (["summary", a], 0)):
        res = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", *args],
                             capture_output=True, text=True, env=env, timeout=120)
        assert res.returncode == rc, res.stdout + res.stderr
    assert "ok (" in res.stdout or "events" in res.stdout


def test_report_validate_rejects_corrupt_trace(tmp_path):
    p = tmp_path / "bad.jsonl"
    rec = tobs.FlightRecorder()
    rec.decision("arrival", 1.0, job="a")
    tobs.write_jsonl(rec, p)
    p.write_text(p.read_text() + json.dumps({"seq": 99, "t": 0.0, "kind": "bogus"}) + "\n")
    assert treport.validate([str(p)]) == 1
    assert treport.main(["validate", str(p)]) == 1


def test_trace_enabled_env(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    assert not tobs.trace_enabled()
    for value, on in (("0", False), ("1", True), ("no", False), ("yes", True)):
        monkeypatch.setenv("REPRO_TRACE", value)
        assert tobs.trace_enabled() is on is jobs_.trace_enabled()
