"""The port's online calibration (``repro_torch.calibration``) against the
reference's ``repro.calibration``, on the CPU.

One observation stream, drawn for each package from its own drifting
analytic oracle (the two give identical measurements,
``tests/test_torch_sched.py``), feeds a ``CalibrationManager`` of each
package tick by tick: three Table 2 model types under their reference fits
and one registered as a default-params fallback.  After every ``poll`` the
refits (parameters relative 1e-9, versions, times, window errors before and
after), the error timeline, the fit versions and the curves left in the
process-wide cache (the retired params' curves invalidated) equal the
reference's.  The drift detector's threshold, evidence floor and cooldown
and the store's window act on both sides alike.  A sanitized manager
(``REPRO_SANITIZE``) refits as an unsanitized one.
"""

import math

import numpy as np
import pytest

from repro import calibration as jcal
from repro.core import oracle as joracle
from repro.core import paper_models as jpaper
from repro.core import perfmodel as jpm
from repro.core import sensitivity as jsens
from repro.core.fitting import fit_batch as jfit_batch
from repro.parallel import plan as jplan
from repro_torch import calibration as tcal
from repro_torch.core import oracle as toracle
from repro_torch.core import paper_models as tpaper
from repro_torch.core import perfmodel as tpm
from repro_torch.core import sensitivity as tsens
from repro_torch.parallel import plan as tplan

FITTED = ("bert-336m", "gpt2-1.5b", "t5-1.2b")
FALLBACK = "llama2-7b"
POINTS = (({"dp": 1}, 1), ({"dp": 2}, 2), ({"dp": 4, "zero_stage": 1}, 4),
          ({"dp": 2, "ga_steps": 2}, 2), ({"dp": 1, "zero_stage": 1, "offload": True}, 1),
          ({"dp": 8, "zero_stage": 3, "gc": True}, 8))
TICK_S = 1200.0
TICKS = 30
RTOL = 1e-9
SIDES = {"port": (tcal, toracle, tpaper, tpm, tplan, tsens),
         "ref": (jcal, joracle, jpaper, jpm, jplan, jsens)}


def _fits() -> dict[str, np.ndarray]:
    reqs, _ = joracle.profiling_requests([jpaper.TABLE2[n] for n in FITTED],
                                         joracle.AnalyticOracle())
    return {r.profile.name: k.as_vector() for r, k in zip(reqs, jfit_batch(reqs))}


def _run(side: str, fits: dict[str, np.ndarray], detector_cfg: dict) -> list:
    """Every tick: each model type measured at every POINT by the drifting
    oracle under the params current for it, then ``poll``.  Returns one
    record per tick."""
    cal, oracle, paper, pm, plan, sens = SIDES[side]
    sens.CURVES.clear()
    env = pm.Env()
    mgr = cal.CalibrationManager(env=env, detector=cal.DriftDetector(
        cal.DriftConfig(**detector_cfg)), store=cal.ObservationStore(window=24))
    truth = oracle.AnalyticOracle(env=env, drifting=True, drift_scale=0.6, drift_tau=7200.0)
    for name, vec in fits.items():
        mgr.ensure(paper.TABLE2[name], pm.FitParams.from_vector(vec))
    mgr.ensure(paper.TABLE2[FALLBACK], pm.FitParams(), fallback=True)
    names = list(fits) + [FALLBACK]
    out = []
    for i in range(1, TICKS + 1):
        now = i * TICK_S
        for name in names:
            prof = paper.TABLE2[name]
            k = mgr.current(prof)
            sens.get_curve(prof, k, env, max_gpus=8)       # a curve for each live fit
            for kw, g in POINTS:
                p, a = plan.ExecutionPlan(**kw), pm.Alloc(g, 12 * g)
                mgr.observe(prof, k, p, a, env, truth.measure(prof, p, a, seed=i, now=now),
                            now, nodes=frozenset({i % 3}))
        refits = mgr.poll(now)
        out.append({
            "refits": [(r.profile.name, r.old.as_vector(), r.new.as_vector(), r.version, r.t,
                        r.rmsle_before, r.rmsle_after) for r in refits],
            "versions": [mgr.version(paper.TABLE2[n]) for n in names],
            "priority": [mgr.is_priority(paper.TABLE2[n]) for n in names],
            "window_error": [mgr.window_error(paper.TABLE2[n]) for n in names],
            "curves": sorted(tuple(key[1].as_vector()) for key in sens.CURVES._curves),
        })
    out.append({"error_log": [(t, key[0], err) for t, key, err in mgr.error_log],
                "history": len(mgr.history), "evals": mgr.fit_stats.evals,
                "iters": mgr.fit_stats.iters})
    return out


def _same(got, want, path="") -> list[str]:
    """Paths where two records differ: floats and arrays at RTOL, the rest
    exactly."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        return [e for k in want for e in _same(got[k], want[k], f"{path}.{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [f"{path}: {len(got)} items, want {len(want)}"]
        return [e for i, (g, w) in enumerate(zip(got, want)) for e in _same(g, w, f"{path}[{i}]")]
    if isinstance(want, np.ndarray) or isinstance(want, float):
        g, w = np.asarray(got, float), np.asarray(want, float)
        ok = g.shape == w.shape and np.allclose(g, w, rtol=RTOL, atol=0, equal_nan=True)
        return [] if ok else [f"{path}: {got} != {want}"]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]


@pytest.fixture(scope="module")
def fits():
    return _fits()


@pytest.mark.parametrize("detector", ["default", "tight"])
def test_refits_match_reference(detector, fits):
    cfg = {"default": {}, "tight": {"threshold": 0.05, "min_observations": 12,
                                    "cooldown_s": 3600.0}}[detector]
    got, want = _run("port", fits, cfg), _run("ref", fits, cfg)
    bad = _same(got, want)
    assert not bad, bad[:5]
    refits = [r for tick in got[:-1] for r in tick["refits"]]
    assert refits, "the stream drove no refit"
    assert FALLBACK in {r[0] for r in refits}       # the default-params fallback refit
    assert all(r[6] <= r[5] + 1e-12 for r in refits if math.isfinite(r[5]))
    # every retired fit's curves left the cache
    retired = {tuple(r[1]) for r in refits}
    assert not retired & set(got[-2]["curves"])


def test_window_rmsle_and_store_match_reference():
    prof, jprof = tpaper.TABLE2["gpt2-1.5b"], jpaper.TABLE2["gpt2-1.5b"]
    obs = [tcal.Observation(float(t), tplan.ExecutionPlan(dp=2), tpm.Alloc(2, 24), tpm.Env(),
                            1.0 + 0.1 * t, p) for t, p in
           enumerate((1.0, 1.3, float("inf"), 0.0, 2.2, 1.9))]
    jobs = [jcal.Observation(o.t, jplan.ExecutionPlan(dp=2), jpm.Alloc(2, 24), jpm.Env(),
                             o.t_iter, o.predicted) for o in obs]
    assert tcal.window_rmsle(obs) == jcal.window_rmsle(jobs)
    assert math.isnan(tcal.window_rmsle([]))
    store, jstore = tcal.ObservationStore(window=4), jcal.ObservationStore(window=4)
    for o, jo in zip(obs, jobs):
        store.record(prof.name, o)
        jstore.record(jprof.name, jo)
    assert store.count(prof.name) == jstore.count(jprof.name) == 6
    assert [o.t for o in store.window(prof.name)] == [o.t for o in jstore.window(jprof.name)]
    assert len(store) == len(jstore) == 1


def test_sanitized_manager_matches_unsanitized(fits, monkeypatch):
    """With ``REPRO_SANITIZE`` on, every ``poll`` that refits is
    cross-checked (``check_manager``) and the refits, versions and curves are those of
    an unsanitized manager, and the reference's."""
    from repro_torch.analysis.sanitizer import SchedSanitizer

    cfg = {"threshold": 0.05, "min_observations": 12, "cooldown_s": 3600.0}
    checked = []
    real = SchedSanitizer.check_manager
    monkeypatch.setattr(SchedSanitizer, "check_manager",
                        lambda self, mgr: checked.append(mgr) or real(mgr))
    monkeypatch.setenv("REPRO_SANITIZE", "yes")
    assert isinstance(tcal.CalibrationManager()._san, SchedSanitizer)
    got = _run("port", fits, cfg)
    assert len(checked) == sum(1 for tick in got[:-1] if tick["refits"]) > 0
    monkeypatch.delenv("REPRO_SANITIZE")
    assert tcal.CalibrationManager()._san is None
    assert not _same(got, _run("port", fits, cfg))
    assert not _same(got, _run("ref", fits, cfg))
