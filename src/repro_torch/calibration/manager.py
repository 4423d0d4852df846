"""Versioned ownership of fitted params + drift-triggered refits.

A copy of ``repro.calibration.manager`` for the port; with sanitizing
on, every ``poll`` is cross-checked (``analysis/sanitizer.py``), and the
simulator threads its flight recorder into ``recorder``.

``CalibrationManager`` is the authority on which ``FitParams`` are
*current* for each model type.  The simulator streams telemetry in via
``observe()`` and calls ``poll()`` at every telemetry event; each
returned ``Refit`` must then flow through the system as a first-class
invalidation (the PR-1/2/3 engines made fitted curves process-wide,
identity-keyed, and memoized):

  1. the manager bumps the key's fit version and drops the retired
     params' ``CurveCache`` entries (envelopes, statics, slope lists);
  2. the simulator swaps ``js.fitted`` on every live job of the model
     type and resets the derived per-job state (``min_res``,
     ``baseline_perf``) so the next pass recomputes it under the new
     curve;
  3. the scheduler receives the refit in ``SchedEvents.refit``: it
     purges identity-keyed memos and — under
     ``pass_engine="incremental"`` — marks the jobs dirty, un-parks
     their walks, and bumps the node/victim indices they touch, keeping
     incremental ≡ full bit-exact across the refit.

Retired ``FitParams`` objects are pinned in ``history`` deliberately:
every hot cache in the scheduler stack keys on ``id(fitted)``, and
letting a retired object be garbage-collected would allow a NEW params
object to be allocated at the recycled address and silently alias the
stale cache entries.  The pinned objects are 7 floats each; the heavy
state (curves) is what ``invalidate_fitted`` releases.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.analysis import sanitize_enabled
from repro_torch.calibration.drift import DriftDetector, window_rmsle
from repro_torch.calibration.store import Observation, ObservationStore
from repro_torch.core.fitting import FitRequest, FitStats, fit_batch
from repro_torch.core.perfmodel import (Alloc, Env, FitParams, ModelProfile,
                                  fit_key, predict_titer, rmsle)
from repro_torch.core.sensitivity import CURVES
from repro_torch.parallel.plan import ExecutionPlan


@dataclass(frozen=True)
class Refit:
    """One published recalibration of a model type."""
    profile: ModelProfile
    old: FitParams
    new: FitParams
    version: int                  # fit version AFTER this refit (first = 1)
    t: float                      # simulation time of the refit
    # error over the refit's own sample set (the window's majority-env
    # subset) under the retired / new params; the warm start guarantees
    # after ≤ before on exactly this set
    rmsle_before: float
    rmsle_after: float


class CalibrationManager:
    """Owns versioned per-model-type ``FitParams`` and publishes refits.

    ``enabled=False`` keeps the full telemetry/error pipeline running
    (``error_log`` still tracks prediction error over time — the
    refits-off baseline in ``bench_calibration``) but never refits.
    """

    def __init__(self, env: Env | None = None,
                 store: ObservationStore | None = None,
                 detector: DriftDetector | None = None,
                 enabled: bool = True, refit_restarts: int = 2):
        self.env = env or Env()
        self.store = store or ObservationStore()
        self.detector = detector or DriftDetector()
        self.enabled = enabled
        # warm-started refits refine an already-calibrated incumbent:
        # the warm vertex dominates, so fewer multi-start probes than a
        # cold fit (fit_batch's default 3) are needed — keep ≥2 so one
        # noisy restart can still escape a bad incumbent basin
        self.refit_restarts = refit_restarts
        self.recorder = None           # flight recorder (repro_torch.obs), opt-in
        self._current: dict[tuple, FitParams] = {}
        self._profiles: dict[tuple, ModelProfile] = {}
        self._versions: dict[tuple, int] = {}
        self._priority: set[tuple] = set()   # default-FitParams fallbacks
        self._excluded: set[int] = set()     # degraded nodes (health)
        self.history: list[Refit] = []       # pins retired FitParams (see
                                             # module docstring)
        # (t, key, window RMSLE) per poll — prediction error over time
        self.error_log: list[tuple[float, tuple, float]] = []
        # accumulated fitting-engine cost across all refits (benches
        # report this separately from simulation wall-clock)
        self.fit_stats = FitStats()
        self._san = None
        if sanitize_enabled():
            from repro_torch.analysis.sanitizer import SchedSanitizer
            self._san = SchedSanitizer()

    # ------------------------------------------------------------------
    def ensure(self, profile: ModelProfile, params: FitParams,
               fallback: bool = False) -> None:
        """Register a model type's initial fit.  ``fallback=True`` marks
        a default-params fallback (too few feasible profiling samples):
        the drift detector treats it as a highest-priority refit
        candidate — real telemetry replaces it as soon as enough
        observations accumulate, no threshold required."""
        key = fit_key(profile)
        if key not in self._current:
            self._current[key] = params
            self._profiles[key] = profile
            self._versions[key] = 0
        if fallback:
            self._priority.add(key)

    def current(self, profile: ModelProfile) -> FitParams | None:
        return self._current.get(fit_key(profile))

    def version(self, profile: ModelProfile) -> int:
        return self._versions.get(fit_key(profile), 0)

    def is_priority(self, profile: ModelProfile) -> bool:
        return fit_key(profile) in self._priority

    # ------------------------------------------------------------------
    def observe(self, profile: ModelProfile, fitted: FitParams,
                plan: ExecutionPlan, alloc: Alloc, env: Env,
                t_iter: float, now: float,
                nodes: frozenset = frozenset(),
                predicted: float | None = None) -> None:
        """Record one runtime measurement.  ``fitted`` is whatever the
        measured job was scheduled under — its prediction is captured
        HERE so the error timeline reflects the params that were live at
        measurement time, across refits.  ``nodes`` is the placement at
        measurement time (lets the health monitor's exclusion mask
        degraded-node evidence); ``predicted`` short-circuits the
        predict when the caller already computed it."""
        if not (math.isfinite(t_iter) and t_iter > 0):
            return
        pred = predicted if predicted is not None \
            else predict_titer(profile, plan, alloc, env, fitted)
        self.store.record(fit_key(profile), Observation(
            t=now, plan=plan, alloc=alloc, env=env, t_iter=t_iter,
            predicted=pred, nodes=frozenset(nodes)))

    def set_excluded(self, nodes: set[int]) -> None:
        """Mask observations touching these nodes from drift detection
        and refit windows (the HealthMonitor's exclusion: a throttled
        GPU inflates measured T_iter without any model drift).  The
        mask applies retroactively to the whole window — detection that
        lands before the drift trigger accumulates prevents the bogus
        refit entirely."""
        self._excluded = set(nodes)

    # ------------------------------------------------------------------
    def poll(self, now: float) -> list[Refit]:
        """Evaluate drift on every observed model type; refit the ones
        over threshold (or priority fallbacks with enough evidence).
        Every drifted type at this tick is collected into ONE
        ``fit_batch`` call — all refits' restarts step as a single
        batched simplex tensor — and each result is published
        individually.  Returns the refits for the caller to propagate —
        see the module docstring for the invalidation contract."""
        pending: list[tuple[tuple, list]] = []   # (key, majority-env sub)
        excl = self._excluded
        for key in self.store.keys():
            win = self.store.window(key)
            if excl:
                win = tuple(o for o in win if not (o.nodes & excl))
                if not win:
                    continue
            fresh = self.detector.fresh(key, win)
            err = window_rmsle(fresh)             # current-fit error
            if math.isfinite(err):
                self.error_log.append((now, key, err))
            if not self.enabled or key not in self._current:
                continue
            if not self.detector.should_refit(
                    key, win, now, priority=key in self._priority,
                    fresh=fresh, err=err):
                continue
            sub = self._refit_window(win)
            if sub is not None:
                pending.append((key, sub))
        if not pending:
            return []
        requests = [FitRequest(
            profile=self._profiles[key],
            samples=tuple((o.plan, o.alloc, o.t_iter) for o in sub),
            env=sub[0].env, x0=self._current[key])    # warm start
            for key, sub in pending]
        fitted = fit_batch(requests, n_restarts=self.refit_restarts,
                           stats=self.fit_stats)
        refits = [self._publish(key, sub, new, now)
                  for (key, sub), new in zip(pending, fitted)]
        if self._san is not None:
            self._san.check_manager(self)
        return refits

    @staticmethod
    def _refit_window(win) -> list | None:
        """The window's majority-environment subset, or None below the
        fit floor.  The fit takes one Env, so the refit works on the
        majority-env subset (heterogeneous pools contribute per-type
        observations) — fitting AND scoring on the same subset makes the
        warm-start guarantee exact: the optimizer starts from the
        incumbent's loss and can only improve it."""
        env_counts: dict[Env, int] = {}
        for o in win:
            env_counts[o.env] = env_counts.get(o.env, 0) + 1
        env = max(env_counts, key=env_counts.get)
        sub = [o for o in win if o.env == env]
        if len(sub) < 4:
            # the project-wide fit floor (same as Simulator._fitted):
            # never publish a 7-param model fit on fewer points.  The
            # detector's evidence floor counts ALL envs, which a very
            # mixed window can spread thin — wait for more telemetry
            # (no cooldown is noted, so the next poll retries)
            return None
        return sub

    def _publish(self, key: tuple, sub: list, new: FitParams,
                 now: float) -> Refit:
        """Version-bump one fitted result and release its retired state."""
        profile = self._profiles[key]
        cur = self._current[key]
        before = self._window_error(profile, cur, sub)
        after = self._window_error(profile, new, sub)
        self.detector.note_refit(key, now)
        self._priority.discard(key)
        version = self._versions[key] = self._versions[key] + 1
        self._current[key] = new
        CURVES.invalidate_fitted(cur)      # retired curve family
        refit = Refit(profile=profile, old=cur, new=new, version=version,
                      t=now, rmsle_before=before, rmsle_after=after)
        self.history.append(refit)
        if self.recorder is not None:
            self.recorder.decision(
                "refit", now,
                data={"model": profile.name, "version": version,
                      "rmsle_before": before, "rmsle_after": after})
        return refit

    @staticmethod
    def _window_error(profile: ModelProfile, params: FitParams,
                      win) -> float:
        """Window RMSLE re-predicted under ``params`` (each observation
        under its own env) — before/after comparisons re-evaluate the
        SAME window so a refit's improvement is directly attributable."""
        pred, true = [], []
        for o in win:
            p = predict_titer(profile, o.plan, o.alloc, o.env, params)
            if math.isfinite(p) and p > 0 and o.t_iter > 0:
                pred.append(p)
                true.append(o.t_iter)
        if not pred:
            return float("nan")
        return rmsle(np.asarray(pred), np.asarray(true))

    # ------------------------------------------------------------------
    def window_error(self, profile: ModelProfile) -> float:
        """Current window RMSLE for one model type (nan = no evidence)."""
        return window_rmsle(self.store.window(fit_key(profile)))
