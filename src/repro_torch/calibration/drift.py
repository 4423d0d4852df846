"""Drift detection: when has the fitted model stopped describing reality?

A copy of ``repro.calibration.drift`` for the port.

The paper refits the model online "when prediction error exceeds a
threshold".  The error metric is the same RMSLE the fit itself minimizes
(Sec 4.3), evaluated over the sliding observation window, so the trigger
and the optimizer agree on what "wrong" means.  A cooldown bounds refit
frequency (each refit is a Nelder-Mead run plus a curve-cache
invalidation sweep), and *priority* keys — model types whose initial fit
fell back to default ``FitParams`` because too few profiling samples were
feasible — bypass the threshold entirely: any window of real telemetry
beats an uncalibrated default.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.perfmodel import rmsle


def window_rmsle(window) -> float:
    """RMSLE of predicted vs measured T_iter over an observation window
    (nan when no finite pairs exist) — delegates to ``perfmodel.rmsle``
    so the drift trigger and the fit optimizer always agree on what
    "error" means.  Runs once per observed model type at EVERY telemetry
    tick (the manager's error timeline), so the filter is one vectorized
    mask instead of a Python loop over the window."""
    n = len(window)
    if n == 0:
        return float("nan")
    pred = np.fromiter((o.predicted for o in window), float, count=n)
    true = np.fromiter((o.t_iter for o in window), float, count=n)
    ok = np.isfinite(pred) & (pred > 0) & (true > 0)
    if not ok.any():
        return float("nan")
    return rmsle(pred[ok], true[ok])


@dataclass
class DriftConfig:
    threshold: float = 0.15       # window RMSLE that triggers a refit
    min_observations: int = 8     # evidence floor before judging drift
    cooldown_s: float = 1800.0    # min simulated seconds between refits


class DriftDetector:
    """Compares predicted vs observed T_iter and decides when to refit.

    Only observations RECORDED AFTER the key's last refit count: their
    stored predictions were made by the current fit, so their error is
    the current fit's error (pre-refit entries lingering in the window
    were already explained by the refit that retired them).  This also
    means a model type whose telemetry stream has gone quiet can never
    trigger again — refitting a stale window the optimizer has already
    seen is wasted work by construction."""

    def __init__(self, cfg: DriftConfig | None = None):
        self.cfg = cfg or DriftConfig()
        self._last_refit: dict[object, float] = {}

    def fresh(self, key, window) -> list:
        """Observations recorded since the key's last refit (all of them
        when it has never refit)."""
        last = self._last_refit.get(key)
        if last is None:
            return list(window)
        return [o for o in window if o.t > last]

    def error(self, key, window) -> float:
        """Current-fit prediction RMSLE (post-last-refit observations)."""
        return window_rmsle(self.fresh(key, window))

    def should_refit(self, key, window, now: float,
                     priority: bool = False,
                     fresh: list | None = None,
                     err: float | None = None) -> bool:
        """``fresh``/``err`` let a caller that already computed them
        (``CalibrationManager.poll`` logs the error every tick) skip the
        recomputation; semantics are identical when omitted."""
        if fresh is None:
            fresh = self.fresh(key, window)
        if len(fresh) < self.cfg.min_observations:
            return False
        last = self._last_refit.get(key)
        if last is not None and now - last < self.cfg.cooldown_s:
            return False
        if priority:
            return True
        if err is None:
            err = window_rmsle(fresh)
        return math.isfinite(err) and err >= self.cfg.threshold

    def note_refit(self, key, now: float) -> None:
        self._last_refit[key] = now
