"""Online calibration subsystem (paper Sec 4.3's "refit online" loop).

A copy of ``repro.calibration`` for the port, held to the reference's
refits by ``tests/test_torch_calibration.py``; the simulator and flight
recorder named below are the port's copies (``core/simulator.py``,
``obs/``).

The paper's performance model is not fit once: whenever prediction error
on a RUNNING job exceeds a threshold, the model is refit from runtime
telemetry so scheduling decisions track the real cluster instead of a
stale 7-point profile.  This package closes that loop for the repro:

  * ``ObservationStore`` — sliding windows of (plan, alloc, env,
    measured T_iter, predicted T_iter) telemetry per model type, emitted
    by the simulator at completion events, reschedule points, and the
    periodic telemetry event.
  * ``DriftDetector`` — RMSLE of predicted vs observed T_iter over the
    window; exceeding the threshold (subject to a cooldown) triggers a
    refit.  Jobs whose initial fit fell back to default ``FitParams``
    (too few feasible profiling samples) are highest-priority: they
    refit as soon as enough observations exist, threshold or not.
  * ``CalibrationManager`` — owns versioned ``FitParams`` per model
    type, collects every drifted type at a telemetry tick into ONE
    warm-started ``repro.core.fitting.fit_batch`` call (all refits'
    restarts step as a single batched simplex tensor; ``x0=current``
    guarantees ``rmsle_after ≤ rmsle_before``), and publishes each
    ``Refit`` so consumers can invalidate every derived structure
    (CurveCache entries, scheduler memos, incremental-pass indices) —
    see ``SchedEvents.refit`` and ``_PassCtx.apply_refits``.
"""

from repro_torch.calibration.drift import DriftConfig, DriftDetector, window_rmsle
from repro_torch.calibration.manager import CalibrationManager, Refit
from repro_torch.calibration.store import Observation, ObservationStore

__all__ = [
    "CalibrationManager",
    "DriftConfig",
    "DriftDetector",
    "Observation",
    "ObservationStore",
    "Refit",
    "window_rmsle",
]
