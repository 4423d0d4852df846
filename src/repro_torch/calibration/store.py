"""Runtime-telemetry accumulation for online model calibration.

A copy of ``repro.calibration.store`` for the port.

An ``Observation`` is one measured iteration time of a RUNNING job — the
repro's stand-in for the paper's runtime throughput monitoring — together
with the prediction the then-current fitted model made for the same
(plan, alloc, env) point.  The store keeps a bounded sliding window per
model-type key: drift detection and refitting both want *recent* evidence
(under a drifting cluster, old observations describe an environment that
no longer exists), so the window doubles as the refit sample set.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.core.perfmodel import Alloc, Env
from repro_torch.parallel.plan import ExecutionPlan


@dataclass(frozen=True)
class Observation:
    """One runtime throughput measurement of a running job."""
    t: float                      # simulation time of the measurement
    plan: ExecutionPlan
    alloc: Alloc
    env: Env
    t_iter: float                 # measured seconds per iteration
    predicted: float              # model's T_iter under the params current
                                  # at measurement time
    nodes: frozenset = frozenset()   # placement nodes at measurement
                                     # time (health exclusion joins here)


class ObservationStore:
    """Per-key sliding windows of observations (key = one model type)."""

    def __init__(self, window: int = 64):
        self.window_size = window
        self._windows: dict[object, deque[Observation]] = {}
        self._counts: dict[object, int] = {}

    def record(self, key, obs: Observation) -> None:
        win = self._windows.get(key)
        if win is None:
            win = self._windows[key] = deque(maxlen=self.window_size)
        win.append(obs)
        self._counts[key] = self._counts.get(key, 0) + 1

    def window(self, key) -> tuple[Observation, ...]:
        return tuple(self._windows.get(key, ()))

    def count(self, key) -> int:
        """Total observations ever recorded for ``key`` (not just the
        window — lets callers distinguish 'new key' from 'long-running')."""
        return self._counts.get(key, 0)

    def keys(self):
        return self._windows.keys()

    def __len__(self) -> int:
        return len(self._windows)
