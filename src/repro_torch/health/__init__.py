"""Gray-failure resilience: node health monitoring and flaky-operation
retry.

A copy of ``repro.health`` for the port, held to it by
``tests/test_torch_sim.py`` (a degradation storm under both engines).

``HealthMonitor`` consumes the same measured-vs-predicted T_iter
telemetry the calibration loop streams, attributes sustained gaps to
*nodes* (cross-job intersection of placements) rather than to model
drift, and drives quarantine decisions through an append-only health
ledger the sanitizer can recompute.  ``FlakyOps`` injects seeded
failure/timeout/retry behavior into reconfiguration, checkpoint, and
restore operations.
"""

from repro_torch.health.flaky import FlakyConfig, FlakyOps
from repro_torch.health.monitor import HealthConfig, HealthMonitor

__all__ = ["FlakyConfig", "FlakyOps", "HealthConfig", "HealthMonitor"]
