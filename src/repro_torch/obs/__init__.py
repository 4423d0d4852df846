"""Observability: the scheduler flight recorder (see ``recorder``).

A copy of ``repro.obs`` for the port; ``tests/test_torch_obs.py`` holds
its JSONL export byte for byte to the reference's.

Attach a :class:`FlightRecorder` to a simulation run::

    from repro_torch.obs import FlightRecorder
    rec = FlightRecorder()
    sim = Simulator(cluster, sched, recorder=rec)
    res = sim.run(jobs)           # res.telemetry is rec

then export (``write_jsonl`` / ``write_perfetto``) and inspect with
``python -m repro_torch.obs.report``.  ``trace_enabled()`` mirrors
``repro_torch.analysis.sanitize_enabled``: benchmarks honor the
``REPRO_TRACE`` environment variable so CI can turn tracing on without
touching call sites.
"""

from __future__ import annotations

import os

from repro_torch.obs.export import (Trace, TraceSchemaError, read_jsonl,
                                    validate_event, validate_events,
                                    write_jsonl, write_perfetto)
from repro_torch.obs.recorder import KINDS, FlightRecorder

TRACE_ENV = "REPRO_TRACE"

__all__ = ["FlightRecorder", "KINDS", "Trace", "TraceSchemaError",
           "read_jsonl", "trace_enabled", "validate_event",
           "validate_events", "write_jsonl", "write_perfetto"]


def trace_enabled() -> bool:
    """True when the ``REPRO_TRACE`` environment variable asks for a
    traced run (any value but ``''``/``'0'``/``'false'``/``'no'``)."""
    return os.environ.get(TRACE_ENV, "").strip().lower() \
        not in ("", "0", "false", "no")
