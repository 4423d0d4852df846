"""Flight recorder: structured decision traces, time-series metrics and
pass-profiler spans for one simulation run.

A copy of ``repro.obs.recorder`` for the port.

Design contract (the reason the simulator/scheduler hooks are safe to
leave in hot paths):

  * **zero-cost when disabled** — every emit site is guarded by a single
    ``if rec is not None`` branch; with no recorder attached the engines
    execute byte-identical decision code (pinned by
    ``tests/test_torch_obs.py::test_recorder_off_bit_exact``);
  * **sim-time stamped** — decision events and series samples carry the
    simulation clock, never wall-clock, so a traced run is replayable
    and two runs of the same seed produce byte-identical JSONL exports
    (the ``nondeterminism`` lint rule enforces this at emit sites in
    ``core/``);
  * **wall-clock quarantined** — profiler spans are the ONE channel that
    reads ``time.perf_counter``; they live in a separate ring and are
    exported only to the Chrome-trace/Perfetto file, never the JSONL
    decision log.

Everything is ring-buffered (``collections.deque(maxlen=...)``) so a
week-long trace cannot grow without bound; drop counts are kept so a
truncated export says so instead of silently looking complete.
"""

from __future__ import annotations

import time
from collections import deque

# decision-event kinds the recorder knows how to emit.  Exports validate
# against this set (see export.KIND_FIELDS) so a typo'd emit site fails a
# schema round-trip test instead of producing an unparseable log.
KINDS = ("arrival", "admit", "reconfig", "shrink", "preempt", "park",
         "wake", "capacity", "evict", "checkpoint", "pause", "complete",
         "refit", "degrade", "quarantine", "retry", "mitigate")


class _Ring:
    """Bounded append-only buffer that remembers how much it dropped."""

    __slots__ = ("_d", "n_total")

    def __init__(self, cap: int):
        self._d = deque(maxlen=cap)
        self.n_total = 0

    def append(self, item) -> None:
        self._d.append(item)
        self.n_total += 1

    @property
    def n_dropped(self) -> int:
        return self.n_total - len(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)


class FlightRecorder:
    """One recorder per simulation run (attach via ``Simulator(...,
    recorder=FlightRecorder())``; the simulator threads it into the
    scheduler and calibration manager automatically)."""

    def __init__(self, max_events: int = 1 << 18,
                 max_samples: int = 1 << 16, max_spans: int = 1 << 16,
                 meta: dict | None = None):
        self.meta: dict = dict(meta or {})
        self.events = _Ring(max_events)
        self.spans = _Ring(max_spans)
        self.series: dict[str, _Ring] = {}
        self._max_samples = max_samples
        self.counts: dict[str, int] = {}
        # downtime accounting (SimResult paused seconds are
        # DERIVED from these, not counted ad hoc by the engines)
        self.pause_s: dict[str, float] = {}           # kind -> seconds
        self.pause_by_job: dict[str, dict[str, float]] = {}
        self._digest: list | None = None
        self._seq = 0

    # -- decision traces -----------------------------------------------
    def decision(self, kind: str, t: float, job: str | None = None,
                 cause: str | None = None, data: dict | None = None) -> dict:
        """Emit one structured decision event stamped with sim time
        ``t``.  ``cause`` is the provenance hook (the beneficiary of a
        shrink, the park reason, the trigger of an eviction)."""
        self._seq += 1
        ev: dict = {"seq": self._seq, "t": t, "kind": kind}
        if job is not None:
            ev["job"] = job
        if cause is not None:
            ev["cause"] = cause
        if self._digest is not None:
            ev["digest"] = self._digest
        if data:
            ev["data"] = data
        self.events.append(ev)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        return ev

    def set_digest(self, digest: list | tuple) -> None:
        """Cluster-state digest ``[n_running, n_queued, used_gpus,
        live_gpus]`` stamped onto subsequent decision events; the engines
        refresh it at every event boundary."""
        self._digest = list(digest)

    def pause(self, job: str, kind: str, seconds: float,
              t: float) -> None:
        """Account downtime (``kind`` is ``"reconfig"`` or ``"restore"``)
        and emit the matching decision event."""
        if seconds <= 0.0:
            return
        self.pause_s[kind] = self.pause_s.get(kind, 0.0) + seconds
        per = self.pause_by_job.setdefault(job, {})
        per[kind] = per.get(kind, 0.0) + seconds
        self.decision("pause", t, job=job, cause=kind,
                      data={"seconds": seconds})

    # -- time-series metrics -------------------------------------------
    def sample(self, t: float, **gauges) -> None:
        """Append one point per named gauge at sim time ``t``."""
        for name, value in gauges.items():
            ring = self.series.get(name)
            if ring is None:
                ring = self.series[name] = _Ring(self._max_samples)
            ring.append((t, float(value)))

    # -- pass profiler (wall-clock; Perfetto-only channel) --------------
    def span(self, name: str, t0: float, t1: float, sim_t: float = 0.0,
             **data) -> None:
        span = {"name": name, "t0": t0, "t1": t1, "sim_t": sim_t}
        if data:
            span.update(data)
        self.spans.append(span)

    def span_since(self, name: str, t0: float, sim_t: float = 0.0,
                   **data) -> None:
        """Close a span opened at wall-clock ``t0`` (from
        ``perf_counter``) ending now.  The single perf_counter read keeps
        emit sites in ``core/`` down to one guarded call."""
        self.span(name, t0, time.perf_counter(), sim_t, **data)

    # -- derived accounting --------------------------------------------
    @property
    def total_paused_s(self) -> float:
        return sum(self.pause_s.values())

    def downtime_by_job(self) -> dict[str, float]:
        """Total paused seconds per job (reconfig + restore)."""
        return {job: sum(kinds.values())
                for job, kinds in self.pause_by_job.items()}

    def span_totals(self) -> dict[str, dict]:
        """Wall-clock seconds and call counts aggregated by span name."""
        out: dict[str, dict] = {}
        for sp in self.spans:
            agg = out.setdefault(sp["name"], {"n": 0, "total_s": 0.0})
            agg["n"] += 1
            agg["total_s"] += sp["t1"] - sp["t0"]
        return out

    def summary(self) -> dict:
        return {
            "n_events": self.events.n_total,
            "n_events_dropped": self.events.n_dropped,
            "counts": dict(self.counts),
            "series": {name: len(ring)
                       for name, ring in self.series.items()},
            "total_paused_s": self.total_paused_s,
            "paused_s_by_kind": dict(self.pause_s),
            "span_totals": self.span_totals(),
            "meta": dict(self.meta),
        }
