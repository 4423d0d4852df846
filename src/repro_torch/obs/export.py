"""Trace export/ingest: deterministic JSONL decision logs + Chrome-trace
(Perfetto-loadable) profiler JSON, and the event schema both validate
against.

A copy of ``repro.obs.export`` for the port: the same schema
(``rubick-flight/1``), so either package reads the other's files.

Two files per traced run, with a deliberate determinism split:

  * ``write_jsonl`` — the decision log: one meta line, then every
    decision event (sim-time stamped), then one line per metric series.
    Contains NO wall-clock anywhere, so two traced runs of the same seed
    produce byte-identical files (pinned by tests).
  * ``write_perfetto`` — the profiling view: the same decision events as
    instant events on a sim-time track plus the wall-clock pass-profiler
    spans on their own track.  Load it at https://ui.perfetto.dev or
    ``chrome://tracing``.  Wall-clock lives ONLY here.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.obs.recorder import KINDS, FlightRecorder

SCHEMA_VERSION = "rubick-flight/1"

# fields required on every decision event
EVENT_REQUIRED = ("seq", "t", "kind")
# extra required fields per kind (beyond EVENT_REQUIRED); unknown kinds
# are rejected so a typo'd emit site fails loudly at validation time
KIND_FIELDS: dict[str, tuple] = {
    "arrival": ("job",),
    "admit": ("job",),
    "reconfig": ("job", "cause"),
    "shrink": ("job", "cause"),
    "preempt": ("job", "cause"),
    "park": ("job", "cause"),
    "wake": ("cause",),
    "capacity": ("data",),
    "evict": ("job", "cause", "data"),
    "checkpoint": ("job", "cause"),
    "pause": ("job", "cause", "data"),
    "complete": ("job", "data"),
    "refit": ("data",),
    "degrade": ("data",),
    "quarantine": ("data",),
    "retry": ("job", "cause", "data"),
    "mitigate": ("job", "cause", "data"),
}
assert set(KIND_FIELDS) == set(KINDS)


class TraceSchemaError(ValueError):
    pass


def validate_event(ev: dict) -> None:
    """Raise ``TraceSchemaError`` unless ``ev`` is a well-formed decision
    event: known kind, required fields present, sim time a finite
    non-negative number, monotone-positive ``seq``."""
    for f in EVENT_REQUIRED:
        if f not in ev:
            raise TraceSchemaError(f"event missing field {f!r}: {ev!r}")
    kind = ev["kind"]
    extra = KIND_FIELDS.get(kind)
    if extra is None:
        raise TraceSchemaError(f"unknown event kind {kind!r}: {ev!r}")
    for f in extra:
        if f not in ev:
            raise TraceSchemaError(
                f"{kind!r} event missing field {f!r}: {ev!r}")
    t = ev["t"]
    if not isinstance(t, (int, float)) or not t >= 0.0:
        raise TraceSchemaError(f"bad sim time {t!r}: {ev!r}")
    if not isinstance(ev["seq"], int) or ev["seq"] <= 0:
        raise TraceSchemaError(f"bad seq {ev['seq']!r}: {ev!r}")


def validate_events(events) -> int:
    """Validate a sequence of events (plus seq monotonicity); returns
    the count so callers can assert non-emptiness."""
    n = 0
    last_seq = 0
    for ev in events:
        validate_event(ev)
        if ev["seq"] <= last_seq:
            raise TraceSchemaError(
                f"seq not increasing at {ev['seq']} (after {last_seq})")
        last_seq = ev["seq"]
        n += 1
    return n


# ----------------------------------------------------------------------
# JSONL decision log (deterministic)
# ----------------------------------------------------------------------
def write_jsonl(rec: FlightRecorder, path: str | Path) -> Path:
    path = Path(path)
    with open(path, "w") as f:
        meta = {"schema": SCHEMA_VERSION,
                "meta": dict(rec.meta),
                "counts": dict(rec.counts),
                "n_events_dropped": rec.events.n_dropped,
                "paused_s_by_kind": dict(rec.pause_s),
                "downtime_by_job": rec.downtime_by_job()}
        f.write(json.dumps(meta, sort_keys=True) + "\n")
        for ev in rec.events:
            f.write(json.dumps(ev, sort_keys=True) + "\n")
        for name, ring in rec.series.items():
            line = {"series": name,
                    "n_dropped": ring.n_dropped,
                    "points": [[t, v] for t, v in ring]}
            f.write(json.dumps(line, sort_keys=True) + "\n")
    return path


@dataclass
class Trace:
    """An ingested JSONL decision log."""
    meta: dict
    events: list[dict]
    series: dict[str, list] = field(default_factory=dict)

    @property
    def counts(self) -> dict:
        return self.meta.get("counts", {})

    def by_kind(self, kind: str) -> list[dict]:
        return [ev for ev in self.events if ev["kind"] == kind]


def read_jsonl(path: str | Path) -> Trace:
    meta: dict = {}
    events: list[dict] = []
    series: dict[str, list] = {}
    with open(path) as f:
        for i, line in enumerate(f):
            rec = json.loads(line)
            if i == 0 and "schema" in rec:
                if rec["schema"] != SCHEMA_VERSION:
                    raise TraceSchemaError(
                        f"schema {rec['schema']!r} != {SCHEMA_VERSION!r}")
                meta = rec
            elif "series" in rec:
                series[rec["series"]] = rec["points"]
            else:
                events.append(rec)
    return Trace(meta=meta, events=events, series=series)


# ----------------------------------------------------------------------
# Chrome-trace / Perfetto JSON (profiling view; wall-clock allowed)
# ----------------------------------------------------------------------
def write_perfetto(rec: FlightRecorder, path: str | Path) -> Path:
    """Chrome trace-event JSON: pid 1 carries the decision events on the
    simulation clock (1 sim second == 1 displayed second), pid 2 the
    wall-clock pass-profiler spans rebased to the first span."""
    path = Path(path)
    out: list[dict] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "sim decisions (sim time)"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "scheduler profiler (wall clock)"}},
    ]
    for ev in rec.events:
        args = dict(ev.get("data", {}))
        if "cause" in ev:
            args["cause"] = ev["cause"]
        if "digest" in ev:
            args["digest"] = str(ev["digest"])
        name = ev["kind"] if "job" not in ev \
            else f"{ev['kind']}:{ev['job']}"
        out.append({"name": name, "cat": ev["kind"], "ph": "i",
                    "s": "g", "ts": ev["t"] * 1e6, "pid": 1, "tid": 1,
                    "args": args})
    base = None
    for sp in rec.spans:
        if base is None:
            base = sp["t0"]
        out.append({"name": sp["name"], "cat": "pass", "ph": "X",
                    "ts": (sp["t0"] - base) * 1e6,
                    "dur": max(sp["t1"] - sp["t0"], 0.0) * 1e6,
                    "pid": 2, "tid": 1,
                    "args": {k: v for k, v in sp.items()
                             if k not in ("name", "t0", "t1")}})
    path.write_text(json.dumps({"traceEvents": out,
                                "displayTimeUnit": "ms"}))
    return path
