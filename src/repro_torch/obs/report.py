"""Trace reporting CLI.

A copy of ``repro.obs.report`` for the port.

    python -m repro_torch.obs.report summary TRACE.jsonl [--perfetto X.json]
    python -m repro_torch.obs.report diff A.jsonl B.jsonl
    python -m repro_torch.obs.report validate TRACE.jsonl [...]

``summary`` renders one run: event counts, downtime accounting, metric
series digests, the shrink-recovery attribution table (every eviction
joined back to the capacity events that triggered it), and — when the
matching Perfetto file is given — the pass-profiler phase breakdown.

``diff`` compares two decision logs side by side (e.g. shrink vs kill
recovery of the same storm): per-kind event counts, completions/JCTs,
paused seconds.

``validate`` schema-checks each file and exits non-zero on the first
violation (the CI smoke gate).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.obs.export import (Trace, TraceSchemaError, read_jsonl,
                                    validate_events)


def _fmt_h(seconds: float) -> str:
    return f"{seconds / 3600.0:.3f}h"


def _jcts(trace: Trace) -> list[float]:
    return [ev["data"]["jct"] for ev in trace.by_kind("complete")
            if "jct" in ev.get("data", {})]


def attribution(trace: Trace) -> list[dict]:
    """Join every eviction to the capacity events of the same instant:
    each row says which node flips triggered it, which job was hit, and
    what the recovery chose (the acceptance-criterion table)."""
    cap_by_t: dict[float, list[dict]] = {}
    for ev in trace.by_kind("capacity"):
        cap_by_t.setdefault(ev["t"], []).append(ev)
    rows = []
    for ev in trace.by_kind("evict"):
        trigs = [c["data"] for c in cap_by_t.get(ev["t"], [])
                 if c["data"].get("node") in ev["data"].get("nodes", [])]
        rows.append({"t": ev["t"], "job": ev["job"],
                     "outcome": ev["cause"],
                     "lost_nodes": ev["data"].get("nodes", []),
                     "triggers": trigs})
    return rows


def gray_failures(trace: Trace) -> list[dict]:
    """Join every quarantine decision to the degradation events that
    preceded it on the same node, plus the mitigations (migrate-away /
    rollback) it triggered — the gray-failure counterpart of the
    capacity ``attribution`` table."""
    deg_by_node: dict[int, list[dict]] = {}
    for ev in trace.by_kind("degrade"):
        deg_by_node.setdefault(ev["data"]["node"], []).append(ev)
    rows = []
    for ev in trace.by_kind("quarantine"):
        if not ev["data"].get("on", True):
            continue
        node = ev["data"]["node"]
        trigs = [d["data"] for d in deg_by_node.get(node, [])
                 if d["t"] <= ev["t"] and d["data"].get("factor", 1) > 1]
        mits = [m for m in trace.by_kind("mitigate") if m["t"] == ev["t"]]
        rows.append({"t": ev["t"], "node": node,
                     "score": ev["data"].get("score"),
                     "triggers": trigs,
                     "mitigations": [(m["job"], m["cause"]) for m in mits]})
    return rows


def _series_digest(points: list) -> dict:
    if not points:
        return {"n": 0}
    vals = [v for _, v in points]
    return {"n": len(points), "min": round(min(vals), 4),
            "mean": round(sum(vals) / len(vals), 4),
            "max": round(max(vals), 4), "last": round(vals[-1], 4)}


def summary(path: str, perfetto: str | None = None,
            out=None) -> int:
    out = out if out is not None else sys.stdout
    tr = read_jsonl(path)
    print(f"# flight-recorder summary: {path}", file=out)
    meta = tr.meta.get("meta", {})
    if meta:
        print(f"  run: {json.dumps(meta, sort_keys=True)}", file=out)
    dur = max((ev["t"] for ev in tr.events), default=0.0)
    print(f"  events: {len(tr.events)} over {_fmt_h(dur)} sim "
          f"({tr.meta.get('n_events_dropped', 0)} dropped)", file=out)
    for kind in sorted(tr.counts):
        print(f"    {kind:<12} {tr.counts[kind]}", file=out)
    jcts = _jcts(tr)
    if jcts:
        print(f"  completions: {len(jcts)}, avg JCT "
              f"{_fmt_h(sum(jcts) / len(jcts))}", file=out)
    paused = tr.meta.get("paused_s_by_kind", {})
    if paused:
        tot = sum(paused.values())
        detail = ", ".join(f"{k} {_fmt_h(v)}"
                           for k, v in sorted(paused.items()))
        print(f"  downtime: {_fmt_h(tot)} total ({detail})", file=out)
        worst = sorted(tr.meta.get("downtime_by_job", {}).items(),
                       key=lambda kv: -kv[1])[:5]
        for job, s in worst:
            print(f"    {job:<12} {_fmt_h(s)}", file=out)
    rows = attribution(tr)
    if rows:
        n_attr = sum(1 for r in rows if r["triggers"])
        print(f"  evictions: {len(rows)} ({n_attr} attributed to "
              f"capacity events)", file=out)
        for r in rows:
            kinds = ",".join(t.get("kind", "?") for t in r["triggers"])
            print(f"    t={r['t']:>10.1f}s {r['job']:<12} "
                  f"{r['outcome']:<7} nodes={r['lost_nodes']} "
                  f"via [{kinds}]", file=out)
    gf = gray_failures(tr)
    if gf:
        n_retry = tr.counts.get("retry", 0)
        print(f"  quarantines: {len(gf)} "
              f"(degrade events {tr.counts.get('degrade', 0)}, "
              f"op retries {n_retry})", file=out)
        for r in gf:
            mits = ", ".join(f"{j}:{c}" for j, c in r["mitigations"]) \
                or "-"
            print(f"    t={r['t']:>10.1f}s node={r['node']} "
                  f"score={r['score']:.2f} "
                  f"deg_events={len(r['triggers'])} moved=[{mits}]",
                  file=out)
    for name in sorted(tr.series):
        print(f"  series {name:<22} {_series_digest(tr.series[name])}",
              file=out)
    if perfetto:
        spans: dict[str, list[float]] = {}
        for ev in json.loads(Path(perfetto).read_text())["traceEvents"]:
            if ev.get("ph") == "X":
                spans.setdefault(ev["name"], []).append(
                    ev.get("dur", 0.0) / 1e6)
        if spans:
            print("  profiler phases (wall clock):", file=out)
            total = sum(sum(v) for v in spans.values())
            for name, durs in sorted(spans.items(),
                                     key=lambda kv: -sum(kv[1])):
                s = sum(durs)
                pct = 100.0 * s / total if total else 0.0
                print(f"    {name:<20} {s:8.3f}s  n={len(durs):<6} "
                      f"{pct:5.1f}%", file=out)
    return 0


def diff(path_a: str, path_b: str, out=None) -> int:
    out = out if out is not None else sys.stdout
    a, b = read_jsonl(path_a), read_jsonl(path_b)
    print(f"# trace diff\n#   A = {path_a}\n#   B = {path_b}", file=out)
    kinds = sorted(set(a.counts) | set(b.counts))
    print(f"  {'kind':<12} {'A':>8} {'B':>8} {'delta':>8}", file=out)
    for kind in kinds:
        ca, cb = a.counts.get(kind, 0), b.counts.get(kind, 0)
        print(f"  {kind:<12} {ca:>8} {cb:>8} {cb - ca:>+8}", file=out)
    ja, jb = _jcts(a), _jcts(b)
    if ja and jb:
        ma, mb = sum(ja) / len(ja), sum(jb) / len(jb)
        print(f"  avg JCT: A {_fmt_h(ma)}  B {_fmt_h(mb)}  "
              f"({(mb - ma) / max(ma, 1e-9) * 100:+.1f}%)", file=out)
    pa = sum(a.meta.get("paused_s_by_kind", {}).values())
    pb = sum(b.meta.get("paused_s_by_kind", {}).values())
    print(f"  paused: A {_fmt_h(pa)}  B {_fmt_h(pb)}", file=out)
    ea = sum(1 for r in attribution(a) if r["outcome"] == "shrunk")
    eb = sum(1 for r in attribution(b) if r["outcome"] == "shrunk")
    print(f"  shrink-recoveries: A {ea}  B {eb}", file=out)
    return 0


def validate(paths: list[str], out=None) -> int:
    out = out if out is not None else sys.stdout
    rc = 0
    for path in paths:
        tr = read_jsonl(path)
        try:
            n = validate_events(tr.events)
        except TraceSchemaError as e:
            print(f"{path}: SCHEMA VIOLATION: {e}", file=sys.stderr)
            rc = 1
            continue
        print(f"{path}: ok ({n} events, schema "
              f"{tr.meta.get('schema')})", file=out)
        if n == 0:
            print(f"{path}: empty decision log", file=sys.stderr)
            rc = 1
    return rc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs.report",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summary", help="render one trace")
    s.add_argument("trace")
    s.add_argument("--perfetto", default=None,
                   help="matching Perfetto JSON for the phase breakdown")
    d = sub.add_parser("diff", help="compare two traces")
    d.add_argument("trace_a")
    d.add_argument("trace_b")
    v = sub.add_parser("validate", help="schema-check traces")
    v.add_argument("traces", nargs="+")
    args = ap.parse_args(argv)
    if args.cmd == "summary":
        return summary(args.trace, args.perfetto)
    if args.cmd == "diff":
        return diff(args.trace_a, args.trace_b)
    return validate(args.traces)


if __name__ == "__main__":
    raise SystemExit(main())
