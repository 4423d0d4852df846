"""Rule ``nondeterminism``: decision paths must be replayable.

Scheduling decisions must be a pure function of (jobs, cluster, fitted
params, config) — the incremental≡full parity tests and the seeded
simulation sweeps rely on it.  Within ``core/`` and ``calibration/``
this rule flags:

* wall-clock reads: ``time.time``/``time.monotonic``, ``datetime.now``/
  ``utcnow``/``today`` (``time.perf_counter`` is fine — it only feeds
  diagnostic timings, never decisions);
* unseeded randomness: the legacy ``np.random.*`` global generator,
  ``default_rng()`` with no seed, stdlib ``random.*`` module calls,
  ``os.urandom``, ``uuid.uuid4``;
* dict-order-dependent iteration over ``id()``-keyed containers:
  ``id()`` values vary run to run, so bare iteration over such a dict /
  set feeds allocator addresses into decision order unless the loop is
  order-insensitive (waive with the reason) or wrapped in ``sorted()``;
* observability leaks (flight-recorder discipline, ``repro_torch.obs``):
  - ``print(...)`` / ``logging`` on decision paths — structured events
    go through the recorder, not stdout;
  - wall-clock expressions fed into recorder DECISION channels
    (``.decision()`` / ``.sample()`` / ``.pause()`` arguments must be
    sim time — a ``perf_counter``/``time.time`` argument would make the
    JSONL decision log differ run to run);
  - profiler span emits (``.span()`` / ``.span_since()``) — the one
    sanctioned wall-clock channel, quarantined to the Perfetto export.
    Every span emit site must carry an explicit waiver acknowledging
    the wall-clock read.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.rules.base import LintModule, Rule, Violation

SCOPES = ("core/", "calibration/")

_WALLCLOCK = {("time", "time"), ("time", "monotonic"),
              ("time", "monotonic_ns"), ("time", "time_ns")}
_DATETIME_ATTRS = {"now", "utcnow", "today"}
_RANDOM_MODULES = {"random"}
# recorder channels whose arguments MUST be sim time (never wall-clock)
_SIM_TIME_EMITS = {"decision", "sample", "pause"}
# profiler span channel: wall-clock by design, waiver required per site
_SPAN_EMITS = {"span", "span_since"}
# wall-clock producers that must not leak into a decision emit's args
_WALLCLOCK_FEEDS = _WALLCLOCK | {("time", "perf_counter"),
                                 ("time", "perf_counter_ns")}


def _dotted(expr: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    return parts[::-1]


class DeterminismRule(Rule):
    rule_id = "nondeterminism"
    description = ("no wall-clock, unseeded RNG, or id()-ordered "
                   "iteration on decision paths")

    def check(self, module: LintModule) -> list[Violation]:
        if not any(s in module.relpath for s in SCOPES):
            return []
        out: list[Violation] = []
        ana = module.id_analysis()
        direct_attrs = ana.direct_attr_containers
        direct_names = {name for _, name in ana.direct_local_containers}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                v = self._check_call(module, node)
                if v:
                    out.append(v)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                v = self._check_iter(module, node.iter, direct_attrs,
                                     direct_names)
                if v:
                    out.append(v)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    v = self._check_iter(module, gen.iter, direct_attrs,
                                         direct_names)
                    if v:
                        out.append(v)
        return out

    def _check_call(self, module: LintModule,
                    node: ast.Call) -> Violation | None:
        path = _dotted(node.func)
        if not path:
            return None
        dotted = ".".join(path)
        line = node.lineno
        if path == ["print"]:
            return Violation(module.relpath, line, self.rule_id,
                             "print() on a decision path; emit a "
                             "structured recorder event instead")
        if path[0] == "logging" or path[-1] == "getLogger":
            return Violation(module.relpath, line, self.rule_id,
                             f"{dotted}() on a decision path; emit a "
                             f"structured recorder event instead")
        if len(path) >= 2 and path[-1] in _SPAN_EMITS:
            return Violation(module.relpath, line, self.rule_id,
                             f"profiler span emit {dotted}() reads wall-"
                             f"clock; waive to acknowledge (spans export "
                             f"to Perfetto only, never the JSONL log)")
        if len(path) >= 2 and path[-1] in _SIM_TIME_EMITS:
            v = self._check_emit_args(module, node, dotted)
            if v:
                return v
        if tuple(path[-2:]) in _WALLCLOCK and path[0] != "self":
            return Violation(module.relpath, line, self.rule_id,
                             f"wall-clock read {dotted}() on a decision "
                             f"path (perf_counter is fine for timings)")
        if len(path) >= 2 and path[-1] in _DATETIME_ATTRS \
                and "datetime" in path[:-1]:
            return Violation(module.relpath, line, self.rule_id,
                             f"wall-clock read {dotted}()")
        if path[-1] == "default_rng":
            if not node.args and not node.keywords:
                return Violation(module.relpath, line, self.rule_id,
                                 "default_rng() without a seed is entropy-"
                                 "seeded; pass an explicit seed")
            return None
        if len(path) >= 3 and path[0] in ("np", "numpy") \
                and path[1] == "random":
            return Violation(module.relpath, line, self.rule_id,
                             f"legacy global-state RNG {dotted}(); use a "
                             f"seeded np.random.default_rng instead")
        if len(path) == 2 and path[0] in _RANDOM_MODULES:
            return Violation(module.relpath, line, self.rule_id,
                             f"stdlib global RNG {dotted}()")
        if dotted in ("os.urandom", "uuid.uuid4", "uuid.uuid1"):
            return Violation(module.relpath, line, self.rule_id,
                             f"entropy source {dotted}()")
        return None

    def _check_emit_args(self, module: LintModule, node: ast.Call,
                         dotted: str) -> Violation | None:
        """Recorder decision channels must be fed sim time: any wall-
        clock read inside the argument list would leak run-to-run jitter
        into the (byte-deterministic) JSONL decision log."""
        args: list[ast.AST] = list(node.args)
        args += [kw.value for kw in node.keywords]
        for arg in args:
            for sub in ast.walk(arg):
                if not isinstance(sub, ast.Call):
                    continue
                p = _dotted(sub.func)
                if tuple(p[-2:]) in _WALLCLOCK_FEEDS \
                        or p in (["perf_counter"], ["perf_counter_ns"]):
                    return Violation(
                        module.relpath, node.lineno, self.rule_id,
                        f"wall-clock read {'.'.join(p)}() fed into "
                        f"{dotted}(); decision events are stamped with "
                        f"sim time only")
        return None

    def _check_iter(self, module: LintModule, it: ast.AST,
                    direct_attrs: set, direct_names: set
                    ) -> Violation | None:
        expr = it
        # foo.items()/.values()/.keys() -> look at foo
        if isinstance(expr, ast.Call) and \
                isinstance(expr.func, ast.Attribute) and \
                expr.func.attr in ("items", "values", "keys"):
            expr = expr.func.value
        name = None
        if isinstance(expr, ast.Attribute):
            if expr.attr in direct_attrs:
                name = expr.attr
        elif isinstance(expr, ast.Name):
            if expr.id in direct_names:
                name = expr.id
        if name is None:
            return None
        return Violation(
            module.relpath, it.lineno, self.rule_id,
            f"iteration over id()-keyed container '{name}' is allocator-"
            f"address ordered; wrap in sorted() or waive if the loop is "
            f"order-insensitive")
