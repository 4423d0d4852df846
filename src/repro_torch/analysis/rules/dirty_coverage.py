"""Rule ``dirty-coverage``: every pass-context field the decision paths
read must be invalidatable.

The incremental engine is only exact because every field consulted when
re-deriving a decision (slope order, victim indexes, park/wake state,
walk signatures) is written by at least one event/notification path
(``apply_events``/``apply_refits``/``bump_*``/``ledger_*``/``register``/
``remove``).  A field that is read during ``refresh_order``/``victims``/
park-wake repair but never written anywhere is a cache with no
invalidation story — exactly the class of bug PRs 2-4 kept fixing one
instance at a time.

Mechanics: for the configured context class, collect ``self.X`` loads in
the reader methods and ``self.X`` stores (assignments, deletes,
subscript stores, and mutating method calls) across the whole class plus
module-level ``ctx.X`` stores; flag reads with no write.  Fields that
are immutable by design are allow-listed below.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.rules.base import LintModule, Rule, Violation

# methods whose self.X loads constitute the decision read-set
READERS = {
    "refresh_order", "_order_entry", "victims", "pick_victim",
    "has_victim", "sig_for", "park_failed", "park_noop", "park_gate",
    "_quota_token", "_wake",
}

CTX_CLASS = "_PassCtx"

# set once at construction, never invalidated by design
IMMUTABLE = {"node_group", "_next_seq", "_prune_tick"}

# container method calls that mutate the receiver
_MUTATING_METHODS = {
    "add", "append", "pop", "discard", "clear", "update", "setdefault",
    "remove", "extend", "insert",
}


def _attr_of_self(expr: ast.AST, root: str = "self") -> str | None:
    if isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == root:
        return expr.attr
    return None


def _writes_in(node: ast.AST, root: str) -> set[str]:
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Assign):
            for tgt in n.targets:
                a = _attr_of_self(tgt, root)
                if a:
                    out.add(a)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            a = _attr_of_self(n.target, root)
            if a:
                out.add(a)
        elif isinstance(n, ast.Delete):
            for tgt in n.targets:
                a = _attr_of_self(tgt, root)
                if a:
                    out.add(a)
        elif isinstance(n, ast.Call):
            fn = n.func
            if isinstance(fn, ast.Attribute):
                if fn.attr in _MUTATING_METHODS:
                    a = _attr_of_self(fn.value, root)
                    if a:
                        out.add(a)
                # bisect.insort(self.order, key)-style in-place inserts
                elif fn.attr == "insort" and n.args:
                    a = _attr_of_self(n.args[0], root)
                    if a:
                        out.add(a)
    return out


class DirtyCoverageRule(Rule):
    rule_id = "dirty-coverage"
    description = ("pass-context fields read on decision paths must be "
                   "writable by some invalidation path")

    def check(self, module: LintModule) -> list[Violation]:
        cls = next((n for n in ast.walk(module.tree)
                    if isinstance(n, ast.ClassDef) and n.name == CTX_CLASS),
                   None)
        if cls is None:
            return []
        writes: set[str] = _writes_in(cls, "self")
        # module-level stores spelled through a ctx reference
        # (RubickScheduler._schedule_job resets ctx.cur_read in place)
        writes |= _writes_in(module.tree, "ctx")
        reads: dict[str, int] = {}
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name not in READERS:
                continue
            for n in ast.walk(fn):
                if isinstance(n, ast.Attribute) and \
                        isinstance(n.ctx, ast.Load) and \
                        isinstance(n.value, ast.Name) and \
                        n.value.id == "self":
                    reads.setdefault(n.attr, n.lineno)
        out: list[Violation] = []
        for attr, line in sorted(reads.items(), key=lambda kv: kv[1]):
            if attr in writes or attr in IMMUTABLE:
                continue
            if attr in READERS or any(
                    isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and f.name == attr for f in cls.body):
                continue        # method reference, not a data field
            out.append(Violation(
                module.relpath, line, self.rule_id,
                f"{CTX_CLASS}.{attr} is read on a decision path but no "
                f"event/notification path ever writes it — stale forever"))
        return out
