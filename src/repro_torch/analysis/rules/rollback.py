"""Rule ``rollback-incomplete``: walk mutations need paired restores.

Two checked shapes, configured by (file-suffix, function) tables:

* cross-function pairs — every attribute the mutator writes on its
  victim parameter must be re-assigned by the paired undo function, and
  every pass-context notification the mutator issues (``mark_dirty`` /
  ``bump_*`` / ``ledger_*``) must be re-issued on the rollback path
  (``RubickScheduler._shrink`` vs ``_undo``);
* same-function pairs — preemption loops that roll back inline must
  assign each victim attribute in at least two distinct ``for`` loops
  (the mutation loop and the restore loop;
  ``AntManLike._try_preempt``-style).

The extracted mutation-site tables double as the provenance source for
``SchedSanitizer`` violations (``repro_torch.analysis.tables``).
"""

from __future__ import annotations

import ast

from repro_torch.analysis.rules.base import (FunctionIndex, LintModule, Rule,
                                       Violation)

# (file suffix, mutator qualname, undo qualname, victim variable)
CROSS_PAIRS = [
    ("core/scheduler.py", "RubickScheduler._shrink",
     "RubickScheduler._undo", "victim"),
]

# (file suffix, function qualname, victim variable)
SAMEFN_PAIRS = [
    ("core/baselines.py", "AntManLike._try_preempt", "victim"),
]

# pass-context notification calls that must be mirrored on rollback
_CTX_NOTIFY = ("mark_dirty", "bump_node", "bump_nodes", "bump_quota",
               "ledger_add_live", "ledger_add_reserved")


def _attr_writes(fn: ast.AST, var: str) -> dict[str, int]:
    """attr -> first line where ``var.attr`` is written (assign /
    augassign / delete, including subscript stores into ``var.attr``)."""
    out: dict[str, int] = {}

    def mark(expr: ast.AST, line: int) -> None:
        # var.attr or var.attr[...] targets
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == var:
            out.setdefault(expr.attr, line)

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                mark(tgt, node.lineno)
        elif isinstance(node, ast.AugAssign):
            mark(node.target, node.lineno)
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                mark(tgt, node.lineno)
    return out


def _ctx_calls(fn: ast.AST) -> set[str]:
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _CTX_NOTIFY:
            out.add(node.func.attr)
    return out


class RollbackRule(Rule):
    rule_id = "rollback-incomplete"
    description = ("every walk mutation needs a paired restore in the "
                   "undo path")

    def check(self, module: LintModule) -> list[Violation]:
        out: list[Violation] = []
        idx = None
        for suffix, mut_q, undo_q, var in CROSS_PAIRS:
            if not module.relpath.endswith(suffix):
                continue
            idx = idx or FunctionIndex.build(module.tree)
            mut = idx.by_qualname.get(mut_q)
            undo = idx.by_qualname.get(undo_q)
            if mut is None or undo is None:
                missing = mut_q if mut is None else undo_q
                out.append(Violation(
                    module.relpath, 1, self.rule_id,
                    f"configured rollback pair member '{missing}' not "
                    f"found — update rules/rollback.py tables"))
                continue
            mutated = _attr_writes(mut, var)
            restored = set(_attr_writes(undo, var))
            for attr, line in sorted(mutated.items(),
                                     key=lambda kv: kv[1]):
                if attr not in restored:
                    out.append(Violation(
                        module.relpath, line, self.rule_id,
                        f"{mut_q} mutates {var}.{attr} but {undo_q} "
                        f"never restores it"))
            missing_ctx = _ctx_calls(mut) - _ctx_calls(undo)
            for name in sorted(missing_ctx):
                out.append(Violation(
                    module.relpath, mut.lineno, self.rule_id,
                    f"{mut_q} issues ctx.{name}() but {undo_q} does not "
                    f"re-issue it on rollback"))
        for suffix, fn_q, var in SAMEFN_PAIRS:
            if not module.relpath.endswith(suffix):
                continue
            idx = idx or FunctionIndex.build(module.tree)
            fn = idx.by_qualname.get(fn_q)
            if fn is None:
                out.append(Violation(
                    module.relpath, 1, self.rule_id,
                    f"configured rollback function '{fn_q}' not found — "
                    f"update rules/rollback.py tables"))
                continue
            loops_of: dict[str, set[int]] = {}
            first_line: dict[str, int] = {}
            for loop in [n for n in ast.walk(fn) if isinstance(n, ast.For)]:
                for attr, line in _attr_writes(loop, var).items():
                    loops_of.setdefault(attr, set()).add(id(loop))
                    first_line.setdefault(attr, line)
            for attr, loops in sorted(loops_of.items(),
                                      key=lambda kv: first_line[kv[0]]):
                if len(loops) < 2:
                    out.append(Violation(
                        module.relpath, first_line[attr], self.rule_id,
                        f"{fn_q} mutates {var}.{attr} in its preemption "
                        f"loop without a matching restore loop"))
        return out
