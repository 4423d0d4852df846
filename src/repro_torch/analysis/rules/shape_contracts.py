"""Rule ``shape-contract``: batch kernels must declare their shapes.

The (K,7) parameter-matrix / (S,) sample-vector broadcasting in
``perfmodel``/``fitting`` is where the reference's near-miss bugs lived: a silent
NumPy broadcast turns a wrong-shape argument into a wrong-answer, not a
crash.  Every batch-shaped function (name ending ``_batch`` plus the
explicitly listed kernels) must carry a ``Shapes:`` docstring block
declaring each parameter and the return, e.g.::

    Shapes:
        z_rows: (R, 7) fitted-parameter rows
        t: (S,) per-sample iteration times
        returns: (R,) loss per row

The block is machine-parsed (``parse_shapes``) — the lint rule checks
coverage; ``tests/test_analysis_lint.py`` validates declarations against
live calls.
"""

from __future__ import annotations

import ast
import re

from repro_torch.analysis.rules.base import LintModule, Rule, Violation

FILES = ("core/perfmodel.py", "core/fitting.py", "core/memory.py")

# batch-shaped kernels without the _batch suffix
EXTRA_FUNCS = {"titer_statics", "titer_from_statics", "sample_arrays",
               "loss"}

_DECL_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(\S.*)$")


def parse_shapes(doc: str | None) -> dict[str, str] | None:
    """Extract the ``Shapes:`` block as {param: declaration}; None when
    the docstring has no block."""
    if not doc:
        return None
    lines = doc.splitlines()
    out: dict[str, str] = {}
    in_block = False
    for raw in lines:
        if raw.strip() == "Shapes:":
            in_block = True
            continue
        if not in_block:
            continue
        if not raw.strip():
            break
        m = _DECL_RE.match(raw)
        if m:
            out[m.group(1)] = m.group(2).strip()
        else:
            break
    return out if in_block else None


def _params(fn: ast.FunctionDef) -> list[str]:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    return [n for n in names if n != "self"]


class ShapeContractRule(Rule):
    rule_id = "shape-contract"
    description = ("batch functions must declare a Shapes: block "
                   "covering every parameter and the return")

    def check(self, module: LintModule) -> list[Violation]:
        if not any(module.relpath.endswith(f) for f in FILES):
            return []
        out: list[Violation] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            if not (node.name.endswith("_batch")
                    or node.name in EXTRA_FUNCS):
                continue
            decls = parse_shapes(ast.get_docstring(node))
            if decls is None:
                out.append(Violation(
                    module.relpath, node.lineno, self.rule_id,
                    f"batch function '{node.name}' has no Shapes: "
                    f"docstring block"))
                continue
            missing = [p for p in _params(node) if p not in decls]
            if missing:
                out.append(Violation(
                    module.relpath, node.lineno, self.rule_id,
                    f"'{node.name}' Shapes: block misses parameter(s) "
                    f"{', '.join(missing)}"))
            if "returns" not in decls:
                out.append(Violation(
                    module.relpath, node.lineno, self.rule_id,
                    f"'{node.name}' Shapes: block misses the 'returns' "
                    f"entry"))
        return out
