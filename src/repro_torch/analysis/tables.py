"""Mutation-site tables: where each job/cluster attribute is written.

A copy of ``repro.analysis.tables`` for the port: ``CORE_MODULES`` are
read from this package (``src/repro_torch/core/...``), so the sites
name the port's files and lines.

One cached AST sweep over the core scheduling modules maps attribute
names (``placement``, ``status``, ``alloc``, ...) to every source site
that stores them.  The linter's rollback rule and ``SchedSanitizer``
share this: a runtime violation about, say, an inconsistent usage map
lists the candidate mutation sites so the report points at code, not
just at state.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

CORE_MODULES = ("core/scheduler.py", "core/cluster.py",
                "core/baselines.py", "core/simulator.py")


@dataclass(frozen=True)
class Site:
    file: str
    qualname: str
    line: int
    attr: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line} ({self.qualname})"


def _sites_in(tree: ast.Module, relfile: str) -> list[Site]:
    sites: list[Site] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                for n in ast.walk(child):
                    targets: list[ast.AST] = []
                    if isinstance(n, ast.Assign):
                        targets = list(n.targets)
                    elif isinstance(n, ast.AugAssign):
                        targets = [n.target]
                    elif isinstance(n, ast.Delete):
                        targets = list(n.targets)
                    for tgt in targets:
                        if isinstance(tgt, ast.Subscript):
                            tgt = tgt.value
                        if isinstance(tgt, ast.Attribute):
                            sites.append(Site(relfile, qual, n.lineno,
                                              tgt.attr))
                visit(child, f"{qual}.")
    visit(tree, "")
    return sites


@lru_cache(maxsize=None)
def mutation_table(root: str | None = None) -> dict[str, tuple[Site, ...]]:
    """attr name -> every site in the core modules that stores it."""
    base = Path(root) if root else Path(__file__).resolve().parents[1]
    table: dict[str, list[Site]] = {}
    for rel in CORE_MODULES:
        path = base / rel
        if not path.exists():
            continue
        tree = ast.parse(path.read_text(), filename=str(path))
        for site in _sites_in(tree, rel):
            table.setdefault(site.attr, []).append(site)
    return {attr: tuple(sites) for attr, sites in table.items()}


def sites_for(*attrs: str, root: str | None = None) -> tuple[Site, ...]:
    table = mutation_table(root)
    out: list[Site] = []
    for attr in attrs:
        out.extend(table.get(attr, ()))
    return tuple(out)
