"""Invariant linter CLI: ``python -m repro_torch.analysis.lint [--strict]``,
copied from ``repro.analysis.lint``.

Runs every house rule (``repro_torch.analysis.rules.ALL_RULES``) over
``src/repro_torch`` (or an explicit root), applies inline waivers, and prints
violations as ``path:line: [rule] message``.  Exit status: 0 clean, 1 on
violations; ``--strict`` additionally fails on waivers that no longer
suppress anything (so justifications cannot rot in place).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.rules import ALL_RULES, LintModule, Violation

DEFAULT_ROOT = Path(__file__).resolve().parents[1]

# the linter does not lint itself: rule modules quote the very patterns
# they flag, and the analysis layer is not a scheduling decision path
EXCLUDE_PARTS = ("analysis",)


def iter_modules(root: Path) -> list[LintModule]:
    mods = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if any(part in EXCLUDE_PARTS for part in rel.split("/")):
            continue
        mods.append(LintModule(str(path), path.read_text(), rel))
    return mods


def run_lint(root: Path | str = DEFAULT_ROOT,
             ) -> tuple[list[Violation], list[str]]:
    """Returns (violations after waivers, unused-waiver warnings)."""
    root = Path(root)
    violations: list[Violation] = []
    warnings: list[str] = []
    rules = [cls() for cls in ALL_RULES]
    for module in iter_modules(root):
        for rule in rules:
            for v in rule.check(module):
                if not module.waived(v.line, v.rule):
                    violations.append(v)
        for line, rid in module.unused_waivers():
            warnings.append(f"{module.relpath}:{line}: unused waiver "
                            f"for [{rid}]")
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations, warnings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint",
        description="house invariant linter for the scheduling core")
    ap.add_argument("root", nargs="?", default=str(DEFAULT_ROOT),
                    help="tree to lint (default: the installed repro_torch "
                         "package source)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on unused waivers")
    args = ap.parse_args(argv)
    violations, warnings = run_lint(args.root)
    for v in violations:
        print(v)
    for w in warnings:
        print(f"warning: {w}")
    if violations:
        print(f"{len(violations)} violation(s)")
        return 1
    if args.strict and warnings:
        print(f"{len(warnings)} unused waiver(s) (strict)")
        return 1
    print("clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
