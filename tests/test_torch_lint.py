"""The port's static invariant linter (``repro_torch.analysis.lint``) against
the reference's (``repro.analysis.lint``), on the CPU.

The counterpart of tests/test_analysis_lint.py: every rule case there (a
flagged snippet and its accepted fix, run through ``LintModule`` at a
relpath that hits the rule's file/scope gating) is run through the port's
rule, and each must report the same violations, by rule, line and message,
as the reference's rule on the same snippet.  Then the waiver mechanics,
``parse_shapes``, the ``Shapes:`` contract of the port's
``core.memory.estimate_batch`` against a live call, the CLI's exit codes,
and the snapshot: ``src/repro_torch`` carries no violation and no stale
waiver under every house rule.
"""

import textwrap

import numpy as np
import pytest

from repro.analysis import rules as jrules
from repro_torch.analysis import rules
from repro_torch.analysis.lint import main as lint_main
from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.rules.base import LintModule
from repro_torch.analysis.rules.shape_contracts import parse_shapes

MEMO, ROLLBACK, DIRTY, DETERMINISM, SHAPES = ("MemoScopingRule", "RollbackRule",
                                              "DirtyCoverageRule", "DeterminismRule",
                                              "ShapeContractRule")

# (id, rule class name, source, relpath, the violations' rule ids, a
# substring each of some messages must hold)
CASES = [
    ("memo-unpinned-key", MEMO, """
        class Memo:
            def note(self, js, val):
                self.seen[id(js)] = val
     """, "core/snippet.py", ["unscoped-id"], ["seen"]),
    ("memo-pinned", MEMO, """
        class Ctx:
            def register(self, js, slope):
                self.members[id(js)] = js          # self-pinned
                self.slopes[id(js)] = slope        # covered by class pin
     """, "core/snippet.py", [], []),
    ("memo-unpinned-walk-sig", MEMO, """
        def _walk_sig(js):
            return (id(js.job.profile), id(js.fitted))

        class Ctx:
            def park(self, js):
                self.parked.add(_walk_sig(js))
     """, "core/snippet.py", ["unscoped-id"], ["parked"]),
    ("memo-sig-with-pins", MEMO, """
        def _walk_sig(js):
            return (id(js.job.profile), id(js.fitted))

        class Ctx:
            def park(self, js):
                sig = _walk_sig(js)
                self.parked.add(sig)
                self.parked_pins[sig] = (js.job.profile, js.fitted)
     """, "core/snippet.py", [], []),
    ("rollback-unrestored", ROLLBACK, """
        class RubickScheduler:
            def _shrink(self, victim, ctx):
                victim.placement = {}
                victim.plan = None
                ctx.mark_dirty(victim)
                ctx.bump_node(3)

            def _undo(self, shrunk, ctx):
                for victim, placement in shrunk.values():
                    victim.placement = placement
                    ctx.mark_dirty(victim)
     """, "core/scheduler.py", ["rollback-incomplete"] * 2, ["victim.plan", "bump_node"]),
    ("rollback-complete", ROLLBACK, """
        class RubickScheduler:
            def _shrink(self, victim, ctx):
                victim.placement = {}
                victim.plan = None
                ctx.mark_dirty(victim)

            def _undo(self, shrunk, ctx):
                for victim, placement, plan in shrunk.values():
                    victim.placement = placement
                    victim.plan = plan
                    ctx.mark_dirty(victim)
     """, "core/scheduler.py", [], []),
    ("rollback-table-drift", ROLLBACK, "class Other:\n    pass\n", "core/scheduler.py",
     ["rollback-incomplete"], ["not found"]),
    ("rollback-samefn-no-restore", ROLLBACK, """
        class AntManLike:
            def _try_preempt(self, need, active, used):
                saved = []
                for victim in active:
                    saved.append((victim, victim.placement))
                    victim.status = "queued"
                    victim.placement = {}
                return False
     """, "core/baselines.py", ["rollback-incomplete"] * 2,
     ["victim.status", "victim.placement"]),
    ("rollback-samefn-restored", ROLLBACK, """
        class AntManLike:
            def _try_preempt(self, need, active, used):
                saved = []
                for victim in active:
                    saved.append((victim, victim.placement))
                    victim.status = "queued"
                    victim.placement = {}
                for victim, placement in saved:
                    victim.status = "running"
                    victim.placement = placement
                return False
     """, "core/baselines.py", [], []),
    ("dirty-never-written", DIRTY, """
        class _PassCtx:
            def __init__(self):
                self.order = []

            def refresh_order(self):
                return list(self.phantom) + self.order
     """, "core/snippet.py", ["dirty-coverage"], ["phantom"]),
    ("dirty-ctx-spelled-write", DIRTY, """
        class _PassCtx:
            def __init__(self):
                self.order = []

            def refresh_order(self):
                return list(self.phantom) + self.order

        def apply_events(ctx, events):
            ctx.phantom = ()
     """, "core/snippet.py", [], []),
    ("determinism-wallclock-rng", DETERMINISM, """
        import time
        import numpy as np

        def decide(jobs):
            rng = np.random.default_rng()
            return time.time() + np.random.rand()
     """, "core/snippet.py", ["nondeterminism"] * 3,
     ["time.time", "without a seed", "np.random.rand"]),
    ("determinism-out-of-scope", DETERMINISM, """
        import time

        def decide(jobs):
            return time.time()
     """, "bench/snippet.py", [], []),
    ("determinism-seeded", DETERMINISM, """
        import time
        import numpy as np

        def decide(jobs, seed):
            rng = np.random.default_rng(seed)
            t0 = time.perf_counter()
            return rng.random(), t0
     """, "core/snippet.py", [], []),
    ("determinism-id-ordered", DETERMINISM, """
        def pick(jobs):
            memo = {}
            for j in jobs:
                memo[id(j)] = j
            for jid, js in memo.items():
                js.step()
     """, "core/snippet.py", ["nondeterminism"], ["sorted()"]),
    ("determinism-id-sorted", DETERMINISM, """
        def pick(jobs):
            memo = {}
            for j in jobs:
                memo[id(j)] = j
            for jid in sorted(memo):
                memo[jid].step()
     """, "core/snippet.py", [], []),
    ("determinism-print-logging", DETERMINISM, """
        import logging

        def decide(js):
            print("admitting", js)
            logging.getLogger("sched").info("admit %s", js)
     """, "core/snippet.py", ["nondeterminism"] * 2, ["print()", "getLogger"]),
    ("determinism-span", DETERMINISM, """
        from time import perf_counter

        def schedule(self, rec, now):
            t0 = perf_counter()
            rec.span_since("pass", t0, now)
     """, "core/snippet.py", ["nondeterminism"], ["Perfetto"]),
    ("determinism-wallclock-decision", DETERMINISM, """
        from time import perf_counter

        def admit(rec, js, now):
            rec.decision("admit", perf_counter(), job=js.name)
     """, "core/snippet.py", ["nondeterminism"], ["sim time"]),
    ("determinism-sim-time", DETERMINISM, """
        def admit(rec, js, now):
            rec.decision("admit", now, job=js.name)
            rec.sample(now, gpu_util=0.5)
     """, "core/snippet.py", [], []),
    ("shape-missing", SHAPES, """
        def foo_batch(x, y):
            '''No contract at all.'''
            return x + y

        def bar_batch(x, y):
            '''Partial.

            Shapes:
                x: (S,) xs
            '''
            return x + y
     """, "core/perfmodel.py", ["shape-contract"] * 3,
     ["no Shapes", "misses parameter(s) y", "misses the 'returns'"]),
    ("shape-complete", SHAPES, """
        def foo_batch(x, y):
            '''Batched twin.

            Shapes:
                x: (S,) xs
                y: (S,) ys
                returns: (S,) sums
            '''
            return x + y

        def loss(z_rows, t):
            '''Shapes:
                z_rows: (R, 7) parameter rows
                t: (S,) samples
                returns: (R,) loss
            '''
            return z_rows
     """, "core/fitting.py", [], []),
    ("shape-bare-loss", SHAPES, """
        def loss(z_rows, t):
            return z_rows
     """, "core/fitting.py", ["shape-contract"], ["loss"]),
    ("shape-out-of-scope", SHAPES, """
        def foo_batch(x, y):
            return x + y
     """, "core/scheduler.py", [], []),
]


def _mod(source: str, relpath: str, package=rules) -> LintModule:
    return package.LintModule("<test>", textwrap.dedent(source), relpath)


def _report(package, rule_name: str, source: str, relpath: str):
    """(line, rule id, message) of each violation the package's rule reports."""
    rule = getattr(package, rule_name)()
    return [(v.line, v.rule, v.message) for v in rule.check(_mod(source, relpath, package))]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rule_case(case):
    _, rule_name, source, relpath, want_rules, want_text = case
    got = _report(rules, rule_name, source, relpath)
    assert [r for _, r, _ in got] == want_rules
    text = " | ".join(m for _, _, m in got)
    for part in want_text:
        assert part in text, (part, text)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_both_linters_report_the_same(case):
    """The port's rule and the reference's on the same snippet: the same
    violations, by line, rule and message."""
    _, rule_name, source, relpath, _, _ = case
    assert _report(rules, rule_name, source, relpath) == \
        _report(jrules, rule_name, source, relpath)


def test_rule_tables_match_reference():
    assert [r.__name__ for r in rules.ALL_RULES] == [r.__name__ for r in jrules.ALL_RULES]


def test_waiver_suppresses_and_is_marked_used():
    mod = _mod("""
        class Memo:
            def note(self, js, val):
                # lint: unscoped-id — entries dropped before js can die
                self.seen[id(js)] = val
    """, "core/snippet.py")
    vs = [v for v in rules.MemoScopingRule().check(mod) if not mod.waived(v.line, v.rule)]
    assert vs == []
    assert mod.unused_waivers() == []


def test_unused_waiver_is_reported():
    mod = _mod("""
        # lint: unscoped-id — nothing here needs this
        X = 1
    """, "core/snippet.py")
    assert rules.MemoScopingRule().check(mod) == []
    assert mod.unused_waivers() == [(2, "unscoped-id")]


def test_span_waiver_acknowledges_the_wall_clock_channel():
    mod = _mod("""
        from time import perf_counter

        def schedule(self, rec, now):
            t0 = perf_counter()
            # lint: nondeterminism -- profiler span, wall clock by design
            rec.span_since("pass", t0, now)
    """, "core/snippet.py")
    assert [v for v in rules.DeterminismRule().check(mod)
            if not mod.waived(v.line, v.rule)] == []


def test_parse_shapes_extraction():
    assert parse_shapes(None) is None
    assert parse_shapes("just prose, no block") is None
    decls = parse_shapes("Twin.\n\nShapes:\n    x: (S,) xs\n    returns: (S,) out\n\ntail")
    assert decls == {"x": "(S,) xs", "returns": "(S,) out"}


def test_estimate_batch_honors_declared_shapes():
    """The port's contract matches its live call: scalar allocs against an
    (S,) plan table broadcast to (S,), per the declaration."""
    from repro_torch.core import memory, paper_models
    from repro_torch.core.perfmodel import Env
    from repro_torch.parallel import plan_table

    decls = parse_shapes(memory.estimate_batch.__doc__)
    assert decls is not None
    assert {"profile", "cols", "alloc_gpus", "alloc_cpus", "env", "returns"} <= set(decls)
    prof = paper_models.profile("gpt2-1.5b")
    tbl = plan_table.get(prof.b, 16, 8)
    gpu, host, cpu = memory.estimate_batch(prof, tbl.cols, np.asarray(8), np.asarray(64), Env())
    want = np.broadcast_shapes((len(tbl.cols),), np.shape(np.asarray(8)))
    assert gpu.shape == host.shape == cpu.shape == want


@pytest.mark.parametrize("strict", [False, True], ids=["default", "strict"])
def test_cli_exit_codes(strict, tmp_path, capsys):
    flags = ["--strict"] if strict else []
    core = tmp_path / "core"
    core.mkdir()
    bad = core / "bad.py"
    bad.write_text("import time\n\ndef f():\n    return time.time()\n")
    assert lint_main([str(tmp_path), *flags]) == 1
    assert "time.time" in capsys.readouterr().out
    bad.write_text("def f():\n    return 1\n")
    assert lint_main([str(tmp_path), *flags]) == 0
    assert capsys.readouterr().out.strip().endswith("clean")
    # a waiver that suppresses nothing fails in strict mode only
    bad.write_text("# lint: nondeterminism — stale\ndef f():\n    return 1\n")
    assert lint_main([str(tmp_path), *flags]) == int(strict)


def test_cli_runs_as_a_module():
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", "--strict"],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("clean")


def test_live_tree_is_clean():
    """The acceptance snapshot: src/repro_torch carries zero violations and
    zero stale waivers under every house rule."""
    from repro_torch.analysis import lint

    assert lint.DEFAULT_ROOT.name == "repro_torch"
    violations, warnings = run_lint()
    assert violations == []
    assert warnings == []
