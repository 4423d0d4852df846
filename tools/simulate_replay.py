#!/usr/bin/env python3
"""Replay chip_smoke.py's ``simulate`` phase on the CPU over a table of T_iter.

    python3 tools/simulate_replay.py TIMES.json [--reconfig-s 75.1] [--analytic]

TIMES.json holds ``{"t_fwd_unit": u, "fit": [[plan, t], ...], "other":
[[plan, t], ...]}``: each plan an ``ExecutionPlan`` keyword dict, each ``t``
a one-card T_iter in seconds (for example the ones a chip run of the
``profile`` and ``schedule`` phases printed).  The performance model is
fitted to the ``fit`` rows under TABLE2's gpt2-1.5b profile with ``u`` as its
``t_fwd_unit`` (batched engine, as the ``schedule`` phase does), and
``chip_smoke.simulate_jobs`` runs its five schedulers in both engines with an
oracle that answers every one-card plan from the table, whatever its CPU
count, as the card does.  A plan missing from the table ends the run and is
named.  ``--analytic`` answers from the analytic oracle on the
h100 ``Env`` instead (its hidden true parameters; the table then only feeds
the fit), for the same jobs.  Prints one JSON line per scheduler
(chip_smoke's ``simulate_run`` fields) and one with the plans the runs asked
for; nothing runs on a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.core.oracle import AnalyticOracle  # noqa: E402
from repro_torch.core.paper_models import TABLE2  # noqa: E402
from repro_torch.core.perfmodel import Alloc, env_for_gpu, fit  # noqa: E402
from repro_torch.parallel.plan import ExecutionPlan  # noqa: E402


class TableOracle:
    """``measure`` from a {plan: T_iter} table; ``asked`` keeps the order of
    first asks.  A plan not in the table raises ``KeyError`` naming it."""

    def __init__(self, times: dict):
        self.times = times
        self.asked: list = []

    def measure(self, profile, plan, alloc, seed=0, env=None, now=0.0) -> float:
        if plan not in self.asked:
            self.asked.append(plan)
        if plan not in self.times:
            raise KeyError(f"no T_iter for {plan.strategy} ({dataclasses.asdict(plan)})")
        return self.times[plan]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("times", type=Path)
    ap.add_argument("--reconfig-s", type=float, default=75.1,
                    help="seconds a plan change pauses a job (chip_smoke's schedule phase "
                         "measures it)")
    ap.add_argument("--analytic", action="store_true",
                    help="answer from AnalyticOracle(env=h100) instead of the table")
    args = ap.parse_args(argv)
    spec = json.loads(args.times.read_text())
    env = env_for_gpu("h100")
    profile = dataclasses.replace(TABLE2[chip_smoke.PROFILE_ARCH], t_fwd_unit=spec["t_fwd_unit"])
    rows = [(ExecutionPlan(**kw), t) for kw, t in spec["fit"] + spec.get("other", [])]
    k = fit(profile, [(plan, Alloc(1, 12), t) for plan, t in rows[:len(spec["fit"])]], env=env,
            engine="batched")
    oracle = AnalyticOracle(env=env) if args.analytic else TableOracle(dict(rows))
    out = chip_smoke.simulate_jobs(oracle, profile, k, env, args.reconfig_s)
    for name, by_mode in out["runs"].items():
        print(json.dumps({"scheduler": name, **by_mode}))
    print(json.dumps({"fit": chip_smoke.fit_params(k), "reconfig_s": args.reconfig_s,
                      "asked": [chip_smoke.plan_label(p) for p in getattr(oracle, "asked", [])]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
