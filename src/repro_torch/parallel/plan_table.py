"""Dense plan tables — the batched counterpart of ``enumerate_plans``: a
copy of ``repro.parallel.plan_table`` over the port's ``ExecutionPlan``.

The Rubick scheduler evaluates T_iter for every candidate execution plan ×
GPU count × job on every scheduling tick.  Doing that through per-plan
Python objects makes the inner loop an interpreter; this module flattens
the plan space once per ``(global_batch, max_gpus, max_ga)`` into structured
NumPy columns so ``core/perfmodel.predict_parts_batch`` and
``core/memory.estimate_batch`` can evaluate the whole space in one array
pass.

A ``PlanTable`` row i corresponds to ``table.plans[i]`` — the same
``ExecutionPlan`` objects the scalar path enumerates, in the same order, so
batch results can always be mapped back to a concrete plan (and the
batch≡scalar equivalence tests can pin them against each other).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.parallel.plan import ExecutionPlan, enumerate_plans


@dataclass(frozen=True)
class PlanColumns:
    """Structured columns for a set of execution plans (one row per plan)."""
    dp: np.ndarray                # int64
    tp: np.ndarray                # int64
    pp: np.ndarray                # int64
    ga: np.ndarray                # int64, already max(ga_steps, 1)
    zero: np.ndarray              # int64 zero_stage
    gc: np.ndarray                # bool
    offload: np.ndarray           # bool

    def __len__(self) -> int:
        return int(self.dp.shape[0])

    @property
    def n_gpus(self) -> np.ndarray:
        return self.dp * self.tp * self.pp

    def expand(self) -> "PlanColumns":
        """Add a trailing broadcast axis: columns become (N, 1) so they
        broadcast against a (G,) vector of allocation sizes."""
        return PlanColumns(*(c[:, None] for c in
                             (self.dp, self.tp, self.pp, self.ga,
                              self.zero, self.gc, self.offload)))

    @staticmethod
    def from_plans(plans: "list[ExecutionPlan] | tuple[ExecutionPlan, ...]",
                   ) -> "PlanColumns":
        n = len(plans)
        dp = np.empty(n, np.int64)
        tp = np.empty(n, np.int64)
        pp = np.empty(n, np.int64)
        ga = np.empty(n, np.int64)
        zero = np.empty(n, np.int64)
        gc = np.empty(n, bool)
        off = np.empty(n, bool)
        for i, p in enumerate(plans):
            dp[i] = p.dp
            tp[i] = p.tp
            pp[i] = p.pp
            ga[i] = max(p.ga_steps, 1)
            zero[i] = p.zero_stage
            gc[i] = p.gc
            off[i] = p.offload
        return PlanColumns(dp, tp, pp, ga, zero, gc, off)


@dataclass(frozen=True)
class PlanTable:
    """All plan skeletons with n_gpus ≤ max_gpus for one global batch size."""
    b: int
    max_gpus: int
    max_ga: int
    allow_tp_pp: bool
    plans: tuple[ExecutionPlan, ...]
    cols: PlanColumns
    strategies: tuple[str, ...]   # memoized plan.strategy per row

    def __len__(self) -> int:
        return len(self.plans)

    def exact_mask(self, gpus: int) -> np.ndarray:
        """Rows whose plan uses exactly ``gpus`` GPUs (the scalar
        ``enumerate_plans(gpus, b)`` set)."""
        return self.cols.n_gpus == gpus


def build(global_batch: int, max_gpus: int, max_ga: int = 8,
          allow_tp_pp: bool = True) -> PlanTable:
    plans: list[ExecutionPlan] = []
    for g in range(1, max_gpus + 1):
        plans.extend(enumerate_plans(g, global_batch, max_ga=max_ga,
                                     allow_tp_pp=allow_tp_pp))
    cols = PlanColumns.from_plans(plans)
    return PlanTable(global_batch, max_gpus, max_ga, allow_tp_pp,
                     tuple(plans), cols, tuple(p.strategy for p in plans))


_CACHE: dict[tuple[int, int, int, bool], PlanTable] = {}


def get(global_batch: int, max_gpus: int, max_ga: int = 8,
        allow_tp_pp: bool = True) -> PlanTable:
    """Process-wide memoized table per (b, max_gpus, max_ga, allow_tp_pp)."""
    key = (int(global_batch), int(max_gpus), int(max_ga), bool(allow_tp_pp))
    tbl = _CACHE.get(key)
    if tbl is None:
        tbl = _CACHE[key] = build(*key)
    return tbl


def cache_clear() -> None:
    _CACHE.clear()
