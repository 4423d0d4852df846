"""Resource sensitivity curves (paper Sec 5.2, Fig 6).

A copy of ``repro.core.sensitivity`` over the port's performance model,
memory model and plan table, held to the reference's outputs (both
engines) by ``tests/test_torch_sched.py``.  The simulator and baselines
named below are the port's copies (``core/simulator.py``,
``core/baselines.py``).

For a job, a curve maps a resource amount (GPUs, with other types fixed —
or CPUs under offload plans) to the BEST feasible execution plan and its
predicted throughput.  Curves are monotone-enveloped ("the curve only
connects the highest points") and flat across invalid GPU counts.  Slopes
(throughput delta per resource unit) drive both the allocation order
(SortBySlope) and the shrink decisions (GetLowestSlopeOverMinJob).

Two engines share one semantics:

  * ``engine="batch"`` (default) materializes the whole envelope — best
    plan, throughput, and both slopes for every g ∈ [1, max_gpus] — in a
    single ``predict_parts_batch`` pass over the process-wide plan table,
    then answers ``throughput``/``slope_gpu``/``slope_gpu_down``/
    ``best_plan_at_most`` in O(1).
  * ``engine="scalar"`` is the original per-plan Python loop, kept as the
    reference implementation; property tests pin batch ≡ scalar.

Curves are owned by a process-wide ``CurveCache`` keyed by
``(profile, fitted, env, max_gpus, cpus_per_gpu, max_ga, engine)`` so the
scheduler, ``min_resources``, the oracle helpers, and the simulator all
share one copy instead of refitting/re-enumerating per instance.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import memory
from repro_torch.core.perfmodel import (Alloc, Env, FitParams, ModelProfile,
                                  f_overlap_batch, predict_parts_batch,
                                  predict_throughput,
                                  predict_throughput_batch)
from repro_torch.parallel import plan_table
from repro_torch.parallel.plan import ExecutionPlan, enumerate_plans


@dataclass(frozen=True)
class CurvePoint:
    gpus: int
    plan: ExecutionPlan | None
    throughput: float             # samples/s (0 = infeasible)


@dataclass(frozen=True)
class Envelope:
    """Dense per-g arrays for g ∈ [0, max_gpus] (index = GPU count)."""
    exact: np.ndarray             # best throughput using EXACTLY g GPUs
    env: np.ndarray               # running max of exact (the Fig-6 envelope)
    env_g: np.ndarray             # g' ≤ g achieving env[g] (0: none)
    plans: tuple                  # best exact-g plan per g (None: infeasible)


class SensitivityCurve:
    """Best-plan throughput vs GPU count for one job (fitted params)."""

    def __init__(self, profile: ModelProfile, fitted: FitParams,
                 env: Env | None = None, max_gpus: int = 64,
                 cpus_per_gpu: int = 12, max_ga: int = 8,
                 engine: str = "batch"):
        self.profile = profile
        self.fitted = fitted
        self.env = env or Env()
        self.max_gpus = max_gpus
        self.cpus_per_gpu = cpus_per_gpu
        self.max_ga = max_ga
        self.engine = engine
        self._points: dict[tuple, CurvePoint] = {}
        self._at_most: dict[tuple, CurvePoint] = {}
        self._envelope: Envelope | None = None
        self._statics: dict[int | None, dict] = {}
        self._static_evals: dict[tuple, np.ndarray] = {}
        self._grow_memo: dict[tuple[int, int], int] = {}
        self._slopes: list[float] | None = None
        self._baselines: dict[tuple, float] = {}
        self._minres: dict[tuple, tuple[int, int]] = {}

    # ------------------------------------------------------------------
    # batched evaluation primitives
    # ------------------------------------------------------------------
    @property
    def table(self) -> plan_table.PlanTable:
        return plan_table.get(self.profile.b, self.max_gpus, self.max_ga)

    def _grid(self, gpus, cpus, per_node=None) -> np.ndarray:
        """Throughput of every plan-table row × allocation column: rows
        whose plans don't fit (OOM / divisibility / too many GPUs) are 0."""
        return self._eval(self.table.cols.expand(), gpus, cpus, per_node)

    def _eval(self, cols, gpus, cpus, per_node=None) -> np.ndarray:
        gpus = np.asarray(gpus)
        cpus = np.asarray(cpus)
        feas = memory.feasible_mask(self.profile, cols, gpus, cpus, self.env)
        thpt = predict_throughput_batch(self.profile, cols, gpus, cpus,
                                        self.env, self.fitted,
                                        per_node=per_node)
        return np.where(feas, thpt, 0.0)

    def _per_node_key(self, per_node: int | None) -> int | None:
        """A per-node cap ≥ the node size is indistinguishable from packed:
        every communication group of a plan fits within the plan's own GPU
        count, so only caps SMALLER than the node flip bandwidth tiers."""
        if per_node is None or per_node >= self.env.gpus_per_node:
            return None
        return int(per_node)

    def _base(self) -> dict:
        """Per-curve precomputation shared by every per-node variant: one
        reference pass through the real batched model at the node-size
        per-node cap ("hi" = the packed selection, since every comm group
        of a plan fits the plan's own GPU count), plus the all-inter-node
        ("lo") comm terms.  ``f_overlap`` is elementwise, so the overlap
        terms are precomputed for both tiers and per-node variants reduce
        to pure where-selection."""
        base = self._statics.get("base")
        if base is not None:
            return base
        cols = self.table.cols
        own_g = cols.n_gpus
        env, k, prof = self.env, self.fitted, self.profile
        parts = predict_parts_batch(prof, cols, own_g, np.float64(1.0),
                                    env, k, per_node=env.gpus_per_node)
        d = cols.dp.astype(float)
        t = cols.tp.astype(float)
        p = cols.pp.astype(float)
        b, s_, h, l, P = prof.b, prof.s, prof.h, prof.l, prof.P
        bpp = 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            V_dp = bpp * P * 2.0 * (d - 1) / np.maximum(d * t * p, 1.0)
            dp_lo = np.where(d > 1, V_dp / env.B_inter, 0.0)
            V_tp = 8.0 * (t - 1) * b * s_ * h * l * bpp \
                / np.maximum(d * t, 1.0)
            tp_lo = np.where(t > 1, V_tp / env.B_inter, 0.0)
            V_pp = 2.0 * p * b * s_ * h * bpp / np.maximum(d * t, 1.0)
            pp_lo = np.where(p > 1, V_pp / env.B_inter, 0.0)
        gpu_b, host_b, _ = memory.estimate_batch(prof, cols, own_g,
                                                 np.float64(1.0), env)
        base = {
            "t_fwd": parts.t_fwd, "t_bwd": parts.t_bwd,
            "t_opt_plain": parts.t_opt,       # offload rows recomputed
            "t_off": parts.t_off,
            "dp_hi": parts.t_comm_dp, "dp_lo": dp_lo,
            "tp_hi": parts.t_comm_tp, "tp_lo": tp_lo,
            "pp_hi": parts.t_comm_pp, "pp_lo": pp_lo,
            "sync_hi": f_overlap_batch(k.k_sync, parts.t_bwd,
                                       parts.t_comm_dp),
            "sync_lo": f_overlap_batch(k.k_sync, parts.t_bwd, dp_lo),
            "f_off_dp_hi": f_overlap_batch(k.k_off, parts.t_comm_dp,
                                           parts.t_off),
            "f_off_dp_lo": f_overlap_batch(k.k_off, dp_lo, parts.t_off),
            "a_eff": np.where(cols.pp > 1, 1.0, cols.ga.astype(float)),
            "grp_dtp": cols.dp * cols.tp * cols.pp,
            "grp_t": cols.tp,
            "grp_tp": cols.tp * cols.pp,
            "mem_ok": (np.mod(prof.b, cols.dp * cols.ga) == 0)
                      & (gpu_b <= env.gpu_mem) & (host_b <= env.host_mem),
            "cpu_needed": np.where(cols.offload,
                                   np.maximum(1, own_g // cols.dp), 1),
            "d": d,
        }
        self._statics["base"] = base
        return base

    def _static(self, per_node: int | None) -> dict:
        """Allocation-independent arrays for row-wise (alloc = own n_gpus)
        evaluation at one per-node cap.  A curve's fitted params are
        fixed, so everything except the cpus-dependent offload optimizer
        term and the CPU-count feasibility check is a constant per
        plan-table row — cache it once, answer queries with ~10 array
        ops instead of a full model evaluation."""
        s = self._statics.get(per_node)
        if s is not None:
            return s
        base = self._base()
        if per_node is None:
            sync = base["sync_hi"]
            t_tp, t_pp = base["tp_hi"], base["pp_hi"]
            f_off_dp = base["f_off_dp_hi"]
        else:
            m_dtp = base["grp_dtp"] <= per_node
            sync = np.where(m_dtp, base["sync_hi"], base["sync_lo"])
            t_tp = np.where(base["grp_t"] <= per_node,
                            base["tp_hi"], base["tp_lo"])
            t_pp = np.where(base["grp_tp"] <= per_node,
                            base["pp_hi"], base["pp_lo"])
            f_off_dp = np.where(m_dtp, base["f_off_dp_hi"],
                                base["f_off_dp_lo"])
        a_eff = base["a_eff"]
        t_cc = np.where(a_eff > 1,
                        a_eff * base["t_fwd"] + (a_eff - 1) * base["t_bwd"]
                        + sync,
                        base["t_fwd"] + sync + t_tp + t_pp)
        k = self.fitted
        with np.errstate(divide="ignore", invalid="ignore"):
            s = {
                # t_iter for non-offload rows is fully static
                "t_iter_nonoff": t_cc + base["t_opt_plain"] + k.k_const,
                "t_cc": t_cc,
                "t_off": base["t_off"],
                "log_t_off": np.log(base["t_off"]),
                "f_off_dp": f_off_dp,
                # t_opt_off = (k_opt_off·P/d) / cpus_per_rank
                "off_num": k.k_opt_off * self.profile.P / base["d"],
                "mem_ok": base["mem_ok"],
                "cpu_needed": base["cpu_needed"],
                "offload": self.table.cols.offload,
                "d": base["d"],
            }
        self._statics[per_node] = s
        return s

    def _eval_static(self, cpus, per_node: int | None = None) -> np.ndarray:
        """Row-wise throughput at alloc = (own n_gpus, cpus): the fast path
        behind best_plan / best_plan_at_most / the envelope.  Scalar-cpus
        results are memoized (curves are immutable)."""
        per_node = self._per_node_key(per_node)
        memo_key = None
        if np.ndim(cpus) == 0:
            memo_key = (float(cpus), per_node)
            hit = self._static_evals.get(memo_key)
            if hit is not None:
                return hit
        s = self._static(per_node)
        k = self.fitted
        kk = max(k.k_swap, 1.0)
        cpus = np.asarray(cpus, float)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            # guard-free power-mean of (t_opt_off, t_off): both are > 0 on
            # offload rows, and non-offload rows are discarded by the
            # where() below, so the garbage there is harmless
            lx = np.log(s["off_num"] / np.maximum(cpus / s["d"], 1.0))
            lo = np.maximum(lx, s["log_t_off"])
            f_swap = np.exp(lo + np.log(
                np.exp(kk * (lx - lo)) +
                np.exp(kk * (s["log_t_off"] - lo))) / kk)
            t_iter = np.where(
                s["offload"],
                s["t_cc"] + (s["f_off_dp"] + f_swap) + k.k_const,
                s["t_iter_nonoff"])
            ok = s["mem_ok"] & (s["cpu_needed"] <= np.maximum(cpus, 1)) \
                & np.isfinite(t_iter)
            out = np.where(ok, self.profile.b / t_iter, 0.0)
        if memo_key is not None:
            self._static_evals[memo_key] = out
        return out

    def materialize(self) -> Envelope:
        """Build the full default-allocation envelope in one batched pass:
        for every g, cpus = cpus_per_gpu·g, packed placement."""
        if self._envelope is not None:
            return self._envelope
        G = self.max_gpus
        plans: list = [None] * (G + 1)
        if self.engine == "batch":
            # best_plan(g) semantics: plans using EXACTLY g GPUs, with the
            # default allocation (cpus_per_gpu·g, packed); each table row
            # is evaluated once at its own GPU count
            own_g = self.table.cols.n_gpus
            vals = self._eval_static(
                (self.cpus_per_gpu * own_g).astype(float))
            exact = np.zeros(G + 1)
            np.maximum.at(exact, own_g, vals)
            hit = (vals > 0.0) & (vals == exact[own_g])
            for i in np.flatnonzero(hit):
                g = int(own_g[i])
                if plans[g] is None:          # first max, like the scalar >
                    plans[g] = self.table.plans[i]
        else:
            exact = np.zeros(G + 1)
            for g in range(1, G + 1):
                pt = self._best_plan_scalar(g, self.cpus_per_gpu * g, ())
                exact[g] = pt.throughput
                plans[g] = pt.plan
        env = np.maximum.accumulate(exact)
        # g' achieving the envelope at each g (first g' that reaches env[g])
        env_g = np.where(exact >= env, np.arange(G + 1), 0)
        env_g = np.maximum.accumulate(env_g)
        self._envelope = Envelope(exact=exact, env=env, env_g=env_g,
                                  plans=tuple(plans))
        return self._envelope

    # ------------------------------------------------------------------
    # scalar reference engine (the original per-plan interpreter loop)
    # ------------------------------------------------------------------
    def _best_plan_scalar(self, gpus: int, cpus: int,
                          gpus_per_node: tuple[int, ...]) -> CurvePoint:
        alloc = Alloc(gpus, cpus, gpus_per_node=gpus_per_node)
        best: CurvePoint = CurvePoint(gpus, None, 0.0)
        for plan in enumerate_plans(gpus, self.profile.b, max_ga=self.max_ga):
            if not memory.feasible(self.profile, plan, alloc, self.env):
                continue
            thpt = predict_throughput(self.profile, plan, alloc, self.env,
                                      self.fitted)
            if thpt > best.throughput:
                best = CurvePoint(gpus, plan, thpt)
        return best

    def _best_plan_batch(self, gpus: int, cpus: int,
                         gpus_per_node: tuple[int, ...]) -> CurvePoint:
        per_node = max(gpus_per_node) if gpus_per_node else None
        col = self._eval_static(np.float64(cpus), per_node=per_node)
        col = np.where(self.table.exact_mask(gpus), col, 0.0)
        i = int(col.argmax()) if col.size else 0
        if col.size == 0 or col[i] <= 0.0:
            return CurvePoint(gpus, None, 0.0)
        return CurvePoint(gpus, self.table.plans[i], float(col[i]))

    # ------------------------------------------------------------------
    def best_plan(self, gpus: int, cpus: int | None = None,
                  gpus_per_node: tuple[int, ...] = ()) -> CurvePoint:
        """GetBestPlan: the highest-throughput feasible plan using exactly
        this GPU count (paper: 'searches for the best execution plan by
        enumerating the feasible plans')."""
        cpus = cpus if cpus is not None else self.cpus_per_gpu * gpus
        key = (gpus, cpus, gpus_per_node)
        if key in self._points:
            return self._points[key]
        if gpus <= 0:
            pt = CurvePoint(gpus, None, 0.0)
        elif self.engine == "batch" and gpus <= self.max_gpus:
            pt = self._best_plan_batch(gpus, cpus, gpus_per_node)
        else:
            pt = self._best_plan_scalar(gpus, cpus, gpus_per_node)
        self._points[key] = pt
        return pt

    def best_plan_at_most(self, gpus: int, cpus: int | None = None,
                          gpus_per_node: tuple[int, ...] = ()) -> CurvePoint:
        """Best plan using AT MOST ``gpus`` (idle spares allowed) — the
        envelope point, not just the exact-g point.  The placement is
        carried through for EVERY candidate g (a spread placement must use
        inter-node bandwidth even when the plan idles some GPUs)."""
        hi = min(gpus, self.max_gpus)
        if hi <= 0:
            return CurvePoint(gpus, None, 0.0)
        if cpus is None and not gpus_per_node:
            e = self.materialize()
            g = int(e.env_g[hi])
            if g <= 0 or e.plans[g] is None:
                return CurvePoint(gpus, None, 0.0)
            return CurvePoint(g, e.plans[g], float(e.exact[g]))
        if self.engine == "batch":
            # Single-column reduction: with cpus and per_node fixed, a
            # plan's throughput does not depend on how many SPARE GPUs the
            # allocation holds (alloc size only enters via feasibility and
            # packed per-node caps, and every group of a plan with
            # n_gpus ≤ g' also fits the g'-packed cap).  So the best over
            # all g' ≤ hi is one evaluation per row at the row's own GPU
            # count — O(n_plans) instead of O(n_plans × hi).
            per_node = self._per_node_key(
                max(gpus_per_node) if gpus_per_node else None)
            # scalar reference: row i is only ever evaluated at g' = its
            # own n_gpus, with cpus = the explicit value, or the per-g
            # default cpus_per_gpu·n_gpus when cpus is None
            key = (hi, float(cpus) if cpus is not None else None, per_node)
            pt = self._at_most.get(key)
            if pt is not None:
                return pt
            own_g = self.table.cols.n_gpus
            if cpus is not None:
                thpt = self._eval_static(np.float64(float(cpus)),
                                         per_node=per_node)
            else:
                thpt = self._eval_static(
                    (self.cpus_per_gpu * own_g).astype(float),
                    per_node=per_node)
            thpt = np.where(own_g <= hi, thpt, 0.0)
            i = int(thpt.argmax())
            if thpt[i] <= 0.0:
                pt = CurvePoint(gpus, None, 0.0)
            else:
                plan = self.table.plans[i]
                pt = CurvePoint(plan.n_gpus, plan, float(thpt[i]))
            self._at_most[key] = pt
            return pt
        best = CurvePoint(gpus, None, 0.0)
        for g in range(hi, 0, -1):
            pt = self._best_plan_scalar(g, cpus if cpus is not None
                                        else self.cpus_per_gpu * g,
                                        gpus_per_node)
            if pt.throughput > best.throughput:
                best = pt
        return best

    def throughput(self, gpus: int, cpus: int | None = None,
                   gpus_per_node: tuple[int, ...] = ()) -> float:
        """Monotone envelope: max throughput achievable with ≤ gpus (the
        curve 'remains flat for invalid GPU numbers')."""
        hi = min(gpus, self.max_gpus)
        if hi <= 0:
            return 0.0
        if cpus is None:
            return float(self.materialize().env[hi])
        if self.engine == "batch":
            # scalar reference: best_plan(g, min(cpus, cpus_per_gpu·g))
            # for each g ≤ hi — i.e. each row at its OWN per-g CPU cap
            own_g = self.table.cols.n_gpus
            c = np.minimum(float(cpus),
                           (self.cpus_per_gpu * own_g).astype(float))
            vals = self._eval_static(c)
            return float(np.where(own_g <= hi, vals, 0.0).max(initial=0.0))
        best = 0.0
        for g in range(1, hi + 1):
            pt = self.best_plan(g, min(cpus, self.cpus_per_gpu * g))
            best = max(best, pt.throughput)
        return best

    def _slope_list(self) -> list[float]:
        """Plain-float envelope steps (index g = throughput delta between
        g and g+1 GPUs) — the scheduler's hottest lookup, precomputed once
        per curve so the per-call cost is a list index, not numpy scalar
        math."""
        if self._slopes is None:
            self._slopes = np.maximum(
                np.diff(self.materialize().env), 0.0).tolist()
        return self._slopes

    # ------------------------------------------------------------------
    def slope_gpu(self, gpus: int) -> float:
        """Throughput gain of the NEXT GPU (used to rank jobs)."""
        if gpus >= self.max_gpus:
            return 0.0
        return self._slope_list()[max(gpus, 0)]

    def slope_gpu_down(self, gpus: int) -> float:
        """Throughput LOST by taking one GPU away (shrink decisions)."""
        if gpus <= 0:
            return float("inf")
        return self._slope_list()[min(gpus, self.max_gpus) - 1]

    def slope_cpu(self, gpus: int, cpus: int, delta: int = 4) -> float:
        if gpus <= 0:
            return 0.0
        return max(0.0, self.best_plan(gpus, cpus + delta).throughput
                   - self.best_plan(gpus, cpus).throughput) / delta

    def baseline_throughput(self, plan: ExecutionPlan, gpus: int,
                            cpus: int) -> float:
        """Predicted throughput of one fixed (plan, alloc) point — the
        guarantee baseline of a job submitted with that request.  Memoized
        on the curve: every job of the same model type + request shape
        shares one evaluation per process instead of paying a scalar
        ``predict_throughput`` each (curves are immutable, so the value
        can never go stale)."""
        key = (plan, gpus, cpus)
        v = self._baselines.get(key)
        if v is None:
            v = self._baselines[key] = predict_throughput(
                self.profile, plan, Alloc(gpus, cpus), self.env,
                self.fitted)
        return v

    def min_res_for(self, req_gpus: int, req_cpus: int,
                    baseline: float) -> tuple[int, int]:
        """Memoized ``min_resources`` — minRes is a pure function of the
        curve and the (request, baseline) pair, so the scheduler pays it
        once per (profile, fitted, env, request), not once per job."""
        key = (req_gpus, req_cpus, baseline)
        v = self._minres.get(key)
        if v is None:
            v = self._minres[key] = min_resources(self, req_gpus, req_cpus,
                                                  baseline)
        return v

    def grow_target(self, gpus: int, hi: int) -> int:
        """Largest g ∈ [gpus, hi] still worth growing to: advance while the
        next GPU improves the envelope by >0.1% (vectorized scan, memoized
        — curves are immutable and the scheduler asks the same (req, cap)
        for every job of a model type on every pass)."""
        g = max(gpus, 0)
        hi = min(hi, self.max_gpus)
        if g >= hi:
            return g
        key = (g, hi)
        hit = self._grow_memo.get(key)
        if hit is not None:
            return hit
        e = self.materialize().env
        # first g' ≥ g where the next step stops paying (monotone envelope)
        flat = np.flatnonzero(e[g + 1:hi + 1] <= e[g:hi] * 1.001)
        out = g + (int(flat[0]) if flat.size else hi - g)
        self._grow_memo[key] = out
        return out


def min_resources(curve: SensitivityCurve, req_gpus: int, req_cpus: int,
                  baseline_perf: float) -> tuple[int, int]:
    """Paper Sec 5.2: the fewest resources (≤ requested in each dimension)
    achieving the performance of the original request+plan; falls back to
    the original request when none found."""
    hi = min(req_gpus, curve.max_gpus)
    if curve.engine == "batch" and hi >= 1:
        if req_cpus >= curve.cpus_per_gpu * hi:
            # default-cpus regime: the per-g best is exactly the
            # materialized envelope's exact[] array — O(1) after the first
            # curve use anywhere in the process
            best = curve.materialize().exact[1:hi + 1]
        else:
            g_vec = np.arange(1, hi + 1)
            c_vec = np.minimum(float(req_cpus),
                               (curve.cpus_per_gpu * g_vec).astype(float))
            best = curve._grid(g_vec, c_vec)
            best = np.where(curve.table.cols.n_gpus[:, None] == g_vec,
                            best, 0.0).max(axis=0)
        ok = np.flatnonzero((best >= baseline_perf) & (best > 0.0))
        if ok.size:
            g = int(ok[0]) + 1
            return g, int(min(req_cpus, curve.cpus_per_gpu * g))
        return req_gpus, req_cpus
    for g in range(1, req_gpus + 1):
        c = min(req_cpus, curve.cpus_per_gpu * g)
        pt = curve.best_plan(g, c)
        if pt.throughput >= baseline_perf and pt.plan is not None:
            return g, c
    return req_gpus, req_cpus


# ---------------------------------------------------------------------------
# Process-wide curve ownership
# ---------------------------------------------------------------------------

class CurveCache:
    """One SensitivityCurve per (profile, fitted, env, max_gpus,
    cpus_per_gpu, max_ga, engine) — shared across scheduler instances,
    baselines, the simulator, and oracle helpers, so each model's plan
    space is enumerated and evaluated once per process."""

    def __init__(self):
        self._curves: dict[tuple, SensitivityCurve] = {}

    def get(self, profile: ModelProfile, fitted: FitParams,
            env: Env | None = None, max_gpus: int = 64,
            cpus_per_gpu: int = 12, max_ga: int = 8,
            engine: str = "batch") -> SensitivityCurve:
        env = env or Env()
        key = (profile, fitted, env, max_gpus, cpus_per_gpu, max_ga, engine)
        curve = self._curves.get(key)
        if curve is None:
            curve = self._curves[key] = SensitivityCurve(
                profile, fitted, env, max_gpus=max_gpus,
                cpus_per_gpu=cpus_per_gpu, max_ga=max_ga, engine=engine)
        return curve

    def invalidate_fitted(self, fitted: FitParams) -> int:
        """Drop every curve built on RETIRED fit params (a calibration
        refit replaced them).  Fresh lookups key on the new params, so
        the old envelopes/statics can never be read again — release them
        eagerly instead of leaking one curve family per refit.  Matches
        by VALUE (cache keys are value-equal frozen dataclasses); a
        same-valued curve some other consumer still uses is simply
        rebuilt on its next ``get`` — dropping an entry is never a
        correctness event, curves are pure functions of their key."""
        dead = [k for k in self._curves if k[1] == fitted]
        for k in dead:
            del self._curves[k]
        return len(dead)

    def clear(self) -> None:
        self._curves.clear()

    def __len__(self) -> int:
        return len(self._curves)


CURVES = CurveCache()


def get_curve(profile: ModelProfile, fitted: FitParams,
              env: Env | None = None, max_gpus: int = 64,
              cpus_per_gpu: int = 12, max_ga: int = 8,
              engine: str = "batch") -> SensitivityCurve:
    """Module-level accessor for the process-wide ``CurveCache``."""
    return CURVES.get(profile, fitted, env, max_gpus, cpus_per_gpu, max_ga,
                      engine)
