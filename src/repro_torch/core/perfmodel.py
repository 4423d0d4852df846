"""Rubick's resource–performance model (paper Sec 4): a copy of
``repro.core.perfmodel`` for the port, held to the reference's outputs by
``tests/test_torch_perfmodel.py``.  One addition: the ``"h100"`` entry of
``GPU_TYPES``, whose fields were read on the card.

Predicts per-iteration time T_iter for any (execution plan × multi-resource
allocation) of a profiled model:

    T_iter = T_cc + T_oo + k_const                                   (Eq. 1)

    T_cc  = T_fwd + f_overlap^{k_sync}(T_bwd, T_dp) + T_tp + T_pp    (3D)
          = a·T_fwd + (a-1)·T_bwd + f_overlap^{k_sync}(T_bwd, T_dp)  (GA)
    T_oo  = f^{k_off}(T_dp, T_off) + f^{k_swap}(T_opt, T_off)        (offload)
          = T_opt                                                    (else)

    f_overlap^k(x, y) = (x^k + y^k)^{1/k}   (k=1: serial; k→∞: max)  (Sec 4.3)

Fittable 7-tuple (Table 1): k_bwd, k_sync, k_opt, k_opt_off, k_off, k_swap,
k_const — fitted from ≥7 sampled (plan × resources → throughput) points by
minimizing RMSLE, exactly as Sec 4.3 prescribes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.parallel.plan_table import PlanColumns


# ---------------------------------------------------------------------------
# Environment & profile (Table 1: "Job" and "Environment" rows)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Env:
    """Cluster environment constants (measured offline, paper Sec 6)."""
    B_intra: float = 400e9        # NVLink, bytes/s
    B_inter: float = 100e9        # RDMA, bytes/s
    B_pcie: float = 32e9          # host<->device
    gpus_per_node: int = 8
    cpus_per_node: int = 96
    gpu_mem: float = 80e9         # A800-80GB
    host_mem: float = 1600e9
    gpu_flops: float = 312e12     # A800 bf16 peak


# Per-GPU-type environments for heterogeneous pools (Sec 7.4-style cluster
# simulation over mixed GPU generations, as Pollux/Sia do).  Each type is
# the baseline A800 ``Env`` with only the fields that actually differ across
# generations replaced: compute rate, device memory, and bandwidth tiers.
# ``SensitivityCurve``s are keyed by ``Env`` (see ``core/sensitivity.py``),
# so each type gets its own curve family automatically.
GPU_TYPES: dict[str, dict] = {
    "a800":     {},                                       # the baseline Env
    "h800":     dict(gpu_flops=990e12, B_pcie=64e9),
    "a100-40g": dict(gpu_mem=40e9),
    "v100":     dict(gpu_flops=125e12, gpu_mem=32e9, B_intra=150e9,
                     B_inter=25e9, B_pcie=16e9),
    # The card the port runs on, an NVIDIA H100 80GB HBM3 at a 700.00 W
    # power limit: gpu_mem is torch.cuda.get_device_properties(0)
    # .total_memory read on it; B_pcie the host-to-device rate of a pinned
    # block that chip_smoke.py's train_offload phase measures on it in one
    # direction; gpu_flops NVIDIA's H100 SXM5 datasheet bf16 dense peak.
    # The other fields (NVLink, RDMA, node shape, host memory) describe a
    # cluster's node, which one card does not measure: they keep the base
    # Env's, and act on no one-card plan but through host_mem's offload check.
    "h100":     dict(gpu_flops=989e12, gpu_mem=85_017_493_504, B_pcie=55.0e9),
}


def env_for_gpu(gpu_model: str, base: Env | None = None) -> Env:
    """The per-type ``Env`` for one GPU model, derived from ``base``."""
    if gpu_model not in GPU_TYPES:
        raise KeyError(f"unknown GPU type {gpu_model!r}; "
                       f"known: {sorted(GPU_TYPES)}")
    return replace(base or Env(), **GPU_TYPES[gpu_model])


@dataclass(frozen=True)
class ModelProfile:
    """Per-model quantities the performance model needs (Table 1)."""
    name: str
    s: int                        # sequence length
    h: int                        # hidden size
    l: int                        # layers
    P: float                      # parameter count
    b: int                        # global batch size
    t_fwd_unit: float             # sec per token, full fwd, one reference GPU
    P_bytes: float = 0.0

    @staticmethod
    def from_config(cfg: ModelConfig, seq: int = 2048, batch: int = 16,
                    env: Env | None = None, efficiency: float = 0.35
                    ) -> "ModelProfile":
        env = env or Env()
        P = costs.param_count(cfg)
        n_flops = costs.flops_param_count(cfg)
        t_unit = 2.0 * n_flops / (env.gpu_flops * efficiency)
        return ModelProfile(name=cfg.name, s=seq, h=cfg.d_model,
                            l=max(cfg.n_layers, 1), P=float(P), b=batch,
                            t_fwd_unit=t_unit, P_bytes=2.0 * P)


def fit_key(profile: ModelProfile) -> tuple:
    """Full-identity fit-cache key for one model type.

    Fitted params are shared across jobs of the same model type, so the
    cache key must capture everything the model's shape contributes to
    T_iter — two jobs sharing a name and batch size but differing in
    sequence length or depth must NOT share fitted params (the old
    ``"<name>@b<batch>"`` key silently merged them)."""
    return (profile.name, profile.s, profile.h, profile.l, profile.P,
            profile.b)


@dataclass(frozen=True)
class Alloc:
    """A multi-resource allocation (paper: GPU, CPU, memory; bandwidth is an
    environment property selected by placement)."""
    gpus: int
    cpus: int = 0                 # total CPUs across the job
    mem: float = 0.0              # host memory bytes
    gpus_per_node: tuple[int, ...] = ()   # placement; () = packed

    def nodes(self, env: Env) -> int:
        if self.gpus_per_node:
            return len(self.gpus_per_node)
        return max(1, math.ceil(self.gpus / env.gpus_per_node))

    def max_gpus_on_node(self, env: Env) -> int:
        if self.gpus_per_node:
            return max(self.gpus_per_node)
        return min(self.gpus, env.gpus_per_node)


@dataclass(frozen=True)
class FitParams:
    """The fittable 7-tuple (Table 1)."""
    k_bwd: float = 2.0
    k_sync: float = 2.0
    k_opt: float = 2e-11          # sec per param per (1/x) partition
    k_opt_off: float = 3e-10      # CPU-side update, sec·cpu per param
    k_off: float = 2.0
    k_swap: float = 2.0
    k_const: float = 0.01

    def as_vector(self) -> np.ndarray:
        return np.array([self.k_bwd, self.k_sync, self.k_opt, self.k_opt_off,
                         self.k_off, self.k_swap, self.k_const])

    @staticmethod
    def from_vector(v) -> "FitParams":
        return FitParams(*[float(x) for x in v])


def f_overlap(k: float, tx: float, ty: float) -> float:
    """(T_x^k + T_y^k)^(1/k); k=1 → sum, k→∞ → max (Sec 4.3, after [38])."""
    if tx <= 0.0:
        return ty
    if ty <= 0.0:
        return tx
    k = max(k, 1.0)
    lo = math.log(max(tx, ty))
    # numerically stable log-sum-exp in the k-power domain
    return math.exp(lo + math.log(
        math.exp(k * (math.log(tx) - lo)) +
        math.exp(k * (math.log(ty) - lo))) / k)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@dataclass
class Breakdown:
    t_fwd: float = 0.0
    t_bwd: float = 0.0
    t_comm_dp: float = 0.0
    t_comm_tp: float = 0.0
    t_comm_pp: float = 0.0
    t_opt: float = 0.0
    t_off: float = 0.0
    t_iter: float = float("inf")


def predict_parts(profile: ModelProfile, plan: ExecutionPlan, alloc: Alloc,
                  env: Env, k: FitParams) -> Breakdown:
    """All T_* parts of Eq. 1 for one (plan × allocation)."""
    d, t, p, a = plan.dp, plan.tp, plan.pp, max(plan.ga_steps, 1)
    b, s, h, l, P = profile.b, profile.s, profile.h, profile.l, profile.P
    g = d * t * p
    out = Breakdown()
    # plan may use fewer GPUs than allocated (idle spares), never more
    if g > alloc.gpus or b % (d * a):
        return out                                   # infeasible combination

    per_node = alloc.max_gpus_on_node(env)
    # --- T_fwd (per micro-batch, Sec 4.1) ---------------------------------
    b_micro = b / (d * a)
    tok = b_micro * s
    if p > 1:
        # PP: t_p per-stage micro-batch time, l/p layers per stage;
        # full fwd = (m + p - 1) stage times, m micro-batches (1F1B).
        m = a if a > 1 else p
        t_p = profile.t_fwd_unit * (b / (d * m)) * s / (t * p)
        t_fwd = t_p * (m + p - 1)
        a_eff = 1                                    # GA folded into m
    else:
        t_fwd = profile.t_fwd_unit * tok / t
        m = a
        a_eff = a
    out.t_fwd = t_fwd

    # --- T_bwd -------------------------------------------------------------
    t_bwd = k.k_bwd * t_fwd
    if plan.gc:
        t_bwd = t_bwd + t_fwd                        # recompute ≈ one fwd [5]
    out.t_bwd = t_bwd

    # --- T_comm (Sec 4.1) ---------------------------------------------------
    bytes_per_param = 2.0
    V_dp = bytes_per_param * P * 2.0 * (d - 1) / max(d * t * p, 1)
    B_dp = env.B_intra if d * t * p <= per_node else env.B_inter
    out.t_comm_dp = V_dp / B_dp if d > 1 else 0.0

    V_tp = 8.0 * (t - 1) * b * s * h * l * bytes_per_param / max(d * t, 1)
    B_tp = env.B_intra if t <= per_node else env.B_inter
    out.t_comm_tp = V_tp / B_tp if t > 1 else 0.0

    V_pp = 2.0 * p * b * s * h * bytes_per_param / max(d * t, 1)
    B_pp = env.B_intra if t * p <= per_node else env.B_inter
    out.t_comm_pp = V_pp / B_pp if p > 1 else 0.0

    # --- T_opt (Sec 4.2) ----------------------------------------------------
    if plan.offload:
        # ZeRO-Offload: each DP rank updates P/d params on its c CPUs
        cpus_per_rank = max(alloc.cpus / max(d, 1), 1.0)
        out.t_opt = k.k_opt_off * P / (d * cpus_per_rank)
    else:
        x = t * p if (t > 1 or p > 1) else (d if plan.zero_stage >= 1 else 1)
        out.t_opt = k.k_opt * P / x

    # --- T_off --------------------------------------------------------------
    if plan.offload:
        out.t_off = bytes_per_param * P / (d * env.B_pcie)

    # --- combine (Sec 4.3) ---------------------------------------------------
    if a_eff > 1:
        t_cc = a_eff * t_fwd + (a_eff - 1) * t_bwd + \
            f_overlap(k.k_sync, t_bwd, out.t_comm_dp)
    else:
        t_cc = t_fwd + f_overlap(k.k_sync, t_bwd, out.t_comm_dp) \
            + out.t_comm_tp + out.t_comm_pp
    if plan.offload:
        t_oo = f_overlap(k.k_off, out.t_comm_dp, out.t_off) + \
            f_overlap(k.k_swap, out.t_opt, out.t_off)
    else:
        t_oo = out.t_opt
    out.t_iter = t_cc + t_oo + k.k_const
    return out


def predict_titer(profile, plan, alloc, env, k) -> float:
    return predict_parts(profile, plan, alloc, env, k).t_iter


# ---------------------------------------------------------------------------
# Batched engine (vectorized twin of predict_parts)
# ---------------------------------------------------------------------------

def _f_overlap_core(kk, tx: np.ndarray, ty: np.ndarray) -> np.ndarray:
    """``f_overlap_batch`` without the input coercion / fp-error guard —
    the fitting hot path calls this under one shared ``errstate``.  Uses
    the one-exp form of the k-power log-sum-exp: with lo = max(lx, ly)
    one exponent is exactly 0, so the sum is 1 + exp(-k·|lx-ly|)."""
    lx, ly = np.log(tx), np.log(ty)
    lo = np.maximum(lx, ly)
    lse = np.exp(lo + np.log1p(np.exp(-kk * np.abs(lx - ly))) / kk)
    return np.where(tx <= 0.0, ty, np.where(ty <= 0.0, tx, lse))


def f_overlap_batch(k, tx: np.ndarray, ty: np.ndarray) -> np.ndarray:
    """Vectorized ``f_overlap``: same log-sum-exp in the k-power domain,
    elementwise over broadcastable arrays.  ``k`` may itself be an array
    (one exponent per candidate parameter vector) broadcastable against
    ``tx``/``ty``.

    Shapes:
        k: scalar or (K, 1) overlap exponent(s), broadcastable vs tx/ty
        tx: (S,) or (K, S) first time component
        ty: (S,) or (K, S) second time component
        returns: broadcast(k, tx, ty) elementwise overlap
    """
    tx = np.asarray(tx, float)
    ty = np.asarray(ty, float)
    kk = np.maximum(np.asarray(k, float), 1.0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return _f_overlap_core(kk, tx, ty)


def _param_fields(k):
    """The seven model coefficients of ``k`` in evaluation-ready form.

    ``FitParams`` → plain scalars (the classic broadcast).  A ``(K, 7)``
    parameter matrix → seven ``(K, 1)`` columns, so every coefficient
    broadcasts a candidate axis against flat ``(S,)`` sample columns and
    one array pass evaluates K parameter vectors × S samples — the shape
    the fitting engine steps whole simplex tensors through.  Matrix mode
    therefore requires 1-D sample columns (not ``cols.expand()`` grids).
    """
    if isinstance(k, FitParams):
        return (k.k_bwd, k.k_sync, k.k_opt, k.k_opt_off, k.k_off,
                k.k_swap, k.k_const)
    m = np.asarray(k, float)
    if m.ndim == 1:
        m = m[None, :]
    if m.ndim != 2 or m.shape[1] != 7:
        raise ValueError(f"parameter matrix must be (K, 7), got {m.shape}")
    return tuple(m[:, i][:, None] for i in range(7))


@dataclass
class BatchBreakdown:
    """Array-valued Breakdown: every field broadcasts to a common shape;
    infeasible entries have t_iter = inf and zeroed parts (matching the
    scalar path's default Breakdown())."""
    t_fwd: np.ndarray
    t_bwd: np.ndarray
    t_comm_dp: np.ndarray
    t_comm_tp: np.ndarray
    t_comm_pp: np.ndarray
    t_opt: np.ndarray
    t_off: np.ndarray
    t_iter: np.ndarray


@dataclass(frozen=True)
class TiterStatics:
    """Everything in Eq. 1 that does NOT depend on the fittable 7-tuple,
    precomputed once per (plan columns × allocation) sample set.

    The fitting engine evaluates thousands of candidate parameter
    vectors against one fixed sample set; splitting the prediction into
    statics (computed once) + ``titer_from_statics`` (the ~10 array ops
    that actually involve ``k``) keeps each optimizer step cheap."""
    t_fwd: np.ndarray
    a_eff: np.ndarray
    gc_add: np.ndarray            # t_fwd where gc else 0 (bwd recompute)
    t_comm_dp: np.ndarray
    t_comm_tp: np.ndarray
    t_comm_pp: np.ndarray
    opt_scale: np.ndarray         # t_opt = k_opt * opt_scale (no offload)
    opt_scale_off: np.ndarray     # t_opt = k_opt_off * opt_scale_off
    t_off: np.ndarray
    off: np.ndarray               # bool
    infeas: np.ndarray            # bool


def titer_statics(profile: ModelProfile, cols: PlanColumns,
                  alloc_gpus, alloc_cpus, env: Env,
                  per_node=None) -> TiterStatics:
    """Precompute the k-independent parts of Eq. 1 for a sample set.

    ``cols`` holds plan columns; ``alloc_gpus``/``alloc_cpus`` (and
    optionally ``per_node`` — max GPUs of the allocation on one node) are
    arrays broadcastable against them.  Use ``cols.expand()`` with (G,)
    alloc vectors to get an (n_plans, G) grid, or flat same-length arrays
    for per-sample evaluation (as the fitting engine does).

    Shapes:
        profile: (model constants, not an array)
        cols: (S,) flat or (n_plans, 1) expanded plan columns
        alloc_gpus: (S,) or (G,) GPU counts, broadcastable vs cols
        alloc_cpus: (S,) or (G,) CPU counts, broadcastable vs cols
        env: (hardware constants, not an array)
        per_node: (S,)/(G,) max GPUs on one node, or None to derive
        returns: TiterStatics of fields broadcast(cols, alloc)
    """
    b, s, h, l, P = profile.b, profile.s, profile.h, profile.l, profile.P
    d = cols.dp.astype(float)
    t = cols.tp.astype(float)
    p = cols.pp.astype(float)
    a = cols.ga.astype(float)                    # already ≥ 1
    alloc_gpus = np.asarray(alloc_gpus)
    alloc_cpus = np.asarray(alloc_cpus, float)
    if per_node is None:
        per_node = np.minimum(alloc_gpus, env.gpus_per_node)
    per_node = np.asarray(per_node)

    infeas = (cols.n_gpus > alloc_gpus) | (np.mod(b, cols.dp * cols.ga) != 0)

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        # --- T_fwd --------------------------------------------------------
        pp_mode = p > 1
        m = np.where(pp_mode, np.where(a > 1, a, p), a)
        t_p = profile.t_fwd_unit * (b / (d * m)) * s / (t * p)
        t_fwd_pp = t_p * (m + p - 1)
        t_fwd_dp = profile.t_fwd_unit * ((b / (d * a)) * s) / t
        t_fwd = np.where(pp_mode, t_fwd_pp, t_fwd_dp)
        a_eff = np.where(pp_mode, 1.0, a)

        # --- T_comm -------------------------------------------------------
        bpp = 2.0
        V_dp = bpp * P * 2.0 * (d - 1) / np.maximum(d * t * p, 1.0)
        B_dp = np.where(d * t * p <= per_node, env.B_intra, env.B_inter)
        t_comm_dp = np.where(d > 1, V_dp / B_dp, 0.0)

        V_tp = 8.0 * (t - 1) * b * s * h * l * bpp / np.maximum(d * t, 1.0)
        B_tp = np.where(t <= per_node, env.B_intra, env.B_inter)
        t_comm_tp = np.where(t > 1, V_tp / B_tp, 0.0)

        V_pp = 2.0 * p * b * s * h * bpp / np.maximum(d * t, 1.0)
        B_pp = np.where(t * p <= per_node, env.B_intra, env.B_inter)
        t_comm_pp = np.where(p > 1, V_pp / B_pp, 0.0)

        # --- T_opt / T_off scales -----------------------------------------
        cpus_per_rank = np.maximum(alloc_cpus / np.maximum(d, 1.0), 1.0)
        x = np.where((t > 1) | (p > 1), t * p,
                     np.where(cols.zero >= 1, d, 1.0))
        off = cols.offload
        t_off = np.where(off, bpp * P / (d * env.B_pcie), 0.0)

    return TiterStatics(
        t_fwd=t_fwd, a_eff=a_eff,
        gc_add=np.where(cols.gc, t_fwd, 0.0),
        t_comm_dp=t_comm_dp, t_comm_tp=t_comm_tp, t_comm_pp=t_comm_pp,
        opt_scale=P / x, opt_scale_off=P / (d * cpus_per_rank),
        t_off=t_off, off=np.asarray(off, bool), infeas=infeas)


def _combine_statics(st: TiterStatics, k):
    """(t_bwd, t_opt, t_iter) from precomputed statics + one ``k``
    (``FitParams`` or a (K, 7) matrix — see ``_param_fields``)."""
    k_bwd, k_sync, k_opt, k_opt_off, k_off, k_swap, k_const = \
        _param_fields(k)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        t_bwd = k_bwd * st.t_fwd + st.gc_add
        t_opt = np.where(st.off, k_opt_off * st.opt_scale_off,
                         k_opt * st.opt_scale)
        sync = _f_overlap_core(np.maximum(np.asarray(k_sync, float), 1.0),
                               t_bwd, st.t_comm_dp)
        t_cc = np.where(st.a_eff > 1,
                        st.a_eff * st.t_fwd + (st.a_eff - 1) * t_bwd + sync,
                        st.t_fwd + sync + st.t_comm_tp + st.t_comm_pp)
        t_oo = np.where(st.off,
                        _f_overlap_core(
                            np.maximum(np.asarray(k_off, float), 1.0),
                            st.t_comm_dp, st.t_off) +
                        _f_overlap_core(
                            np.maximum(np.asarray(k_swap, float), 1.0),
                            t_opt, st.t_off),
                        t_opt)
        t_iter = t_cc + t_oo + k_const
    return t_bwd, t_opt, t_iter


def titer_from_statics(st: TiterStatics, k) -> np.ndarray:
    """T_iter only (inf where infeasible) — the fitting hot path: with a
    (K, 7) parameter matrix the result is (K, S), one row per candidate,
    in ~10 array ops instead of the full statics recomputation.

    Shapes:
        st: TiterStatics of (S,) sample columns
        k: FitParams or (K, 7) candidate parameter matrix
        returns: (S,) for FitParams, (K, S) for a parameter matrix
    """
    _, _, t_iter = _combine_statics(st, k)
    return np.where(st.infeas, np.inf, t_iter)


def predict_parts_batch(profile: ModelProfile, cols: PlanColumns,
                        alloc_gpus, alloc_cpus, env: Env, k,
                        per_node=None) -> BatchBreakdown:
    """All T_* parts of Eq. 1 for a whole plan table × allocation grid.

    ``k`` is a ``FitParams`` (classic scalar broadcast) or a ``(K, 7)``
    parameter matrix — then sample columns must be flat 1-D and every
    output field is ``(K, S)``: one full NumPy pass evaluates K candidate
    parameter vectors × S samples (the shape the batched fitting engine
    steps whole simplex tensors through).  Semantics are pinned to
    ``predict_parts`` by property tests (batch ≡ scalar to 1e-9), and
    matrix rows ≡ per-vector scalar passes in ``tests/test_fitting.py``.

    Shapes:
        profile: (model constants, not an array)
        cols: (S,) flat or (n_plans, 1) expanded plan columns
        alloc_gpus: (S,) or (G,) GPU counts, broadcastable vs cols
        alloc_cpus: (S,) or (G,) CPU counts, broadcastable vs cols
        env: (hardware constants, not an array)
        k: FitParams or (K, 7) candidate parameter matrix
        per_node: (S,)/(G,) max GPUs on one node, or None to derive
        returns: BatchBreakdown fields broadcast(cols, alloc) for
            FitParams, (K, S) for a parameter matrix
    """
    st = titer_statics(profile, cols, alloc_gpus, alloc_cpus, env, per_node)
    t_bwd, t_opt, t_iter = _combine_statics(st, k)

    def _mask(arr):
        return np.where(st.infeas, 0.0, arr)

    return BatchBreakdown(
        t_fwd=_mask(np.broadcast_to(st.t_fwd, t_iter.shape)),
        t_bwd=_mask(t_bwd),
        t_comm_dp=_mask(np.broadcast_to(st.t_comm_dp, t_iter.shape)),
        t_comm_tp=_mask(np.broadcast_to(st.t_comm_tp, t_iter.shape)),
        t_comm_pp=_mask(np.broadcast_to(st.t_comm_pp, t_iter.shape)),
        t_opt=_mask(t_opt),
        t_off=_mask(np.broadcast_to(st.t_off, t_iter.shape)),
        t_iter=np.where(st.infeas, np.inf, t_iter))


def predict_titer_batch(profile, cols, alloc_gpus, alloc_cpus, env, k,
                        per_node=None) -> np.ndarray:
    """T_iter per entry (inf where infeasible).

    Shapes:
        profile: (model constants, not an array)
        cols: (S,) flat or (n_plans, 1) expanded plan columns
        alloc_gpus: (S,) or (G,) GPU counts, broadcastable vs cols
        alloc_cpus: (S,) or (G,) CPU counts, broadcastable vs cols
        env: (hardware constants, not an array)
        k: FitParams or (K, 7) candidate parameter matrix
        per_node: (S,)/(G,) max GPUs on one node, or None to derive
        returns: broadcast(cols, alloc) for FitParams, (K, S) for a
            parameter matrix
    """
    return predict_parts_batch(profile, cols, alloc_gpus, alloc_cpus, env, k,
                               per_node).t_iter


def predict_throughput_batch(profile, cols, alloc_gpus, alloc_cpus, env, k,
                             per_node=None) -> np.ndarray:
    """Samples/sec per entry; 0 where infeasible (matching scalar).

    Shapes:
        profile: (model constants, not an array)
        cols: (S,) flat or (n_plans, 1) expanded plan columns
        alloc_gpus: (S,) or (G,) GPU counts, broadcastable vs cols
        alloc_cpus: (S,) or (G,) CPU counts, broadcastable vs cols
        env: (hardware constants, not an array)
        k: FitParams or (K, 7) candidate parameter matrix
        per_node: (S,)/(G,) max GPUs on one node, or None to derive
        returns: broadcast(cols, alloc) for FitParams, (K, S) for a
            parameter matrix
    """
    t = predict_titer_batch(profile, cols, alloc_gpus, alloc_cpus, env, k,
                            per_node)
    ok = np.isfinite(t) & (t > 0)
    return np.where(ok, profile.b / np.where(ok, t, 1.0), 0.0)


def predict_throughput(profile, plan, alloc, env, k) -> float:
    """Samples/sec = b / T_iter."""
    t = predict_titer(profile, plan, alloc, env, k)
    return profile.b / t if t > 0 and math.isfinite(t) else 0.0


# ---------------------------------------------------------------------------
# Continuous model fitting (Sec 4.3)
# ---------------------------------------------------------------------------

def sample_arrays(samples, env: Env):
    """Flatten a (plan, alloc, measured T_iter) sample list into batched
    predictor inputs: (cols, alloc_gpus, alloc_cpus, per_node, true) —
    the ONE place the fit loss, its scoring paths, and
    ``prediction_error`` agree on how samples become columns.

    Shapes:
        samples: length-S list of (plan, alloc, t_iter) tuples
        env: (hardware constants, not an array)
        returns: (cols (S,), alloc_gpus (S,), alloc_cpus (S,),
            per_node (S,), true (S,))
    """
    cols = PlanColumns.from_plans([pl for pl, _, _ in samples])
    a_gpus = np.array([al.gpus for _, al, _ in samples])
    a_cpus = np.array([al.cpus for _, al, _ in samples], float)
    a_node = np.array([al.max_gpus_on_node(env) for _, al, _ in samples])
    true = np.array([t for _, _, t in samples])
    return cols, a_gpus, a_cpus, a_node, true


_BOUNDS = [(1.0, 5.0),      # k_bwd
           (1.0, 64.0),     # k_sync
           (1e-13, 1e-8),   # k_opt
           (1e-12, 1e-7),   # k_opt_off
           (1.0, 64.0),     # k_off
           (1.0, 64.0),     # k_swap
           (0.0, 1.0)]      # k_const


def rmsle(pred: np.ndarray, true: np.ndarray) -> float:
    pred = np.maximum(pred, 1e-9)
    true = np.maximum(true, 1e-9)
    return float(np.sqrt(np.mean(np.square(np.log(pred) - np.log(true)))))


def fit(profile: ModelProfile, samples: list[tuple[ExecutionPlan, Alloc, float]],
        env: Env | None = None, x0: FitParams | None = None,
        engine: str = "batched", maxiter: int = 3000) -> FitParams:
    """Fit the 7-tuple to (plan, alloc, measured T_iter) samples by RMSLE.

    Paper: ≥7 points, ≥3 exercising ZeRO-Offload when that strategy is in
    the plan space; the model is refit online when prediction error exceeds
    a threshold — in the reference, ``repro.calibration`` runs that loop
    through ``fit_batch`` (warm-started at ``x0=current``); the port has
    the fit, not that loop.

    ``engine="batched"`` (default) is that same vectorized multi-start
    Nelder-Mead — all restarts stepped as one batched simplex tensor
    through the (K, 7)-parameter-matrix predictors, with per-restart
    convergence masking and an RMSLE-plateau early stop.
    ``engine="scalar"`` keeps the serial scipy Nelder-Mead reference;
    the reference states batched window RMSLE ≤ scalar's within 1e-6 as
    a property that fresh draws have falsified (ROADMAP, Quirks); both
    engines here give the reference's outputs.
    """
    env = env or Env()
    if engine == "batched":
        from repro_torch.core.fitting import FitRequest, fit_batch
        return fit_batch([FitRequest(profile=profile, samples=tuple(samples),
                                     env=env, x0=x0)], maxiter=maxiter)[0]
    if engine != "scalar":
        raise ValueError(f"unknown fit engine {engine!r}")
    from scipy.optimize import minimize

    x0 = (x0 or FitParams()).as_vector()
    lo = np.array([b[0] for b in _BOUNDS])
    hi = np.array([b[1] for b in _BOUNDS])

    def unpack(z):
        return FitParams.from_vector(lo + (hi - lo) / (1 + np.exp(-z)))

    # vectorize the loss: flatten samples into plan columns + alloc columns
    # once, then each Nelder-Mead evaluation is a single batched pass
    cols, a_gpus, a_cpus, a_node, true = sample_arrays(samples, env)

    def loss(z):
        """Shapes:
            z: (7,) sigmoid-space parameter vector
            returns: scalar RMSLE over the feasible samples
        """
        k = unpack(z)
        pred = predict_titer_batch(profile, cols, a_gpus, a_cpus, env, k,
                                   per_node=a_node)
        ok = np.isfinite(pred)
        if not ok.any():
            return 1e6
        return rmsle(pred[ok], true[ok])

    z0 = -np.log(np.clip((hi - lo) / np.clip(x0 - lo, 1e-12, None) - 1.0,
                         1e-9, 1e9))
    best, best_val = z0, loss(z0)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        start = z0 + rng.normal(0, 1.0, size=z0.shape) * (seed > 0)
        res = minimize(loss, start, method="Nelder-Mead",
                       options={"maxiter": maxiter, "fatol": 1e-7,
                                "xatol": 1e-7})
        if res.fun < best_val:
            best, best_val = res.x, res.fun
    return unpack(best)


def prediction_error(profile, k: FitParams,
                     samples: list[tuple[ExecutionPlan, Alloc, float]],
                     env: Env | None = None) -> tuple[float, float]:
    """(avg, max) relative T_iter error — the paper's Table 2 metric.

    One batched predictor pass over the whole sample set (the old
    per-sample ``predict_titer`` loop made the Table-2 benchmark path an
    interpreter loop)."""
    env = env or Env()
    if not samples:
        return float("nan"), float("nan")
    cols, a_gpus, a_cpus, a_node, true = sample_arrays(samples, env)
    pred = predict_titer_batch(profile, cols, a_gpus, a_cpus, env, k,
                               per_node=a_node)
    ok = np.isfinite(pred) & (true > 0)
    if not ok.any():
        return float("nan"), float("nan")
    errs = np.abs(pred[ok] - true[ok]) / true[ok]
    return float(np.mean(errs)), float(np.max(errs))
