"""Per-GPU / per-host memory estimation (paper: AllocMem + the OOM
feasibility inside the minRes search of Algorithm 1): a copy of
``repro.core.memory``, constants included.  Those constants were set for
the reference's A800 story; ``TorchMicroOracle`` and ``chip_smoke.py``'s
``profile`` phase report where the H100's measured peaks and this model's
verdicts disagree, and nothing here is fitted to them.

Mixed-precision accounting (DeepSpeed/Megatron convention):
  weights 2 B/param, grads 2, optimizer states (fp32 master + Adam m,v) 12
  → 16 B/param total, partitioned per strategy:

    plain DP      : 16·P / (t·p)
    ZeRO-DP (z≥1) : (2+2)·P/(t·p) + 12·P/(d·t·p)       (ZeRO-2 by default)
    FSDP (z=3)    : 16·P / (d·t·p)
    ZeRO-Offload  : GPU keeps 2·P/d (+grad buckets); 12·P/d + 2·P/d on host

Activations: c_act·b_micro·s·h·l/(t·p) bytes with c_act ≈ 34 half-precision
copies per transformer layer; gradient checkpointing keeps layer boundaries
(2 bytes) + one live layer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.perfmodel import Alloc, Env, ModelProfile
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.parallel.plan_table import PlanColumns

C_ACT = 34.0          # bytes/token/hidden/layer without GC (bf16 copies)
C_ACT_GC = 2.0        # checkpointed boundaries
FRAMEWORK_OVERHEAD = 4e9

# checkpoint-restore cost model (failure & elasticity engine): a restart
# reloads weights (2 B/param) + optimizer states (fp32 master + Adam m,v,
# 12 B/param) from shared storage — grads are not checkpointed
CKPT_BYTES_PER_PARAM = 14.0
RESTORE_BANDWIDTH = 4e9       # bytes/s aggregate read from shared storage
RESTORE_OVERHEAD_S = 8.0      # process respawn + NCCL re-init floor


def ckpt_state_bytes(profile: ModelProfile) -> float:
    """Bytes a periodic checkpoint of this model persists (all shards)."""
    return CKPT_BYTES_PER_PARAM * profile.P


def restore_seconds(nbytes: float) -> float:
    """Seconds to restore ``nbytes`` of checkpoint state (same model for
    simulated restarts and ``checkpoint.restore_cost_estimate`` on real
    pytrees)."""
    return nbytes / RESTORE_BANDWIDTH + RESTORE_OVERHEAD_S


def restore_cost(profile: ModelProfile | None = None,
                 nbytes: float | None = None) -> float:
    """The single restore-pause pricing entry point: pass exactly one of
    ``profile`` (analytic — simulator restarts, sized from the model) or
    ``nbytes`` (measured — real pytree leaves).  Both routes go through
    the same bandwidth model so the simulator and
    ``CheckpointManager.restore_cost_estimate`` cannot drift."""
    if (profile is None) == (nbytes is None):
        raise ValueError("restore_cost: pass exactly one of profile=, "
                         "nbytes=")
    if profile is not None:
        nbytes = ckpt_state_bytes(profile)
    return restore_seconds(float(nbytes))


@dataclass(frozen=True)
class MemEstimate:
    gpu_bytes: float
    host_bytes: float
    cpu_needed: int

    def fits(self, env: Env, cpus: int, host_mem: float) -> bool:
        return (self.gpu_bytes <= env.gpu_mem
                and self.host_bytes <= host_mem
                and self.cpu_needed <= cpus)


def estimate(profile: ModelProfile, plan: ExecutionPlan, alloc: Alloc,
             env: Env | None = None) -> MemEstimate:
    env = env or Env()
    d, t, p, a = plan.dp, plan.tp, plan.pp, max(plan.ga_steps, 1)
    P = profile.P
    shard = t * p

    if plan.offload:
        weights = 2.0 * P / (d * shard)
        grads = 2.0 * P / (d * shard)
        opt = 0.0
        host = (12.0 + 2.0) * P / d
        cpu_needed = max(1, alloc.gpus // max(d, 1))
    else:
        host = 1e9
        cpu_needed = 1
        if plan.zero_stage == 3:
            weights = 2.0 * P / (d * shard)
            grads = 2.0 * P / (d * shard)
            opt = 12.0 * P / (d * shard)
        elif plan.zero_stage >= 1:
            weights = 2.0 * P / shard
            grads = 2.0 * P / (d * shard)
            opt = 12.0 * P / (d * shard)
        else:
            weights = 2.0 * P / shard
            grads = 2.0 * P / shard
            opt = 12.0 * P / shard

    b_micro = profile.b / max(d * a, 1)
    c_act = C_ACT_GC if plan.gc else C_ACT
    act = c_act * b_micro * profile.s * profile.h * profile.l / shard
    if plan.gc:
        act += C_ACT * b_micro * profile.s * profile.h / shard  # live layer

    gpu = weights + grads + opt + act + FRAMEWORK_OVERHEAD
    return MemEstimate(gpu_bytes=gpu, host_bytes=host, cpu_needed=cpu_needed)


def feasible(profile: ModelProfile, plan: ExecutionPlan, alloc: Alloc,
             env: Env | None = None, host_mem: float | None = None) -> bool:
    """OOM check used by minRes / GetBestPlan (Algorithm 1 lines 19-23)."""
    env = env or Env()
    if plan.n_gpus > alloc.gpus:
        return False
    if profile.b % (plan.dp * max(plan.ga_steps, 1)):
        return False
    est = estimate(profile, plan, alloc, env)
    hm = host_mem if host_mem is not None else env.host_mem
    return est.fits(env, max(alloc.cpus, 1), hm)


# ---------------------------------------------------------------------------
# Batched twin (vectorized over a plan table × allocation grid)
# ---------------------------------------------------------------------------

def estimate_batch(profile: ModelProfile, cols: PlanColumns,
                   alloc_gpus, alloc_cpus, env: Env | None = None,
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(gpu_bytes, host_bytes, cpu_needed) arrays — elementwise identical to
    ``estimate`` over broadcastable plan/alloc columns (pinned by tests).

    Shapes:
        profile: (model constants, not an array)
        cols: (S,) flat or (n_plans, 1) expanded plan columns
        alloc_gpus: (S,) or (G,) GPU counts, broadcastable vs cols
        alloc_cpus: (S,) or (G,) CPU counts, broadcastable vs cols
        env: (hardware constants, not an array)
        returns: (gpu_bytes, host_bytes, cpu_needed), each
            broadcast(cols, alloc)
    """
    env = env or Env()
    P = profile.P
    d = cols.dp.astype(float)
    shard = (cols.tp * cols.pp).astype(float)
    off = cols.offload
    z = cols.zero
    alloc_gpus = np.asarray(alloc_gpus)

    with np.errstate(divide="ignore", invalid="ignore"):
        # non-offload sharding tiers
        w_z3 = 2.0 * P / (d * shard)
        w_else = 2.0 * P / shard
        weights = np.where(z == 3, w_z3, w_else)
        grads = np.where(z >= 1, 2.0 * P / (d * shard), 2.0 * P / shard)
        opt = np.where(z >= 1, 12.0 * P / (d * shard), 12.0 * P / shard)
        # offload overrides
        weights = np.where(off, 2.0 * P / (d * shard), weights)
        grads = np.where(off, 2.0 * P / (d * shard), grads)
        opt = np.where(off, 0.0, opt)
        host = np.where(off, (12.0 + 2.0) * P / d, 1e9)
        cpu_needed = np.where(
            off, np.maximum(1, alloc_gpus // np.maximum(cols.dp, 1)), 1)

        b_micro = profile.b / np.maximum(cols.dp * cols.ga, 1).astype(float)
        c_act = np.where(cols.gc, C_ACT_GC, C_ACT)
        act = c_act * b_micro * profile.s * profile.h * profile.l / shard
        act = act + np.where(
            cols.gc, C_ACT * b_micro * profile.s * profile.h / shard, 0.0)

        gpu = weights + grads + opt + act + FRAMEWORK_OVERHEAD
    shape = np.broadcast_shapes(gpu.shape, np.shape(host),
                                np.shape(cpu_needed))
    return (np.broadcast_to(gpu, shape), np.broadcast_to(host, shape),
            np.broadcast_to(cpu_needed, shape))


def feasible_mask(profile: ModelProfile, cols: PlanColumns,
                  alloc_gpus, alloc_cpus, env: Env | None = None,
                  host_mem: float | None = None) -> np.ndarray:
    """Vectorized ``feasible``: the OOM + divisibility + size mask."""
    env = env or Env()
    alloc_gpus = np.asarray(alloc_gpus)
    alloc_cpus = np.asarray(alloc_cpus)
    gpu, host, cpu_needed = estimate_batch(profile, cols, alloc_gpus,
                                           alloc_cpus, env)
    hm = host_mem if host_mem is not None else env.host_mem
    ok = (cols.n_gpus <= alloc_gpus)
    ok = ok & (np.mod(profile.b, cols.dp * np.maximum(cols.ga, 1)) == 0)
    ok = ok & (gpu <= env.gpu_mem) & (host <= hm)
    ok = ok & (cpu_needed <= np.maximum(alloc_cpus, 1))
    return ok
