"""Execution plans, the paper's central object: a copy of
``repro.parallel.plan.ExecutionPlan`` (fields, ``strategy``, ``validate``)
so that a plan means the same thing on both sides of a restart.

The port trains on one device, as the reference's launcher does (it jits the
step with no shardings, ``repro/launch/train.py:55``).  So only ``ga_steps``
(gradient accumulation over microbatches) and ``gc`` (gradient
checkpointing: ``ModelOpts(remat="full")``) act; ``dp``, ``tp``, ``pp``,
``zero_stage``, ``offload`` and ``sp`` are carried and named but do nothing
until the parallel plans are ported (ROADMAP A14).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ExecutionPlan:
    dp: int = 1                   # data-parallel size (model replicas)
    tp: int = 1                   # tensor-parallel size
    pp: int = 1                   # pipeline stages
    zero_stage: int = 0           # 0: plain DP; 1: ZeRO-DP (opt states); 3: FSDP
    ga_steps: int = 1             # gradient accumulation micro-steps
    gc: bool = False              # gradient checkpointing (remat)
    offload: bool = False         # ZeRO-Offload: opt states in host memory
    sp: bool = False              # sequence-parallel activations (Megatron-SP)

    @property
    def strategy(self) -> str:
        """Human-readable plan family, matching the paper's naming."""
        parts = []
        if self.tp > 1 or self.pp > 1:
            dims = []
            if self.dp > 1:
                dims.append(f"DP{self.dp}")
            if self.tp > 1:
                dims.append(f"TP{self.tp}")
            if self.pp > 1:
                dims.append(f"PP{self.pp}")
            parts.append("+".join(dims) if dims else "3D")
        elif self.offload:
            parts.append("ZeRO-Offload")
        elif self.zero_stage == 3:
            parts.append("FSDP")
        elif self.zero_stage == 1:
            parts.append("ZeRO-DP")
        else:
            parts.append("DP")
        if self.ga_steps > 1:
            parts.append("GA")
        if self.gc:
            parts.append("GC")
        return "+".join(parts)

    def validate(self) -> None:
        """The reference's checks, raised as ValueError (asserts vanish
        under ``python -O``), plus ``ga_steps >= 1``."""
        if min(self.dp, self.tp, self.pp, self.ga_steps) < 1:
            raise ValueError(f"plan sizes must be >= 1: {self}")
        if self.zero_stage not in (0, 1, 3):
            raise ValueError(f"zero_stage must be 0, 1 or 3: {self}")
        if self.offload and self.zero_stage < 1:
            raise ValueError(f"offload implies ZeRO partitioning (zero_stage >= 1): {self}")
