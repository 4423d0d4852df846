"""Execution plans, the paper's central object: a copy of
``repro.parallel.plan`` (``ExecutionPlan`` with its fields, ``n_gpus``,
``strategy``, ``with_`` and ``validate``, and ``enumerate_plans``) so that a
plan means the same thing on both sides of a restart and to the
performance model (``repro_torch.core``).

``repro_torch.train.step.compile_train_step`` acts on the plan over a
``torch.distributed`` mesh: ``dp`` (replicas, gradients all-reduced),
``zero_stage`` 1 (moments sharded) and 3 (FSDP2), ``tp`` (the dense
decoders' column/row split), ``offload`` (moments in pinned host memory),
``ga_steps`` and ``gc``.  ``pp > 1`` and ``sp`` raise there (ROADMAP A14b).
``make_train_step`` and the launcher stay on one device, as the
reference's do (it jits the step with no shardings,
``repro/launch/train.py:55``): there only ``ga_steps`` and ``gc`` act.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator


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
    def n_gpus(self) -> int:
        return self.dp * self.tp * self.pp

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

    def with_(self, **kw) -> "ExecutionPlan":
        return replace(self, **kw)

    def validate(self) -> None:
        """The reference's checks, raised as ValueError (asserts vanish
        under ``python -O``), plus ``ga_steps >= 1``."""
        if min(self.dp, self.tp, self.pp, self.ga_steps) < 1:
            raise ValueError(f"plan sizes must be >= 1: {self}")
        if self.zero_stage not in (0, 1, 3):
            raise ValueError(f"zero_stage must be 0, 1 or 3: {self}")
        if self.offload and self.zero_stage < 1:
            raise ValueError(f"offload implies ZeRO partitioning (zero_stage >= 1): {self}")


def _pows2(n: int) -> list[int]:
    out, v = [], 1
    while v <= n:
        out.append(v)
        v *= 2
    return out


def enumerate_plans(n_gpus: int, global_batch: int,
                    max_ga: int = 16, allow_tp_pp: bool = True,
                    ) -> Iterator[ExecutionPlan]:
    """All feasible plan skeletons for a GPU count (paper Sec 5.2: the
    scheduler enumerates candidate plans per resource amount), in the
    reference's order."""
    seen = set()
    for tp in (_pows2(min(n_gpus, 8)) if allow_tp_pp else [1]):
        for pp in (_pows2(n_gpus // tp) if allow_tp_pp else [1]):
            if n_gpus % (tp * pp):
                continue
            dp = n_gpus // (tp * pp)
            if global_batch % dp:
                continue
            for ga in _pows2(min(max_ga, global_batch // dp)):
                base = [ExecutionPlan(dp=dp, tp=tp, pp=pp, ga_steps=ga)]
                if tp == 1 and pp == 1:
                    base += [
                        ExecutionPlan(dp=dp, zero_stage=1, ga_steps=ga),
                        ExecutionPlan(dp=dp, zero_stage=3, ga_steps=ga),
                        ExecutionPlan(dp=dp, zero_stage=1, offload=True,
                                      ga_steps=ga),
                    ]
                for p in base:
                    for gc in (False, True):
                        q = p.with_(gc=gc)
                        if q not in seen:
                            seen.add(q)
                            yield q
