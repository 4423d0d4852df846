"""Flaky reconfiguration / checkpoint / restore operations.

A copy of ``repro.health.flaky`` for the port.

Real cluster operations fail gray: a reconfiguration hangs on a bad
NCCL re-init, a restore stalls against overloaded storage.  ``FlakyOps``
gives each simulated operation a failure probability, a timeout, and a
bounded exponential-backoff retry budget.  Failures are deterministic
in (seed, op, job, occurrence) — the same run replays identically, and
the event/discrete engines see the same outcomes.

``attempt(op, job)`` prices one operation: it returns whether the op
eventually succeeded, the extra seconds burned on failed attempts
(timeout + backoff per failure), and how many attempts were made.  The
simulator charges the extra seconds as pause time; on exhaustion the
reconfig path rolls back to the prior committed plan and the restore
path re-queues the job, and in both cases the target node's health
score is debited.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


def _unit_hash(*keys) -> float:
    """Deterministic uniform in [0, 1) from the key tuple (same idiom
    as the oracle's hidden-truth draw; duplicated here to keep health
    free of a core-oracle import cycle)."""
    h = hashlib.sha256("|".join(str(k) for k in keys).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


@dataclass(frozen=True)
class FlakyConfig:
    fail_p: float = 0.15          # per-attempt failure probability
    timeout_s: float = 90.0       # seconds burned per failed attempt
    backoff_s: float = 30.0       # base backoff; doubles per retry
    max_attempts: int = 3
    seed: int = 0
    ops: tuple[str, ...] = ("reconfig", "restore", "checkpoint")

    def __post_init__(self):
        if not (0.0 <= self.fail_p < 1.0):
            raise ValueError(f"fail_p must be in [0, 1), "
                             f"got {self.fail_p!r}")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts!r}")


@dataclass
class OpOutcome:
    ok: bool
    delay_s: float                # extra seconds from failed attempts
    n_attempts: int


class FlakyOps:
    def __init__(self, cfg: FlakyConfig | None = None):
        self.cfg = cfg or FlakyConfig()
        self._occurrence: dict[tuple[str, str], int] = {}
        self.n_retries = 0        # failed attempts that were retried
        self.n_rollbacks = 0      # exhaustions (budget spent, op failed)

    def attempt(self, op: str, job: str) -> OpOutcome:
        """Price one operation of type ``op`` for ``job``.  Each failed
        attempt costs ``timeout_s + backoff_s * 2**i``; after
        ``max_attempts`` failures the op is exhausted (``ok=False``)."""
        cfg = self.cfg
        if op not in cfg.ops or cfg.fail_p <= 0.0:
            return OpOutcome(True, 0.0, 1)
        key = (op, job)
        occ = self._occurrence.get(key, 0)
        self._occurrence[key] = occ + 1
        delay = 0.0
        for i in range(cfg.max_attempts):
            if _unit_hash(cfg.seed, op, job, occ, i) >= cfg.fail_p:
                return OpOutcome(True, delay, i + 1)
            delay += cfg.timeout_s + cfg.backoff_s * (2.0 ** i)
            if i + 1 < cfg.max_attempts:
                self.n_retries += 1
        self.n_rollbacks += 1
        return OpOutcome(False, delay, cfg.max_attempts)
