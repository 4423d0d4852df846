"""Deterministic, elastically-shardable synthetic data pipeline.

Every batch is a pure function of (seed, step, global position) — so any
worker can regenerate exactly its shard after an elastic restart or a
plan reconfiguration (no data-order drift across Rubick reconfigs, which is
what keeps the loss curves seed-equivalent in the Fig 9 experiment).

A copy of the synthetic source of ``repro.data.pipeline`` (numpy only), so
that the port and the JAX package train on the same batches.  The
reference's file-backed source and per-host shards wait for a launcher flag
and for multi-process training to read them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokens:
    """Markov-ish synthetic stream: learnable structure (not iid uniform) so
    training losses actually decrease in the examples."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._mix = rng.integers(1, v, size=257).astype(np.int64)

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) % 2**31)
        b = rng.integers(0, cfg.vocab_size,
                         size=(cfg.global_batch, cfg.seq_len),
                         dtype=np.int64)
        # inject predictable continuation structure
        key = self._mix[b[:, :-1] % 257]
        b[:, 1:] = np.where(rng.random(b[:, 1:].shape) < 0.7,
                            (b[:, :-1] + key) % cfg.vocab_size, b[:, 1:])
        return b.astype(np.int32)


def make_source(cfg: DataConfig):
    return SyntheticTokens(cfg)
