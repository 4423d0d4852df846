"""Correctness tooling for the scheduling core, copied from
``repro.analysis``: a runtime ``SchedSanitizer``
(``repro_torch.analysis.sanitizer``) that cross-checks the incremental
engine's persistent indexes against recomputed ground truth, enabled by
``SchedulerConfig(sanitize=True)`` or ``REPRO_SANITIZE=1``.  The
reference's static invariant linter (``repro.analysis.lint``) is not
ported yet (ROADMAP A13d).

This module stays import-light: the scheduler imports it for
``sanitize_enabled`` at module load, and the sanitizer imports the
scheduler — the heavy pieces load lazily to keep that cycle open.
"""

from __future__ import annotations

import os

__all__ = ["sanitize_enabled", "SchedSanitizer", "SanitizerViolation"]

_FALSEY = ("", "0", "false", "no", "off")


def sanitize_enabled(cfg=None) -> bool:
    """Whether runtime sanitizing is on: the config flag, or the
    ``REPRO_SANITIZE`` environment variable."""
    if cfg is not None and getattr(cfg, "sanitize", False):
        return True
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() \
        not in _FALSEY


def __getattr__(name):
    if name in ("SchedSanitizer", "SanitizerViolation"):
        from repro_torch.analysis import sanitizer
        return getattr(sanitizer, name)
    raise AttributeError(name)
