"""Correctness tooling for the scheduling core: the port's copy of
``repro.analysis.sanitize_enabled``, which the scheduler and the
calibration manager read at construction.

The reference's runtime ``SchedSanitizer`` (``repro/analysis/sanitizer.py``)
and its linter are not ported yet (ROADMAP A13c).  Where sanitizing is on,
``RubickScheduler`` and ``CalibrationManager`` call ``require_no_sanitizer``,
which raises instead of running without the checks.
"""

from __future__ import annotations

import os

__all__ = ["sanitize_enabled", "require_no_sanitizer"]

_FALSEY = ("", "0", "false", "no", "off")


def sanitize_enabled(cfg=None) -> bool:
    """Whether runtime sanitizing is on: the config flag, or the
    ``REPRO_SANITIZE`` environment variable."""
    if cfg is not None and getattr(cfg, "sanitize", False):
        return True
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() \
        not in _FALSEY


def require_no_sanitizer(owner: str, cfg=None) -> None:
    """Raise ``NotImplementedError`` when sanitizing is on for ``owner``:
    the port has no ``SchedSanitizer`` yet."""
    if sanitize_enabled(cfg):
        raise NotImplementedError(
            f"{owner}: sanitizing is on (SchedulerConfig(sanitize=True) or "
            f"REPRO_SANITIZE), but SchedSanitizer is not ported yet (ROADMAP A13c)")
