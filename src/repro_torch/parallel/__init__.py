"""Execution plans: a copy of ``repro.parallel.plan`` (single device)."""
