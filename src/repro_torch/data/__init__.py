"""Token sources: a copy of ``repro.data.pipeline``."""
