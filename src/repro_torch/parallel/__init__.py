"""Execution plans and their placements: copies of ``repro.parallel.plan``,
``sharding`` and ``axes``, and this rank's layout (``layout``)."""
