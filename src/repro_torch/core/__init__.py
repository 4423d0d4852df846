"""Rubick's host-side performance model and its oracles: copies of
``repro.core``'s ``costs``, ``perfmodel``, ``fitting``, ``memory``,
``paper_models`` and the analytic half of ``oracle``, plus
``oracle.TorchMicroOracle``, which times the port's own train steps."""
