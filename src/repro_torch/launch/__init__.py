"""Entry points of the port: ``serve`` and ``train``."""

from __future__ import annotations

import torch


def launch_device(device, reduced: bool) -> torch.device:
    """The device a launcher runs on, resolved before anything is built: no
    card raises (``models.api.resolve_device``), and so does a reduced
    config on the card, up front rather than deep inside a kernel check."""
    from repro_torch.models.api import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and reduced:
        raise ValueError("reduced configs have head dim 16 (SSD and WKV6 state 16), which "
                         "the kernels do not take; pass --full to run the full config on "
                         "the card, or --device cpu for the reduced one on the CPU")
    return dev
