"""Serving runtime for the port: a batched greedy-decoding engine, the torch
twin of ``repro.serve.engine.ServeEngine``.

PyTorch runs eagerly, so there is no compile step: prefill and decode are
the model's own functions, and the KV cache is allocated once per
``generate`` call and updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.models.api import Model


class ServeEngine:
    """Minimal batched greedy-decoding engine (single-process runtime)."""

    def __init__(self, model: Model, params, max_len: int = 256):
        self.model = model
        self.params = params
        self.max_len = max_len

    @torch.no_grad()
    def generate(self, batch, steps: int) -> torch.Tensor:
        """batch: the prompt on the model's device, {"tokens": (B, S)} plus
        the config's modality stub ("frames" or "patches", as
        ``Model.prefill`` takes it), or a bare token tensor.  Returns the
        greedy continuation (B, steps + 1): the token after the prompt, then
        one per decode step."""
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        cache = self.model.init_cache(tokens.shape[0], self.max_len)
        cache, logits = self.model.prefill(self.params, cache, batch)
        out = []
        tok = logits.argmax(dim=-1)
        for _ in range(steps):
            out.append(tok)
            cache, logits = self.model.decode_step(self.params, cache, tok)
            tok = logits.argmax(dim=-1)
        out.append(tok)
        return torch.stack(out, dim=1)
