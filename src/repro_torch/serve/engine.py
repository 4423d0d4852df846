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
    def generate(self, tokens: torch.Tensor, steps: int) -> torch.Tensor:
        """tokens: prompt ids (B, S) on the model's device.  Returns the
        greedy continuation (B, steps + 1): the token after the prompt, then
        one per decode step."""
        B = tokens.shape[0]
        cache = self.model.init_cache(B, self.max_len)
        cache, logits = self.model.prefill(self.params, cache, tokens)
        out = []
        tok = logits.argmax(dim=-1)
        for _ in range(steps):
            out.append(tok)
            cache, logits = self.model.decode_step(self.params, cache, tok)
            tok = logits.argmax(dim=-1)
        out.append(tok)
        return torch.stack(out, dim=1)
