"""Model API for the port: ``build(cfg, device=None, dtype=None, seed=0)``.

The torch twin of ``repro.models.api`` for the dense decoder family:

    init() -> params (a Decoder module, weights drawn on ``device`` from ``seed``)
    load(state) -> params (weights from ``repro_torch.convert``)
    init_cache(batch, max_len) -> cache
    prefill(params, cache, tokens (B,S)) -> (cache, logits (B,V))
    decode_step(params, cache, tokens (B,)) -> (cache, logits (B,V))

``device`` defaults to ``cuda``; with no card the build raises unless the
caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn, transformer


def resolve_device(device) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the port's plain CPU path")
    return dev


_LATER = (("n_experts", "MoE: ROADMAP A15"), ("mla", "MLA: ROADMAP A15"),
          ("mtp_depth", "MTP: ROADMAP A15"), ("attn_every", "hybrid: ROADMAP A16"),
          ("ssm_state", "SSM: ROADMAP A16"), ("rwkv", "RWKV-6: ROADMAP A17"),
          ("enc_layers", "encoder-decoder: ROADMAP A18"))


def _unported(cfg: ModelConfig) -> str | None:
    """Which later slice a config needs, or None for the dense decoder."""
    for flag, item in _LATER:
        if getattr(cfg, flag):
            return item
    if cfg.frontend != "none":
        return f"{cfg.frontend} frontend: ROADMAP A18"
    if cfg.family != "dense":
        return f"family {cfg.family!r}: ROADMAP A15-A18"
    return None


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    seed: int = 0

    def init(self) -> transformer.Decoder:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        params = transformer.Decoder(self.cfg, self.device, self.dtype)
        params.reset_parameters(gen)
        return params.eval()

    def load(self, state: dict[str, torch.Tensor]) -> transformer.Decoder:
        """Weights from a state dict (see ``repro_torch.convert``); every key
        must be present and match in shape and dtype."""
        params = transformer.Decoder(self.cfg, self.device, self.dtype)
        for name, t in state.items():
            if t.dtype != self.dtype:
                raise ValueError(f"{name}: dtype {t.dtype}, model is {self.dtype}")
        params.load_state_dict(state, strict=True)
        return params.eval()

    def init_cache(self, batch: int, max_len: int) -> dict:
        return transformer.decoder_init_cache(self.cfg, batch, max_len,
                                              device=self.device, dtype=self.dtype)

    @torch.no_grad()
    def prefill(self, params, cache: dict, tokens: torch.Tensor):
        return transformer.decoder_prefill(params, cache, tokens, self.cfg)

    @torch.no_grad()
    def decode_step(self, params, cache: dict, tokens: torch.Tensor):
        return transformer.decoder_decode_step(params, cache, tokens, self.cfg)


def build(cfg: ModelConfig, device=None, dtype=None, seed: int = 0) -> Model:
    why = _unported(cfg)
    if why:
        raise NotImplementedError(f"{cfg.name}: not ported yet ({why})")
    dtype = nn.dtype_of(cfg.dtype) if dtype is None else dtype
    return Model(cfg, resolve_device(device), dtype, seed)
