"""Model API for the port: ``build(cfg, device=None, dtype=None, seed=0,
opts=None)``.

The torch twin of ``repro.models.api``, dispatched by family as the
reference dispatches (dense and MoE / MLA decoders, hybrid Mamba-2 + shared
attention, RWKV-6):

    init() -> params (an nn.Module, weights drawn on ``device`` from ``seed``)
    load(state) -> params (weights from ``repro_torch.convert``)
    loss(params, batch {"tokens": (B,S)}) -> (scalar, metrics)   [train step]
    init_cache(batch, max_len) -> cache
    prefill(params, cache, tokens (B,S)) -> (cache, logits (B,V))
    decode_step(params, cache, tokens (B,)) -> (cache, logits (B,V))

``loss`` is ported for every family here: the dense and MoE / MLA decoders
(moonshot-v1-16b-a3b, deepseek-v3-671b: with the MoE load-balancing and MTP
losses), the hybrid and RWKV-6; its backward runs the flash attention (at
d 192 / dv 128 under MLA), SSD-scan and WKV6 backward kernels on the card.

``device`` defaults to ``cuda``; with no card the build raises unless the
caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import hybrid, nn, rwkv_model, transformer
from repro_torch.models.transformer import ModelOpts


def resolve_device(device) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the port's plain CPU path")
    return dev


@dataclass(frozen=True)
class Family:
    """One family's functions: its parameter module (whose forward is the
    loss) and serving steps."""
    module: type                  # module(cfg, device, dtype), with reset_parameters(gen)
    init_cache: Callable          # (cfg, batch, max_len, *, device, dtype) -> cache
    prefill: Callable             # (params, cache, tokens, cfg, opts) -> (cache, logits)
    decode_step: Callable         # (params, cache, tokens, cfg, opts) -> (cache, logits)
    # opts is the Model's ModelOpts; of the serving steps only the decoder's
    # MoE layers read it (moe_token_chunk).


DECODER = Family(transformer.Decoder, transformer.decoder_init_cache,
                 transformer.decoder_prefill, transformer.decoder_decode_step)
HYBRID = Family(hybrid.Hybrid, hybrid.hybrid_init_cache,
                hybrid.hybrid_prefill, hybrid.hybrid_decode_step)
RWKV = Family(rwkv_model.RWKV, rwkv_model.rwkv_init_cache,
              rwkv_model.rwkv_prefill, rwkv_model.rwkv_decode_step)

_LATER = (("enc_layers", "encoder-decoder: ROADMAP A18"),)


def family_of(cfg: ModelConfig) -> Family:
    """The family that serves ``cfg``; raises for the ones still to port."""
    for flag, item in _LATER:
        if getattr(cfg, flag):
            raise NotImplementedError(f"{cfg.name}: not ported yet ({item})")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: not ported yet ({cfg.frontend} "
                                  f"frontend: ROADMAP A18)")
    if cfg.family == "hybrid":
        return HYBRID
    if cfg.family == "ssm" and cfg.rwkv:
        return RWKV
    if cfg.family in ("dense", "moe"):
        return DECODER
    raise NotImplementedError(f"{cfg.name}: not ported yet (family {cfg.family!r}: "
                              f"ROADMAP A18)")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    seed: int = 0
    opts: ModelOpts = ModelOpts()

    @property
    def family(self) -> Family:
        return family_of(self.cfg)

    def init(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        params = self.family.module(self.cfg, self.device, self.dtype)
        params.reset_parameters(gen)
        return params.eval()

    def load(self, state: dict[str, torch.Tensor]):
        """Weights from a state dict (see ``repro_torch.convert``); every key
        must be present and match in shape and in the dtype the module
        declares for it (the model dtype, or f32 for the leaves the reference
        keeps in f32)."""
        params = self.family.module(self.cfg, self.device, self.dtype)
        want = params.state_dict()
        for name, t in state.items():
            if name in want and t.dtype != want[name].dtype:
                raise ValueError(f"{name}: dtype {t.dtype}, module declares "
                                 f"{want[name].dtype}")
        params.load_state_dict(state, strict=True)
        return params.eval()

    def loss(self, params, batch: dict):
        """(scalar loss, metrics) of a batch {"tokens": (B, S)}; differentiable.
        Called through the module (its ``forward``), so hooks on it run."""
        return params(batch, self.opts)

    def input_specs(self, shape: ShapeConfig) -> dict:
        """Allocation-free stand-ins (tensors on the ``meta`` device) for every
        model input of a (shape x step-kind) cell; tokens are int64."""
        B, S = shape.global_batch, shape.seq_len
        dims = (B,) if shape.kind == "decode" else (B, S)
        return {"tokens": torch.empty(dims, dtype=torch.long, device="meta")}

    def dummy_batch(self, shape: ShapeConfig, gen: torch.Generator | None = None) -> dict:
        """A batch of random token ids in [0, vocab) on the model's device,
        from ``gen`` (seed 0 when not given)."""
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        return {k: torch.randint(0, self.cfg.vocab_size, spec.shape, generator=gen,
                                 device=self.device, dtype=spec.dtype)
                for k, spec in self.input_specs(shape).items()}

    def init_cache(self, batch: int, max_len: int) -> dict:
        return self.family.init_cache(self.cfg, batch, max_len, device=self.device,
                                      dtype=self.dtype)

    @torch.no_grad()
    def prefill(self, params, cache: dict, tokens: torch.Tensor):
        return self.family.prefill(params, cache, tokens, self.cfg, self.opts)

    @torch.no_grad()
    def decode_step(self, params, cache: dict, tokens: torch.Tensor):
        return self.family.decode_step(params, cache, tokens, self.cfg, self.opts)


def build(cfg: ModelConfig, device=None, dtype=None, seed: int = 0,
          opts: ModelOpts | None = None) -> Model:
    family_of(cfg)
    dtype = nn.dtype_of(cfg.dtype) if dtype is None else dtype
    return Model(cfg, resolve_device(device), dtype, seed, opts or ModelOpts())
