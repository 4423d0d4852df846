"""Model API for the port: ``build(cfg, device=None, dtype=None, seed=0,
opts=None)``.

The torch twin of ``repro.models.api``, dispatched by family as the
reference dispatches (dense, MoE / MLA and vision decoders, hybrid Mamba-2 +
shared attention, RWKV-6, the encoder-decoder):

    init() -> params (an nn.Module, weights drawn on ``device`` from ``seed``)
    load(state) -> params (weights from ``repro_torch.convert``)
    loss(params, batch {"tokens": (B,S)}) -> (scalar, metrics)   [train step]
    init_cache(batch, max_len) -> cache
    prefill(params, cache, batch) -> (cache, logits (B,V))
    decode_step(params, cache, tokens (B,)) -> (cache, logits (B,V))

``prefill`` takes the reference's batch dict, {"tokens": (B,S)} plus the
modality stub of ``input_specs``: "frames" (B, n_frames, D) for the
encoder-decoder (seamless-m4t-large-v2), "patches" (B, n_patches, D) for the
vision decoder (phi-3-vision-4.2b, whose prompt may also be text alone, as
in the reference); a bare token tensor means {"tokens": tokens}.

``loss`` is ported for the dense and MoE / MLA decoders (moonshot-v1-16b-a3b,
deepseek-v3-671b: with the MoE load-balancing and MTP losses), the hybrid
and RWKV-6; its backward runs the flash attention (at d 192 / dv 128 under
MLA), SSD-scan and WKV6 backward kernels on the card.  The encoder-decoder's
and the vision decoder's losses are ROADMAP A18b: ``loss`` raises for them
before any forward.

``device`` defaults to ``cuda``; with no card the build raises unless the
caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, nn, rwkv_model, transformer
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
    prefill: Callable             # (params, cache, batch, cfg, opts) -> (cache, logits)
    decode_step: Callable         # (params, cache, tokens, cfg, opts) -> (cache, logits)
    # opts is the Model's ModelOpts; of the serving steps only the decoder's
    # MoE layers read it (moe_token_chunk).


def _tokens_only(prefill: Callable) -> Callable:
    """A prefill of token ids, called with the batch dict."""
    return lambda params, cache, batch, cfg, opts: prefill(params, cache, batch["tokens"],
                                                          cfg, opts)


DECODER = Family(transformer.Decoder, transformer.decoder_init_cache,
                 transformer.decoder_prefill, transformer.decoder_decode_step)
HYBRID = Family(hybrid.Hybrid, hybrid.hybrid_init_cache,
                _tokens_only(hybrid.hybrid_prefill), hybrid.hybrid_decode_step)
RWKV = Family(rwkv_model.RWKV, rwkv_model.rwkv_init_cache,
              _tokens_only(rwkv_model.rwkv_prefill), rwkv_model.rwkv_decode_step)
ENCDEC = Family(encdec.EncDec, encdec.encdec_init_cache,
                encdec.encdec_prefill, encdec.encdec_decode_step)


def family_of(cfg: ModelConfig) -> Family:
    """The family that serves ``cfg``; raises for a combination the
    reference does not build either."""
    if cfg.is_encdec:
        return ENCDEC
    if cfg.frontend not in ("none", "vision"):
        raise NotImplementedError(f"{cfg.name}: a {cfg.frontend} frontend without an "
                                  f"encoder is not in the reference")
    if cfg.family == "hybrid":
        return HYBRID
    if cfg.family == "ssm" and cfg.rwkv:
        return RWKV
    if cfg.family in ("dense", "moe", "vlm"):
        return DECODER
    raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not in the reference")


def stub_key(cfg: ModelConfig) -> str | None:
    """The batch key of the config's modality stub: "frames" for the
    encoder-decoder, "patches" for the vision frontend, None without one."""
    if cfg.is_encdec:
        return "frames"
    return "patches" if cfg.frontend == "vision" else None


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
        Called through the module (its ``forward``), so hooks on it run.
        The encoder-decoder's and the vision decoder's modules raise before
        any forward: their losses are ROADMAP A18b."""
        return params(batch, self.opts)

    def input_specs(self, shape: ShapeConfig) -> dict:
        """Allocation-free stand-ins (tensors on the ``meta`` device) for every
        model input of a (shape x step-kind) cell; tokens are int64, the
        modality stub f32: "frames" (B, n_frames, D), or "patches" (B,
        n_patches, D) with S - n_patches tokens (S counts the patches)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def meta(*dims, dtype=torch.long):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return {"tokens": meta(B)}
        key = stub_key(cfg)
        if key == "patches":
            return {"tokens": meta(B, S - cfg.n_patches),
                    "patches": meta(B, cfg.n_patches, cfg.d_model, dtype=torch.float32)}
        specs = {"tokens": meta(B, S)}
        if key == "frames":
            specs["frames"] = meta(B, cfg.n_frames, cfg.d_model, dtype=torch.float32)
        return specs

    def dummy_batch(self, shape: ShapeConfig, gen: torch.Generator | None = None) -> dict:
        """A batch on the model's device from ``gen`` (seed 0 when not given):
        random token ids in [0, vocab), and the modality stub as f32
        normals x 0.02, as the reference's ``dummy_batch``."""
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        out = {}
        for k, spec in self.input_specs(shape).items():
            if spec.dtype == torch.long:
                out[k] = torch.randint(0, self.cfg.vocab_size, spec.shape, generator=gen,
                                       device=self.device, dtype=spec.dtype)
            else:
                out[k] = torch.randn(spec.shape, generator=gen, device=self.device,
                                     dtype=spec.dtype) * 0.02
        return out

    def init_cache(self, batch: int, max_len: int) -> dict:
        return self.family.init_cache(self.cfg, batch, max_len, device=self.device,
                                      dtype=self.dtype)

    @torch.no_grad()
    def prefill(self, params, cache: dict, batch):
        """Prefill from ``batch``: {"tokens": (B, S)} and the config's
        modality stub, or a bare token tensor.  A key the config does not
        take raises, and so does an encoder-decoder batch without frames."""
        if isinstance(batch, torch.Tensor):
            batch = {"tokens": batch}
        key = stub_key(self.cfg)
        extra = sorted(set(batch) - {"tokens", key})
        if extra or (key == "frames" and key not in batch):
            raise ValueError(f"{self.cfg.name}: batch keys {sorted(batch)}; it takes "
                             f"'tokens'" + (f" and '{key}'" if key else ""))
        return self.family.prefill(params, cache, batch, self.cfg, self.opts)

    @torch.no_grad()
    def decode_step(self, params, cache: dict, tokens: torch.Tensor):
        return self.family.decode_step(params, cache, tokens, self.cfg, self.opts)


def build(cfg: ModelConfig, device=None, dtype=None, seed: int = 0,
          opts: ModelOpts | None = None) -> Model:
    family_of(cfg)
    dtype = nn.dtype_of(cfg.dtype) if dtype is None else dtype
    return Model(cfg, resolve_device(device), dtype, seed, opts or ModelOpts())
