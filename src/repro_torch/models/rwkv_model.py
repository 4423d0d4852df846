"""RWKV-6 language model (attention-free): the torch twin of
``repro.models.rwkv_model`` for training (forward + loss) and serving.

The cache is ``{"pos": int, "tm_shift": (L,B,D), "cm_shift": (L,B,D),
"wkv": (L,B,H,hd,hd) f32}``, allocated once by :func:`rwkv_init_cache` and
written IN PLACE by prefill and decode, which both run the same layer pass
over S >= 1 tokens from the cached state.
"""

from __future__ import annotations

import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn, rwkv6
from repro_torch.models.transformer import ModelOpts


class RWKVLayer(tnn.Module):
    """ln1_g/b, ln2_g/b (D,) f32; tm (time mix), cm (channel mix)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        self.ln1_g = nn.param(cfg.d_model, **f32)
        self.ln1_b = nn.param(cfg.d_model, **f32)
        self.ln2_g = nn.param(cfg.d_model, **f32)
        self.ln2_b = nn.param(cfg.d_model, **f32)
        self.tm = rwkv6.TimeMix(cfg, device, dtype)
        self.cm = rwkv6.ChannelMix(cfg, device, dtype)


class RWKV(tnn.Module):
    """emb (V, D), ln0_g/b and ln_f_g/b (D,) f32, head (D, V), layers[0..L)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        f32 = dict(device=device, dtype=torch.float32)
        self.emb = nn.param(cfg.vocab_size, D, device=device, dtype=dtype)
        self.ln0_g = nn.param(D, **f32)
        self.ln0_b = nn.param(D, **f32)
        self.layers = tnn.ModuleList(RWKVLayer(cfg, device, dtype)
                                     for _ in range(cfg.n_layers))
        self.ln_f_g = nn.param(D, **f32)
        self.ln_f_b = nn.param(D, **f32)
        self.head = nn.param(D, cfg.vocab_size, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.embed_init_(self.emb, gen)
        for g, b in [(self.ln0_g, self.ln0_b), (self.ln_f_g, self.ln_f_b)] + \
                [(lp.ln1_g, lp.ln1_b) for lp in self.layers] + \
                [(lp.ln2_g, lp.ln2_b) for lp in self.layers]:
            g.fill_(1.0)
            b.zero_()
        for lp in self.layers:
            lp.tm.reset_parameters(gen)
            lp.cm.reset_parameters(gen)
        nn.dense_init_(self.head, gen)


def rwkv_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                    dtype) -> dict:
    """The recurrent state; its size does not depend on ``max_len``."""
    L, D = cfg.n_layers, cfg.d_model
    H, hd = rwkv6.n_heads(cfg), cfg.rwkv_head_dim
    return {"pos": 0,
            "tm_shift": torch.zeros((L, batch, D), device=device, dtype=dtype),
            "cm_shift": torch.zeros((L, batch, D), device=device, dtype=dtype),
            "wkv": torch.zeros((L, batch, H, hd, hd), device=device, dtype=torch.float32)}


def _layer(lp: RWKVLayer, x, cfg: ModelConfig, state: dict):
    """One RWKV block from its per-layer state; returns (x, new state)."""
    h = nn.layernorm(x, lp.ln1_g, lp.ln1_b, cfg.norm_eps)
    y, tm_shift, wkv = rwkv6.time_mix(lp.tm, h, cfg, shift_last=state["tm_shift"],
                                      wkv_state=state["wkv"])
    x = x + y
    h = nn.layernorm(x, lp.ln2_g, lp.ln2_b, cfg.norm_eps)
    y, cm_shift = rwkv6.channel_mix(lp.cm, h, shift_last=state["cm_shift"])
    return x + y, {"tm_shift": tm_shift, "cm_shift": cm_shift, "wkv": wkv}


def _layer_train(lp: RWKVLayer, x, cfg: ModelConfig):
    """One RWKV block over a full sequence from zero state (training)."""
    return _layer(lp, x, cfg, {"tm_shift": None, "cm_shift": None, "wkv": None})[0]


def rwkv_forward(params: RWKV, batch: dict, cfg: ModelConfig, opts: ModelOpts):
    """Hidden states (B, S, D) after the final norm.  Under ``remat="full"``
    each block is recomputed in the backward (the reference's
    ``jax.checkpoint`` of its scanned body), so the WKV forward runs twice."""
    if opts.remat not in ("none", "full"):
        raise NotImplementedError(f"remat={opts.remat!r}: the port takes 'none' or 'full'")
    x = nn.layernorm(nn.embed_lookup(params.emb, batch["tokens"]), params.ln0_g,
                     params.ln0_b, cfg.norm_eps)
    for lp in params.layers:
        if opts.remat == "full":
            x = checkpoint(_layer_train, lp, x, cfg, use_reentrant=False)
        else:
            x = _layer_train(lp, x, cfg)
    return nn.layernorm(x, params.ln_f_g, params.ln_f_b, cfg.norm_eps)


def rwkv_loss(params: RWKV, batch: dict, cfg: ModelConfig, opts: ModelOpts):
    """Next-token CE, as ``transformer.decoder_loss``.  Returns (loss, {"ce"})."""
    tokens = batch["tokens"]
    h = rwkv_forward(params, batch, cfg, opts)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    loss = nn.cross_entropy_loss(lambda hh: hh @ params.head, h, labels, mask,
                                 chunk=opts.loss_chunk)
    return loss, {"ce": loss}


def _stack_pass(params: RWKV, cache: dict, x, cfg: ModelConfig):
    """Every layer over S >= 1 tokens, threading and updating the cache's
    per-layer state in place."""
    for i, lp in enumerate(params.layers):
        st = {name: cache[name][i] for name in ("tm_shift", "cm_shift", "wkv")}
        x, new = _layer(lp, x, cfg, st)
        for name, t in new.items():
            cache[name][i] = t
    return x


def rwkv_prefill(params: RWKV, cache: dict, tokens, cfg: ModelConfig):
    """Prefill from a prompt (B, S).  Returns (cache, logits (B, V))."""
    x = nn.layernorm(nn.embed_lookup(params.emb, tokens), params.ln0_g, params.ln0_b,
                     cfg.norm_eps)
    x = _stack_pass(params, cache, x, cfg)
    cache["pos"] = tokens.shape[1]
    h = nn.layernorm(x[:, -1], params.ln_f_g, params.ln_f_b, cfg.norm_eps)
    return cache, h @ params.head


def rwkv_decode_step(params: RWKV, cache: dict, tokens, cfg: ModelConfig):
    """tokens: (B,) current token ids.  Returns (cache, logits (B, V))."""
    x = nn.layernorm(nn.embed_lookup(params.emb, tokens[:, None]), params.ln0_g,
                     params.ln0_b, cfg.norm_eps)
    x = _stack_pass(params, cache, x, cfg)
    cache["pos"] += 1
    h = nn.layernorm(x[:, 0], params.ln_f_g, params.ln_f_b, cfg.norm_eps)
    return cache, h @ params.head
