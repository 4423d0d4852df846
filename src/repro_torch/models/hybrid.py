"""Zamba2-style hybrid: the torch twin of ``repro.models.hybrid`` for training
(forward + loss) and serving (prefill + decode).

A Mamba-2 backbone with one parameter-SHARED attention + MLP block, applied
after SSM layer i when ``i % attn_every == attn_every - 1``.  Each of those
``n_layers // attn_every`` application points has its own KV-cache slot,
though the weights are shared.  The reference scans the backbone and
branches with ``lax.cond``; the port loops over an ``nn.ModuleList``.

The cache is ``{"pos": int, "ssm": {"conv": (L,B,K-1,C), "ssm": (L,B,H,P,N)
f32}, "attn": {"k": (n_app,B,S,Hkv,hd), "v": ...}}``, allocated once by
:func:`hybrid_init_cache` and written IN PLACE by prefill and decode.
"""

from __future__ import annotations

import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, nn
from repro_torch.models.attention import attention
from repro_torch.models.transformer import (Block, ModelOpts, attn_decode, block_apply, qkv,
                                            ring_write)


def n_shared_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def _applies_shared(cfg: ModelConfig, i: int) -> bool:
    return i % cfg.attn_every == cfg.attn_every - 1


class SSMLayer(tnn.Module):
    """Pre-norm residual Mamba-2 layer: ln (D,), mixer."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.ln = nn.param(cfg.d_model, device=device, dtype=dtype)
        self.mixer = mamba2.Mamba2(cfg, device, dtype)


class Hybrid(tnn.Module):
    """emb (V, D), ln_f (D,), head (D, V), ssm_layers[0..L), shared (one
    attention + MLP block)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.emb = nn.param(cfg.vocab_size, cfg.d_model, device=device, dtype=dtype)
        self.ln_f = nn.param(cfg.d_model, device=device, dtype=dtype)
        self.head = nn.param(cfg.d_model, cfg.vocab_size, device=device, dtype=dtype)
        self.ssm_layers = tnn.ModuleList(SSMLayer(cfg, device, dtype)
                                         for _ in range(cfg.n_layers))
        self.shared = Block(cfg, device, dtype)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.embed_init_(self.emb, gen)
        self.ln_f.zero_()
        nn.dense_init_(self.head, gen)
        for layer in self.ssm_layers:
            layer.ln.zero_()
            layer.mixer.reset_parameters(gen)
        self.shared.reset_parameters(gen)


def _layer_apply(lp: SSMLayer, shared: Block, x, cfg: ModelConfig, positions,
                 with_shared: bool):
    """One SSM layer over a full sequence, then the shared block where it
    applies: the unit the reference checkpoints under ``remat="full"``."""
    x = x + mamba2.mamba2_apply(lp.mixer, nn.rmsnorm(x, lp.ln, cfg.norm_eps), cfg)
    return block_apply(shared, x, cfg, positions) if with_shared else x


def hybrid_forward(params: Hybrid, batch: dict, cfg: ModelConfig, opts: ModelOpts):
    """Hidden states (B, S, D) after the final norm.  Under ``remat="full"``
    each SSM layer with its shared-block application is recomputed in the
    backward (the reference's ``jax.checkpoint`` of its scanned body), so the
    scan and the attention forward run twice."""
    if opts.remat not in ("none", "full"):
        raise NotImplementedError(f"remat={opts.remat!r}: the port takes 'none' or 'full'")
    x = nn.embed_lookup(params.emb, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i, lp in enumerate(params.ssm_layers):
        args = (lp, params.shared, x, cfg, positions, _applies_shared(cfg, i))
        if opts.remat == "full":
            x = checkpoint(_layer_apply, *args, use_reentrant=False)
        else:
            x = _layer_apply(*args)
    return nn.rmsnorm(x, params.ln_f, cfg.norm_eps)


def hybrid_loss(params: Hybrid, batch: dict, cfg: ModelConfig, opts: ModelOpts):
    """Next-token CE, as ``transformer.decoder_loss``.  Returns (loss, {"ce"})."""
    tokens = batch["tokens"]
    h = hybrid_forward(params, batch, cfg, opts)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    loss = nn.cross_entropy_loss(lambda hh: hh @ params.head, h, labels, mask,
                                 chunk=opts.loss_chunk)
    return loss, {"ce": loss}


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                      dtype) -> dict:
    shape = (n_shared_apps(cfg), batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"pos": 0,
            "ssm": mamba2.mamba2_init_state(cfg, batch, cfg.n_layers, device=device,
                                            dtype=dtype),
            "attn": {"k": torch.zeros(shape, device=device, dtype=dtype),
                     "v": torch.zeros(shape, device=device, dtype=dtype)}}


def _shared_block_prefill(sp: Block, x, cfg: ModelConfig, k_cache, v_cache):
    """The shared block over a prompt; writes its k, v into one cache slot."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    h = nn.rmsnorm(x, sp.ln1, cfg.norm_eps)
    q, k, v = qkv(sp.attn, h, cfg, positions)
    o = attention(q, k, v, causal=True)
    x = x + o.reshape(B, S, -1) @ sp.attn.wo
    ring_write(k_cache, k, 0)
    ring_write(v_cache, v, 0)
    h = nn.rmsnorm(x, sp.ln2, cfg.norm_eps)
    return x + nn.ffn_apply(sp.mlp.wi, sp.mlp.wo, h, cfg.act)


def _shared_block_decode(sp: Block, x, cfg: ModelConfig, k_cache, v_cache, pos: int):
    h = nn.rmsnorm(x, sp.ln1, cfg.norm_eps)
    x = x + attn_decode(sp.attn, h, cfg, k_cache, v_cache, pos)
    h = nn.rmsnorm(x, sp.ln2, cfg.norm_eps)
    return x + nn.ffn_apply(sp.mlp.wi, sp.mlp.wo, h, cfg.act)


def hybrid_prefill(params: Hybrid, cache: dict, tokens, cfg: ModelConfig):
    """Prefill from a full prompt (B, S): every SSM layer's scan starts from
    zero state, as in the reference.  Returns (cache, logits of the last
    position (B, V))."""
    x = nn.embed_lookup(params.emb, tokens)
    S = x.shape[1]
    conv_c, ssm_c = cache["ssm"]["conv"], cache["ssm"]["ssm"]
    ck, cv = cache["attn"]["k"], cache["attn"]["v"]
    for i, lp in enumerate(params.ssm_layers):
        h = nn.rmsnorm(x, lp.ln, cfg.norm_eps)
        out, st = mamba2.mamba2_apply(lp.mixer, h, cfg, return_state=True)
        x = x + out
        conv_c[i] = st["conv"]
        ssm_c[i] = st["ssm"]
        if _applies_shared(cfg, i):
            app = i // cfg.attn_every
            x = _shared_block_prefill(params.shared, x, cfg, ck[app], cv[app])
    cache["pos"] = S
    h = nn.rmsnorm(x[:, -1], params.ln_f, cfg.norm_eps)
    return cache, h @ params.head


def hybrid_decode_step(params: Hybrid, cache: dict, tokens, cfg: ModelConfig):
    """tokens: (B,) current token ids.  Returns (cache, logits (B,V))."""
    pos = cache["pos"]
    x = nn.embed_lookup(params.emb, tokens[:, None])
    conv_c, ssm_c = cache["ssm"]["conv"], cache["ssm"]["ssm"]
    ck, cv = cache["attn"]["k"], cache["attn"]["v"]
    for i, lp in enumerate(params.ssm_layers):
        h = nn.rmsnorm(x, lp.ln, cfg.norm_eps)
        out, st = mamba2.mamba2_decode_step(lp.mixer, h,
                                            {"conv": conv_c[i], "ssm": ssm_c[i]}, cfg)
        x = x + out
        conv_c[i] = st["conv"]
        ssm_c[i] = st["ssm"]
        if _applies_shared(cfg, i):
            app = i // cfg.attn_every
            x = _shared_block_decode(params.shared, x, cfg, ck[app], cv[app], pos)
    cache["pos"] = pos + 1
    h = nn.rmsnorm(x[:, 0], params.ln_f, cfg.norm_eps)
    return cache, h @ params.head
