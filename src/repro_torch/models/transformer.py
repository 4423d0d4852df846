"""Decoder-only transformer LM, dense branch: the torch twin of
``repro.models.transformer`` for training (forward + loss) and serving
(prefill + decode).

Parameters live in ``nn.Module``s with the reference's names and (in, out)
layouts; where the reference stacks layers on a leading axis and scans,
the port keeps an ``nn.ModuleList`` and loops (``repro_torch.convert``
unstacks).  MoE, MLA, MTP and the vision frontend are later slices.

The KV cache is ``{"pos": int, "layers": {"k": (L,B,S,Hkv,hd), "v": ...}}``,
allocated once by :func:`decoder_init_cache` and written IN PLACE by prefill
and decode (the reference donates the cache buffer to its jitted step and
gets a new one back; here the same buffer is updated and returned).
Sliding-window models keep a ring buffer of at most ``window`` slots.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import attention, decode_attention


@dataclass(frozen=True)
class ModelOpts:
    """Runtime knobs (not architecture): the two of the reference's that act
    in the port.  ``remat`` is "none" or "full" (each block's activations are
    recomputed in the backward, by ``torch.utils.checkpoint``);
    ``loss_chunk`` is the sequence chunk of the cross-entropy (0: one piece).
    The reference's ``attn_schedule`` has no twin: the attention kernels
    visit only the tiles of the causal/window band, which is what its
    "triangle" schedule buys.  Its MoE and MTP knobs come with those
    families (ROADMAP A15)."""
    remat: str = "none"              # none | full
    loss_chunk: int = 2048


class Attention(tnn.Module):
    """GQA projections: wq (D, Hq*hd), wk/wv (D, Hkv*hd), wo (Hq*hd, D),
    and bq/bk/bv when ``cfg.qkv_bias``."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        D, hd = cfg.d_model, cfg.resolved_head_dim
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.param(D, Hq * hd, **kw)
        self.wk = nn.param(D, Hkv * hd, **kw)
        self.wv = nn.param(D, Hkv * hd, **kw)
        self.wo = nn.param(Hq * hd, D, **kw)
        if cfg.qkv_bias:
            self.bq = nn.param(Hq * hd, **kw)
            self.bk = nn.param(Hkv * hd, **kw)
            self.bv = nn.param(Hkv * hd, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            nn.dense_init_(w, gen)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()


class FFN(tnn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        in_w = 2 * cfg.d_ff if cfg.act in ("swiglu", "geglu") else cfg.d_ff
        self.wi = nn.param(cfg.d_model, in_w, device=device, dtype=dtype)
        self.wo = nn.param(cfg.d_ff, cfg.d_model, device=device, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.dense_init_(self.wi, gen)
        nn.dense_init_(self.wo, gen)


class Block(tnn.Module):
    """Pre-norm residual block: x + attn(rmsnorm(x)), then x + mlp(rmsnorm(x))."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.ln1 = nn.param(cfg.d_model, device=device, dtype=dtype)
        self.ln2 = nn.param(cfg.d_model, device=device, dtype=dtype)
        self.attn = Attention(cfg, device, dtype)
        self.mlp = FFN(cfg, device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.reset_parameters(gen)
        self.mlp.reset_parameters(gen)


class Decoder(tnn.Module):
    """emb (V, D), ln_f (D,), head (D, V) unless tied, layers[0..L)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.emb = nn.param(cfg.vocab_size, cfg.d_model, device=device, dtype=dtype)
        self.ln_f = nn.param(cfg.d_model, device=device, dtype=dtype)
        if not cfg.tie_embeddings:
            self.head = nn.param(cfg.d_model, cfg.vocab_size, device=device, dtype=dtype)
        self.layers = tnn.ModuleList(Block(cfg, device, dtype)
                                     for _ in range(cfg.n_layers))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.embed_init_(self.emb, gen)
        self.ln_f.zero_()
        if hasattr(self, "head"):
            nn.dense_init_(self.head, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        w = self.emb.T if self.cfg.tie_embeddings else self.head
        return h @ w


# ---------------------------------------------------------------------------
# Attention pieces
# ---------------------------------------------------------------------------

def qkv(p: Attention, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = nn.apply_rope(q.view(B, S, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = nn.apply_rope(k.view(B, S, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    return q, k, v.view(B, S, cfg.n_kv_heads, hd)


def attn_decode(p: Attention, x, cfg: ModelConfig, k_cache, v_cache, length: int):
    """One-token step.  x: (B,1,D); caches (B,Smax,Hkv,hd), written in place.
    Sliding-window models use a ring buffer of size <= window."""
    B = x.shape[0]
    Smax = k_cache.shape[1]
    if not cfg.sliding_window and length >= Smax:
        raise ValueError(f"KV cache full: position {length} >= cache length {Smax}")
    positions = torch.full((B, 1), length, dtype=torch.long, device=x.device)
    q, k, v = qkv(p, x, cfg, positions)
    slot = length % Smax if cfg.sliding_window else length
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    o = decode_attention(q[:, 0], k_cache, v_cache, min(length + 1, Smax))
    return o.reshape(B, 1, -1) @ p.wo


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------

def block_apply(lp: Block, x, cfg: ModelConfig, positions):
    """Pre-norm residual block over a full sequence."""
    B, S, _ = x.shape
    h = nn.rmsnorm(x, lp.ln1, cfg.norm_eps)
    q, k, v = qkv(lp.attn, h, cfg, positions)
    o = attention(q, k, v, causal=True, window=cfg.sliding_window)
    x = x + o.reshape(B, S, -1) @ lp.attn.wo
    h = nn.rmsnorm(x, lp.ln2, cfg.norm_eps)
    return x + nn.ffn_apply(lp.mlp.wi, lp.mlp.wo, h, cfg.act)


def decoder_forward(params: Decoder, batch: dict, cfg: ModelConfig, opts: ModelOpts):
    """Hidden states (B, S, D) after the final norm.  Under ``remat="full"``
    each block is recomputed in the backward (the port's form of the
    reference's ``jax.checkpoint`` around the scanned block), so the
    attention forward runs twice per layer."""
    if opts.remat not in ("none", "full"):
        raise NotImplementedError(f"remat={opts.remat!r}: the port takes 'none' or 'full'")
    x = nn.embed_lookup(params.emb, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params.layers:
        if opts.remat == "full":
            x = checkpoint(block_apply, lp, x, cfg, positions, use_reentrant=False)
        else:
            x = block_apply(lp, x, cfg, positions)
    return nn.rmsnorm(x, params.ln_f, cfg.norm_eps)


def decoder_loss(params: Decoder, batch: dict, cfg: ModelConfig, opts: ModelOpts):
    """Next-token CE: labels are the tokens rolled left by one, the last
    position masked.  Returns (loss, {"ce": loss})."""
    tokens = batch["tokens"]
    h = decoder_forward(params, batch, cfg, opts)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    loss = nn.cross_entropy_loss(params.logits, h, labels, mask, chunk=opts.loss_chunk)
    return loss, {"ce": loss}


# ---------------------------------------------------------------------------
# Cache, prefill, decode
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def decoder_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                       dtype) -> dict:
    S = cache_len(cfg, max_len)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"pos": 0,
            "layers": {"k": torch.zeros(shape, device=device, dtype=dtype),
                       "v": torch.zeros(shape, device=device, dtype=dtype)}}


def ring_write(cache_arr, kv, window: int) -> None:
    """Write full-sequence kv (B,S,...) into cache (B,W,...) in place; with a
    window and S > W, the last W positions land at slot pos % W."""
    S, W = kv.shape[1], cache_arr.shape[1]
    if not window or S <= W:
        if S > W:
            raise ValueError(f"prompt of {S} tokens exceeds the KV cache length {W}")
        cache_arr[:, :S] = kv
        return
    idx = torch.arange(S - W, S, device=kv.device) % W
    cache_arr[:, idx] = kv[:, S - W:]


def decoder_prefill(params: Decoder, cache: dict, tokens, cfg: ModelConfig):
    """Prefill the cache from a full prompt (B, S).  Returns (cache, logits of
    the last position (B, V))."""
    x = nn.embed_lookup(params.emb, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params.layers):
        h = nn.rmsnorm(x, lp.ln1, cfg.norm_eps)
        q, k, v = qkv(lp.attn, h, cfg, positions)
        o = attention(q, k, v, causal=True, window=cfg.sliding_window)
        x = x + o.reshape(B, S, -1) @ lp.attn.wo
        ring_write(ck[i], k, cfg.sliding_window)
        ring_write(cv[i], v, cfg.sliding_window)
        h = nn.rmsnorm(x, lp.ln2, cfg.norm_eps)
        x = x + nn.ffn_apply(lp.mlp.wi, lp.mlp.wo, h, cfg.act)
    cache["pos"] = S
    h = nn.rmsnorm(x[:, -1], params.ln_f, cfg.norm_eps)
    return cache, params.logits(h)


def decoder_decode_step(params: Decoder, cache: dict, tokens, cfg: ModelConfig):
    """tokens: (B,) current token ids.  Returns (cache, logits (B,V))."""
    pos = cache["pos"]
    x = nn.embed_lookup(params.emb, tokens[:, None])
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params.layers):
        h = nn.rmsnorm(x, lp.ln1, cfg.norm_eps)
        x = x + attn_decode(lp.attn, h, cfg, ck[i], cv[i], pos)
        h = nn.rmsnorm(x, lp.ln2, cfg.norm_eps)
        x = x + nn.ffn_apply(lp.mlp.wi, lp.mlp.wo, h, cfg.act)
    cache["pos"] = pos + 1
    h = nn.rmsnorm(x[:, 0], params.ln_f, cfg.norm_eps)
    return cache, params.logits(h)
