"""Encoder-decoder transformer (the SeamlessM4T backbone): the torch twin of
``repro.models.encdec``, for serving.

The speech frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_frames, D), projects them by
``frame_proj``, adds the learned ``enc_pos`` and runs bidirectional
self-attention blocks (RoPE on the frame positions).  Each decoder block
runs causal self-attention (RoPE), cross-attention to the encoder output
(non-causal, no RoPE: queries at the prompt's length against keys at the
frames') and the FFN.  Every full-sequence attention, the encoder's, the
decoder's self and its cross, goes through ``models.attention.attention``:
on the card the flash forward kernel, non-causal for the encoder and the
cross-attention.

The cache is ``{"pos": int, "self_k"/"self_v": (L,B,max_len,Hkv,hd),
"cross_k"/"cross_v": (L,B,n_frames,Hkv,hd)}``, allocated once by
:func:`encdec_init_cache`; prefill writes both in place (the cross K/V
once, from the encoder output), decode appends to the self cache and reads
the cross cache whole.  The reference's decode takes the cross cache's full
width as its valid length while its encoder takes any frame count, so with
fewer frames than ``n_frames`` its decode attends to zero slots its prefill
never saw (ROADMAP Quirks); the port serves exactly ``n_frames`` frames,
where the two agree, and raises on any other count.

Training (the loss and the flash backward on this path) is ROADMAP A18b:
``EncDec.forward`` raises.
"""

from __future__ import annotations

import torch
from torch import nn as tnn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.transformer import FFN, Attention, attn_decode, qkv, ring_write


class EncBlock(tnn.Module):
    """Encoder block: x + attn(rmsnorm(x)) bidirectional, then x + mlp(rmsnorm(x))."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.ln1 = nn.param(cfg.d_model, device=device, dtype=dtype)
        self.attn = Attention(cfg, device, dtype)
        self.ln2 = nn.param(cfg.d_model, device=device, dtype=dtype)
        self.mlp = FFN(cfg, device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.reset_parameters(gen)
        self.mlp.reset_parameters(gen)


class DecBlock(EncBlock):
    """Decoder block: causal self-attention, cross-attention (``lnx``,
    ``xattn``) to the encoder output, then the FFN."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(cfg, device, dtype)
        self.lnx = nn.param(cfg.d_model, device=device, dtype=dtype)
        self.xattn = Attention(cfg, device, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        super().reset_parameters(gen)
        self.lnx.zero_()
        self.xattn.reset_parameters(gen)


class EncDec(tnn.Module):
    """The parameters of the reference's ``encdec_init``: emb (V, D),
    frame_proj (D, D), enc_pos (n_frames, D), enc_layers[0..E), enc_ln_f,
    dec_layers[0..L), ln_f and head (D, V)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.emb = nn.param(cfg.vocab_size, D, **kw)
        self.frame_proj = nn.param(D, D, **kw)
        self.enc_pos = nn.param(cfg.n_frames, D, **kw)
        self.enc_layers = tnn.ModuleList(EncBlock(cfg, device, dtype)
                                         for _ in range(cfg.enc_layers))
        self.enc_ln_f = nn.param(D, **kw)
        self.dec_layers = tnn.ModuleList(DecBlock(cfg, device, dtype)
                                         for _ in range(cfg.n_layers))
        self.ln_f = nn.param(D, **kw)
        self.head = nn.param(D, cfg.vocab_size, **kw)

    def forward(self, batch: dict, opts=None):
        raise NotImplementedError(f"{self.cfg.name}: the encoder-decoder's loss is not "
                                  f"ported yet (ROADMAP A18b)")

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.embed_init_(self.emb, gen)
        nn.dense_init_(self.frame_proj, gen)
        nn.normal_(self.enc_pos, 0.02, gen)
        for lp in (*self.enc_layers, *self.dec_layers):
            lp.reset_parameters(gen)
        self.enc_ln_f.zero_()
        self.ln_f.zero_()
        nn.dense_init_(self.head, gen)


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, F, D) precomputed embeddings -> (B, F, D), every block's
    self-attention bidirectional."""
    x = frames.to(params.frame_proj.dtype) @ params.frame_proj
    B, F, _ = x.shape
    x = x + params.enc_pos[:F]
    positions = torch.arange(F, device=x.device)[None, :]
    for lp in params.enc_layers:
        q, k, v = qkv(lp.attn, nn.rmsnorm(x, lp.ln1, cfg.norm_eps), cfg, positions)
        o = attention(q, k, v, causal=False, window=cfg.sliding_window)
        x = x + o.reshape(B, F, -1) @ lp.attn.wo
        x = x + nn.ffn_apply(lp.mlp.wi, lp.mlp.wo, nn.rmsnorm(x, lp.ln2, cfg.norm_eps), cfg.act)
    return nn.rmsnorm(x, params.enc_ln_f, cfg.norm_eps)


def cross_kv(xattn: Attention, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K, V from the encoder output: (B, F, Hkv, hd) each."""
    B, F, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    return ((enc_out @ xattn.wk).view(B, F, -1, hd),
            (enc_out @ xattn.wv).view(B, F, -1, hd))


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                      dtype) -> dict:
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(S):
        return torch.zeros((L, batch, S, Hkv, hd), device=device, dtype=dtype)

    return {"pos": 0, "self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(cfg.n_frames), "cross_v": zeros(cfg.n_frames)}


def encdec_prefill(params: EncDec, cache: dict, batch: dict, cfg: ModelConfig, opts=None):
    """Encode ``batch["frames"]`` (B, n_frames, D), write the cross K/V of
    every decoder layer, and prefill the self cache from ``batch["tokens"]``
    (B, S).  Returns (cache, logits of the last position (B, V))."""
    frames = batch["frames"]
    if frames.shape[1] != cfg.n_frames:
        raise ValueError(f"{cfg.name}: {frames.shape[1]} frames; the port serves exactly "
                         f"n_frames = {cfg.n_frames} (the reference's decode reads the "
                         f"whole cross cache, so with fewer frames it attends to unwritten "
                         f"slots: ROADMAP Quirks)")
    enc_out = encode(params, frames, cfg)
    x = nn.embed_lookup(params.emb, batch["tokens"])
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(S, device=x.device)[None, :]
    for i, lp in enumerate(params.dec_layers):
        q, k, v = qkv(lp.attn, nn.rmsnorm(x, lp.ln1, cfg.norm_eps), cfg, positions)
        x = x + attention(q, k, v, causal=True).reshape(B, S, -1) @ lp.attn.wo
        ring_write(cache["self_k"][i], k, 0)
        ring_write(cache["self_v"][i], v, 0)
        kx, vx = cross_kv(lp.xattn, enc_out, cfg)
        qx = (nn.rmsnorm(x, lp.lnx, cfg.norm_eps) @ lp.xattn.wq).view(B, S, -1, hd)
        x = x + attention(qx, kx, vx, causal=False).reshape(B, S, -1) @ lp.xattn.wo
        cache["cross_k"][i].copy_(kx)
        cache["cross_v"][i].copy_(vx)
        x = x + nn.ffn_apply(lp.mlp.wi, lp.mlp.wo, nn.rmsnorm(x, lp.ln2, cfg.norm_eps), cfg.act)
    cache["pos"] = S
    return cache, nn.rmsnorm(x[:, -1], params.ln_f, cfg.norm_eps) @ params.head


def encdec_decode_step(params: EncDec, cache: dict, tokens, cfg: ModelConfig, opts=None):
    """tokens: (B,) current token ids.  Returns (cache, logits (B, V))."""
    pos = cache["pos"]
    x = nn.embed_lookup(params.emb, tokens[:, None])
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    F = cache["cross_k"].shape[2]
    for i, lp in enumerate(params.dec_layers):
        h = nn.rmsnorm(x, lp.ln1, cfg.norm_eps)
        x = x + attn_decode(lp.attn, h, cfg, cache["self_k"][i], cache["self_v"][i], pos)
        qx = (nn.rmsnorm(x, lp.lnx, cfg.norm_eps)[:, 0] @ lp.xattn.wq).view(B, -1, hd)
        o = decode_attention(qx, cache["cross_k"][i], cache["cross_v"][i], F)
        x = x + o.reshape(B, 1, -1) @ lp.xattn.wo
        x = x + nn.ffn_apply(lp.mlp.wi, lp.mlp.wo, nn.rmsnorm(x, lp.ln2, cfg.norm_eps), cfg.act)
    cache["pos"] = pos + 1
    return cache, nn.rmsnorm(x[:, 0], params.ln_f, cfg.norm_eps) @ params.head
