"""Multi-head latent attention (DeepSeek-V3, arXiv:2412.19437): the torch
twin of ``repro.models.mla``.

Queries pass through a rank-``q_lora_rank`` bottleneck; keys and values
through a rank-``kv_lora_rank`` latent ``c_kv`` plus one rope key ``k_pe``
shared by the heads.  Prefill decompresses the latent to per-head K (nope
and rope, 192 wide in DeepSeek-V3) and V (128 wide) and calls the port's
``attention``, which on the card is the flash forward kernel at
d 192 / dv 128, with its backward kernel at the same pair in training.  v is
a strided view of the decompressed (B,S,H,dn+dv) buffer, handed to the
kernels as it is: at DeepSeek-V3's widths it meets the bf16 kernels' rule
(16-byte-aligned data, strides in multiples of 8 elements), and a width that
did not would raise there, naming the tensor, rather than be copied.  Decode
caches only (c_kv, k_pe) and scores in latent space with the absorbed
weights W_uk / W_uv, in f32 as the reference does.
"""

from __future__ import annotations

import math

import torch
from torch import nn as tnn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import attention


class MLA(tnn.Module):
    """q_a (D, qr), q_norm (qr,), q_b (qr, H*(dn+dr)), kv_a (D, kvr+dr),
    kv_norm (kvr,), kv_b (kvr, H*(dn+dv)), wo (H*dv, D)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dvh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        kw = dict(device=device, dtype=dtype)
        self.q_a = nn.param(D, qr, **kw)
        self.q_norm = nn.param(qr, **kw)
        self.q_b = nn.param(qr, H * (dn + dr), **kw)
        self.kv_a = nn.param(D, kvr + dr, **kw)
        self.kv_norm = nn.param(kvr, **kw)
        self.kv_b = nn.param(kvr, H * (dn + dvh), **kw)
        self.wo = nn.param(H * dvh, D, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.q_a, self.q_b, self.kv_a, self.kv_b, self.wo):
            nn.dense_init_(w, gen)
        self.q_norm.zero_()
        self.kv_norm.zero_()


def project_q(p: MLA, x, cfg: ModelConfig, positions):
    """(q_nope (B,S,H,dn), q_pe (B,S,H,dr)), q_pe rotated."""
    B, S, _ = x.shape
    dn = cfg.qk_nope_dim
    q = nn.rmsnorm(x @ p.q_a, p.q_norm, cfg.norm_eps) @ p.q_b
    q = q.view(B, S, cfg.n_heads, dn + cfg.qk_rope_dim)
    return q[..., :dn], nn.apply_rope(q[..., dn:], positions, cfg.rope_theta)


def compress_kv(p: MLA, x, cfg: ModelConfig, positions):
    """The decode-cacheable latents: c_kv (B,S,kvr) and k_pe (B,S,dr), the
    rope key rotated through a dummy head axis as in the reference."""
    kvr = cfg.kv_lora_rank
    ckv = x @ p.kv_a
    c_kv = nn.rmsnorm(ckv[..., :kvr], p.kv_norm, cfg.norm_eps)
    k_pe = nn.apply_rope(ckv[..., kvr:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def mla_prefill(p: MLA, x, cfg: ModelConfig, positions):
    """Full-sequence MLA.  x: (B,S,D) -> (out (B,S,D), c_kv, k_pe): the
    attention output and the latents a prefill writes into the cache."""
    B, S, _ = x.shape
    H, dn, dr, dvh = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_pe = project_q(p, x, cfg, positions)
    c_kv, k_pe = compress_kv(p, x, cfg, positions)
    kv = (c_kv @ p.kv_b).view(B, S, H, dn + dvh)
    k = torch.cat([kv[..., :dn], k_pe[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    o = attention(q, k, kv[..., dn:], causal=True, scale=1.0 / math.sqrt(dn + dr))
    return o.reshape(B, S, H * dvh) @ p.wo, c_kv, k_pe


def mla_attention(p: MLA, x, cfg: ModelConfig, positions):
    """Full-sequence (prefill) MLA.  x: (B,S,D) -> (B,S,D)."""
    return mla_prefill(p, x, cfg, positions)[0]


def mla_decode(p: MLA, x, cfg: ModelConfig, c_cache, pe_cache, length: int):
    """Absorbed decode step.  x: (B,1,D); caches (B,Smax,kvr) / (B,Smax,dr),
    written in place at ``length`` (a full cache raises).  Returns (B,1,D).

    score_h = q_nope_h . (W_uk_h c) + q_pe_h . k_pe over the cached latents,
    and the latent output re-expanded through W_uv, in f32."""
    B = x.shape[0]
    Smax = c_cache.shape[1]
    if length >= Smax:
        raise ValueError(f"MLA cache full: position {length} >= cache length {Smax}")
    H, dn, dr, dvh = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    positions = torch.full((B, 1), length, dtype=torch.long, device=x.device)
    q_nope, q_pe = project_q(p, x, cfg, positions)
    c_kv, k_pe = compress_kv(p, x, cfg, positions)
    c_cache[:, length] = c_kv[:, 0]
    pe_cache[:, length] = k_pe[:, 0]

    w_kv = p.kv_b.view(kvr, H, dn + dvh)
    w_uk, w_uv = w_kv[..., :dn], w_kv[..., dn:]
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0], w_uk)
    cf = c_cache.float()
    s = torch.einsum("bhc,bsc->bhs", q_lat.float(), cf)
    s = s + torch.einsum("bhd,bsd->bhs", q_pe[:, 0].float(), pe_cache.float())
    s = s / math.sqrt(dn + dr)
    valid = torch.arange(Smax, device=x.device) <= length
    s = s.masked_fill(~valid, -1e30)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhc,chv->bhv", torch.einsum("bhs,bsc->bhc", pr, cf), w_uv.float())
    return o.reshape(B, 1, H * dvh).to(x.dtype) @ p.wo
