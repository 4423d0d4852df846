"""Attention for the port: the torch twin of ``repro.models.attention``.

``attention`` is the full-sequence (prefill and training) attention at the
public layout (B,S,H,d).  It dispatches by device through the kernel
wrappers: CUDA tensors run the Hopper flash-attention kernels, CPU tensors
their plain tiled versions.  With grad enabled and an input that requires
grad it goes through :class:`FlashAttention`, whose backward is the
backward kernel; otherwise (serving, under ``torch.no_grad()``) it calls
the forward alone.  ``decode_attention`` (one query token against a
KV cache) is plain torch ops, as it is plain jnp in the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import FlashAttention, flash_attention_fwd

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None) -> torch.Tensor:
    """q: (B,Sq,Hq,d); k, v: (B,Sk,Hkv,d) -> (B,Sq,Hq,d).  Query row i sits
    at key position Sk - Sq + i."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    o, _ = flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale)
    return o


def decode_attention(q, k_cache, v_cache, length: int, *, scale: float | None = None):
    """Single-token attention against a KV cache.

    q: (B, Hq, d); caches: (B, S, Hkv, d); ``length``: count of valid slots
    (a sliding-window ring cache passes min(pos + 1, S): every filled slot is
    valid).  Returns (B, Hq, d)."""
    B, Hq, d = q.shape
    _, S, Hkv, _ = k_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, Hq // Hkv, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    valid = torch.arange(S, device=q.device) < length
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, Hq, d).to(q.dtype)
