"""Attention for the port: the torch twin of ``repro.models.attention``.

``attention`` is the full-sequence (prefill) attention at the public layout
(B,S,H,d).  It dispatches by device through the kernel wrapper: CUDA
tensors run the Hopper flash-attention kernel, CPU tensors its plain tiled
online-softmax version.  ``decode_attention`` (one query token against a
KV cache) is plain torch ops, as it is plain jnp in the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention_fwd

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None) -> torch.Tensor:
    """q: (B,Sq,Hq,d); k, v: (B,Sk,Hkv,d) -> (B,Sq,Hq,d).  Query row i sits
    at key position Sk - Sq + i."""
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
