"""Attention for the port: the torch twin of ``repro.models.attention``.

``attention`` is the full-sequence (prefill and training) attention at the
public layout (B,S,H,d).  It dispatches by device through the kernel
wrappers: CUDA tensors run the Hopper flash-attention kernels, CPU tensors
their plain tiled versions.  With grad enabled and an input that requires
grad it goes through :class:`FlashAttention`, whose backward is the
backward kernel; otherwise (serving, under ``torch.no_grad()``) it calls
the forward alone.  ``decode_attention`` (one query token against a
KV cache) is plain torch ops, as it is plain jnp in the reference.

A served rank may hold only a slice of a cache's sequence axis (the
reference's ``cache_specs`` splits it when the batch cannot be split, e.g.
long_500k at batch 1).  ``serve.engine`` then runs the call under
:func:`seq_shard`: the cache writes keep the slots of the slice, and
``decode_attention`` combines the slices' partial softmax over the group
(flash-decoding's split-KV: an all-reduce of the row max, then of the sums
and the weighted values).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.kernels.flash_attention import FlashAttention, flash_attention_fwd

NEG_INF = -1e30


@dataclass(frozen=True)
class SeqShard:
    """This rank's slots [offset, offset + the local cache length) of the
    KV caches' sequence axis, of ``size`` slices over ``group``."""
    offset: int
    size: int
    group: object


_SEQ_SHARD: contextvars.ContextVar[SeqShard | None] = contextvars.ContextVar(
    "seq_shard", default=None)


@contextlib.contextmanager
def seq_shard(shard: SeqShard | None):
    """Run the enclosed serving call on this rank's slice of the caches'
    sequence axis (None: the caches are whole)."""
    token = _SEQ_SHARD.set(shard)
    try:
        yield
    finally:
        _SEQ_SHARD.reset(token)


def current_seq_shard() -> SeqShard | None:
    return _SEQ_SHARD.get()


def local_slot(slot: int, local_len: int) -> int | None:
    """The local index of a global cache slot, None when another rank holds it."""
    shard = _SEQ_SHARD.get()
    off = shard.offset if shard is not None else 0
    return slot - off if 0 <= slot - off < local_len else None


def global_len(local_len: int) -> int:
    """A cache's whole sequence length from its local slice."""
    shard = _SEQ_SHARD.get()
    return local_len * (shard.size if shard is not None else 1)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None) -> torch.Tensor:
    """q: (B,Sq,Hq,d); k: (B,Sk,Hkv,d); v: (B,Sk,Hkv,dv) -> (B,Sq,Hq,dv).
    Query row i sits at key position Sk - Sq + i; ``scale`` defaults to
    1/sqrt(d).  (d, dv) is a pair the kernels take: d = dv, or 192 / 128
    (MLA), with a gradient too."""
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
    shard = _SEQ_SHARD.get()
    if shard is not None:
        return _split_kv(s, v_cache, length, shard).reshape(B, Hq, d).to(q.dtype)
    valid = torch.arange(S, device=q.device) < length
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, Hq, d).to(q.dtype)


def _split_kv(s, v_cache, length: int, sh: SeqShard):
    """softmax(s) v over the whole sequence from this rank's slice of it:
    s (B,Hkv,G,S_local) f32 scores of the local slots.  Returns (B,Hkv,G,d) f32."""
    S = s.shape[-1]
    valid = sh.offset + torch.arange(S, device=s.device) < length
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=sh.group)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    dist.all_reduce(l, group=sh.group)
    dist.all_reduce(o, group=sh.group)
    return o / l
