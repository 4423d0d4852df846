"""Plain PyTorch oracle for the attention kernel: the torch twin of
``repro.kernels.ref.attention_ref``.

The most naive formulation (full score matrix, full softmax), independent
of both the kernel and its tiled plain version, so the tests triangulate.
"""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Full-materialization softmax attention with GQA, f32 math.
    q: (B,Sq,Hq,d); k,v: (B,Sk,Hkv,·) -> (B,Sq,Hq,dv) in q's dtype.
    Query row i sits at key position Sk - Sq + i."""
    B, Sq, Hq, d = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Sq, Hkv, G, d).float()
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.float()) * scale
    qpos = (Sk - Sq) + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= qpos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~m, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, dv).to(q.dtype)
