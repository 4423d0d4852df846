"""Plain PyTorch oracles for the kernels: the torch twins of
``repro.kernels.ref`` (``attention_ref``, ``ssd_ref``, ``wkv6_ref``).

The most naive formulations (full score matrix and softmax; per-timestep
recurrences), independent of both the kernels and their chunked plain
versions, so the tests triangulate.
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


def ssd_ref(x, dt, A, B_, C):
    """Per-timestep SSM recurrence (the definition, O(S) sequential).
    x: (B,S,H,P); dt: (B,S,H); A: (H,); B_/C: (B,S,N) -> (B,S,H,P) f32."""
    Bb, S, H, P = x.shape
    xdt = x.float() * dt[..., None]
    da = torch.exp(dt * A[None, None, :])                # (B,S,H)
    Bf, Cf = B_.float(), C.float()
    h = torch.zeros((Bb, H, P, B_.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * da[:, t, :, None, None] + torch.einsum("bn,bhp->bhpn", Bf[:, t], xdt[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1)


def wkv6_ref(r, k, v, logw, u):
    """Per-timestep RWKV-6 recurrence:
        S_t = diag(w_t) S_{t-1} + k_t^T v_t
        y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    r,k,v,logw: (B,S,H,hd); u: (H,hd) -> (B,S,H,hd) f32."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    st = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], st + u.float()[None, :, :, None] * kv))
        st = torch.exp(wf[:, t])[..., None] * st + kv
    return torch.stack(ys, dim=1)
