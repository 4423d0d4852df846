"""Core neural-net primitives: the torch twins of ``repro.models.nn``.

Plain functions on tensors, with the reference's conventions kept exactly:
rmsnorm scales by ``(1 + gamma)`` in f32; layernorm normalises in f32 and
casts back to the input's dtype; the gated FFN splits ``h`` into
``(u, g)`` and returns ``u * act(g)``; GELU is the tanh approximation
(``jax.nn.gelu``'s default); RoPE rotates split halves with f32 angles.
Weights are stored (in, out) as in the reference, so a layer is ``x @ w``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn as tnn


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def param(*shape, device, dtype) -> tnn.Parameter:
    """An uninitialised, frozen parameter (serving never takes gradients)."""
    return tnn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                         requires_grad=False)


# ---------------------------------------------------------------------------
# Initializers (scales as in the reference; draws from a torch.Generator)
# ---------------------------------------------------------------------------

def normal_(w: torch.Tensor, scale: float, gen: torch.Generator) -> torch.Tensor:
    """Fill ``w`` in place with N(0, 1) * scale drawn in f32."""
    z = torch.randn(w.shape, generator=gen, device=w.device, dtype=torch.float32)
    return w.copy_(z.mul_(scale))


def uniform_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill ``w`` in place with U[0, 1) drawn in f32."""
    z = torch.rand(w.shape, generator=gen, device=w.device, dtype=torch.float32)
    return w.copy_(z)


def dense_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``w``: (in, out), scaled by 1/sqrt(in)."""
    return normal_(w, 1.0 / math.sqrt(w.shape[0]), gen)


def embed_init_(w: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return normal_(w, 0.02, gen)


# ---------------------------------------------------------------------------
# Norms / activations / FFN
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"gelu": gelu, "silu": F.silu}[name]


def ffn_apply(wi: torch.Tensor, wo: torch.Tensor, x: torch.Tensor,
              act: str) -> torch.Tensor:
    """x: (..., d_model). Gated (SwiGLU/GeGLU) or plain MLP."""
    h = x @ wi
    if act in ("swiglu", "geglu"):
        u, g = h.chunk(2, dim=-1)
        h = u * (F.silu(g) if act == "swiglu" else gelu(g))
    else:
        h = act_fn(act)(h)
    return h @ wo


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card would be
    # a blocking host-to-device copy on every call.
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(theta, exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, dh), positions: (B, S) or (S,). Rotates split halves."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs          # (B, S, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, emb)
