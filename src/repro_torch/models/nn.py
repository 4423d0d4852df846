"""Core neural-net primitives: the torch twins of ``repro.models.nn``.

Plain functions on tensors, with the reference's conventions kept exactly:
rmsnorm scales by ``(1 + gamma)`` in f32; layernorm normalises in f32 and
casts back to the input's dtype; the gated FFN splits ``h`` into
``(u, g)`` and returns ``u * act(g)``; GELU is the tanh approximation
(``jax.nn.gelu``'s default); RoPE rotates split halves with f32 angles;
the cross-entropy takes f32 logits.  Weights are stored (in, out) as in the
reference, so a layer is ``x @ w``.

Tensor parallelism (Megatron's f/g pair): under a :class:`TP` group each
rank holds its columns of a column-split weight and its rows of a row-split
one.  :func:`tp_copy` (identity forward, all-reduce of the gradient) enters
a column-split matmul, :func:`tp_reduce` (all-reduce forward, identity
backward) leaves a row-split one.  The embedding and the cross-entropy are
vocab-parallel: each rank holds ``V / tp`` rows of ``emb`` (columns of
``head``), looks up the tokens that fall in them and adds over the group,
and forms logsumexp and the gold logit from its slice of the logits.  With
``tp=None`` every one of these is the single-device function.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn as tnn


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def param(*shape, device, dtype) -> tnn.Parameter:
    """An uninitialised trainable parameter.  The serving entry points run
    under ``torch.no_grad()``, so they build no graph."""
    return tnn.Parameter(torch.empty(shape, device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TP:
    """A tensor-parallel group: this rank's index in it and its size."""
    group: object
    rank: int
    size: int


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """Enter a tensor-parallel region: identity forward, gradient summed
    over the group (every rank's slice of the next matmul contributes)."""
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def tp_reduce(x: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """Leave a tensor-parallel region: the ranks' partial results summed."""
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def tp_slice(b: torch.Tensor, width: int, tp: TP | None) -> torch.Tensor:
    """This rank's ``width`` entries of a replicated bias (the reference keeps
    ``bq``/``bk``/``bv`` whole on every rank); its gradient is summed over
    the group, so every rank holds the whole bias's gradient."""
    if tp is None:
        return b
    return tp_copy(b, tp).narrow(-1, tp.rank * width, width)


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

class RMSNorm(torch.autograd.Function):
    """The reference's rmsnorm, ``x * rsqrt(mean(x²) + eps) * (1 + gamma)`` in
    f32 cast back to x's dtype, with a hand-written backward that keeps only
    x and the f32 row scale: autograd of the same ops keeps two f32 copies of
    x (8 bytes an element, 16 a layer for two norms), which XLA's fusion in
    the reference does not, and which put a full-width gpt2-1.5b step at
    batch 16 × 1024 past the card's 80 GB."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, torch.float32)   # f32 (f64 only in gradcheck)
        xf = x.to(ct)
        rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, gamma, rstd)
        return (xf * rstd * (1.0 + gamma.to(ct))).to(x.dtype)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, gamma, rstd = ctx.saved_tensors
        xhat = x.to(rstd.dtype) * rstd
        g = dy.to(rstd.dtype)
        dx = dgamma = None
        if ctx.needs_input_grad[1]:
            dgamma = (g * xhat).reshape(-1, x.shape[-1]).sum(0).to(gamma.dtype)
        if ctx.needs_input_grad[0]:
            g = g * (1.0 + gamma.to(rstd.dtype))
            dx = (rstd * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))).to(x.dtype)
        return dx, dgamma, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return RMSNorm.apply(x, gamma, eps)


class LayerNorm(torch.autograd.Function):
    """The reference's layernorm, ``(x - mean) * rsqrt(var + eps) * gamma +
    beta`` in f32 cast back to x's dtype, with a hand-written backward that
    keeps only x and the f32 row mean and inverse deviation, as
    :class:`RMSNorm` does: autograd of the same ops keeps f32 copies of x
    (rwkv6's four norms a layer)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, torch.float32)   # f32 (f64 only in gradcheck)
        xf = x.to(ct)
        mu = xf.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(xf.var(dim=-1, unbiased=False, keepdim=True) + eps)
        ctx.save_for_backward(x, gamma, mu, rstd)
        ctx.beta_dtype = beta.dtype
        return ((xf - mu) * rstd * gamma.to(ct) + beta.to(ct)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, gamma, mu, rstd = ctx.saved_tensors
        xhat = (x.to(rstd.dtype) - mu) * rstd
        g = dy.to(rstd.dtype)
        dx = dgamma = dbeta = None
        if ctx.needs_input_grad[1]:
            dgamma = (g * xhat).reshape(-1, x.shape[-1]).sum(0).to(gamma.dtype)
        if ctx.needs_input_grad[2]:
            dbeta = g.reshape(-1, x.shape[-1]).sum(0).to(ctx.beta_dtype)
        if ctx.needs_input_grad[0]:
            g = g * gamma.to(rstd.dtype)
            dx = (rstd * (g - g.mean(dim=-1, keepdim=True)
                          - xhat * (g * xhat).mean(dim=-1, keepdim=True))).to(x.dtype)
        return dx, dgamma, dbeta, None


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    return LayerNorm.apply(x, gamma, beta, eps)


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


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor, tp: TP | None = None) -> torch.Tensor:
    """Rows of ``emb`` for ``tokens``; under ``tp`` each rank holds rows
    ``[rank·V/tp, (rank+1)·V/tp)`` and the ranks' lookups are added."""
    if tp is None:
        return F.embedding(tokens, emb)
    n = emb.shape[0]
    local = tokens - tp.rank * n
    inside = (local >= 0) & (local < n)
    out = F.embedding(local.clamp(0, n - 1), emb)
    return tp_reduce(out.masked_fill(~inside[..., None], 0), tp)


def _vocab_parallel_logz_gold(logits: torch.Tensor, y: torch.Tensor, tp: TP):
    """logsumexp over the whole vocabulary and the gold logit, from this
    rank's slice ``[rank·V/tp, (rank+1)·V/tp)`` of f32 logits."""
    n = logits.shape[-1]
    m = logits.detach().amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    logz = m[..., 0] + torch.log(tp_reduce(torch.exp(logits - m).sum(-1), tp))
    local = y.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return logz, tp_reduce(gold.masked_fill(~inside, 0), tp)


def cross_entropy_loss(logits_fn, hidden: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None, chunk: int = 0,
                       tp: TP | None = None) -> torch.Tensor:
    """Next-token CE, the masked mean of logsumexp(logits) - gold logit, with
    the logits ``logits_fn(h) -> (..., V)`` cast to f32.

    ``chunk`` > 0 (and dividing S, with S > chunk) evaluates the vocab
    projection and the CE one sequence chunk at a time, as the reference's
    ``lax.map`` does, so the whole (B, S, V) f32 logits tensor is never
    formed at once in the forward.  Under ``tp`` ``logits_fn`` gives this
    rank's vocabulary slice and the loss is vocab-parallel."""
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)

    def chunk_loss(h, y, m):
        logits = logits_fn(h).float()
        if tp is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
        else:
            logz, gold = _vocab_parallel_logz_gold(logits, y, tp)
        return ((logz - gold) * m).sum(), m.sum()

    if chunk and S > chunk and S % chunk == 0:
        parts = [chunk_loss(hidden[:, c:c + chunk], labels[:, c:c + chunk],
                            mask[:, c:c + chunk]) for c in range(0, S, chunk)]
        tot = torch.stack([t for t, _ in parts]).sum()
        cnt = torch.stack([n for _, n in parts]).sum()
        return tot / cnt.clamp_min(1.0)
    tot, cnt = chunk_loss(hidden, labels, mask)
    return tot / cnt.clamp_min(1.0)
