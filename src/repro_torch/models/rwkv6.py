"""RWKV-6 "Finch" block: the torch twin of ``repro.models.rwkv6`` for serving.

Time-mix with data-dependent decay (LoRA-produced per-token w), 5-way
token-shift interpolation (ddlerp), the per-head WKV recurrence and a
squared-ReLU channel-mix.  The WKV runs through ``kernels.wkv6.wkv6_fwd``
for every S, the single token of a decode step included, as the reference
routes decode through ``wkv_chunked``: the Hopper kernel for CUDA tensors,
its plain chunked version for CPU tensors.  w0, u and the group-norm gain
and bias are f32 whatever the model dtype, as in the reference.

Recurrence per head (dk = dv = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn as tnn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import wkv6_fwd
from repro_torch.models import nn

MIX_NAMES = ("r", "k", "v", "w", "g")
GROUP_NORM_EPS = 64e-5


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


class TimeMix(tnn.Module):
    """mu_base (D,), mu (5, D), mix_a (D, 5·rm), mix_b (5, rm, D); wr, wk,
    wv, wg, wo (D, D); w0 (D,) f32, decay_a (D, rd), decay_b (rd, D); u (H,
    hd) f32; ln_g, ln_b (D,) f32."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        D, hd, H = cfg.d_model, cfg.rwkv_head_dim, n_heads(cfg)
        rm, rd = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.mu_base = nn.param(D, **kw)
        self.mu = nn.param(5, D, **kw)
        self.mix_a = nn.param(D, 5 * rm, **kw)
        self.mix_b = nn.param(5, rm, D, **kw)
        self.wr = nn.param(D, D, **kw)
        self.wk = nn.param(D, D, **kw)
        self.wv = nn.param(D, D, **kw)
        self.wg = nn.param(D, D, **kw)
        self.w0 = nn.param(D, **f32)
        self.decay_a = nn.param(D, rd, **kw)
        self.decay_b = nn.param(rd, D, **kw)
        self.u = nn.param(H, hd, **f32)
        self.ln_g = nn.param(D, **f32)
        self.ln_b = nn.param(D, **f32)
        self.wo = nn.param(D, D, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's init scales: uniform mixes, small LoRAs, w0 = -2."""
        nn.uniform_(self.mu_base, gen)
        nn.uniform_(self.mu, gen)
        nn.normal_(self.mix_a, 0.01, gen)
        nn.normal_(self.mix_b, 0.01, gen)
        for w in (self.wr, self.wk, self.wv, self.wg):
            nn.dense_init_(w, gen)
        self.w0.fill_(-2.0)
        nn.normal_(self.decay_a, 0.01, gen)
        nn.normal_(self.decay_b, 0.01, gen)
        nn.normal_(self.u, 0.1, gen)
        self.ln_g.fill_(1.0)
        self.ln_b.zero_()
        nn.dense_init_(self.wo, gen)


class ChannelMix(tnn.Module):
    """mu_k, mu_r (D,); wk (D, d_ff), wv (d_ff, D), wr (D, D)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        D = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.mu_k = nn.param(D, **kw)
        self.mu_r = nn.param(D, **kw)
        self.wk = nn.param(D, cfg.d_ff, **kw)
        self.wv = nn.param(cfg.d_ff, D, **kw)
        self.wr = nn.param(D, D, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.uniform_(self.mu_k, gen)
        nn.uniform_(self.mu_r, gen)
        for w in (self.wk, self.wv, self.wr):
            nn.dense_init_(w, gen)


def _token_shift(x, last):
    """shifted[t] = x[t-1]; shifted[0] = last (B,D) or zeros."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: TimeMix, x, shifted) -> dict:
    """5-way data-dependent interpolation.  Returns name -> (B,S,D)."""
    dx = shifted - x
    base = x + dx * p.mu_base
    lora = torch.tanh(base @ p.mix_a)                       # (B,S,5*rm)
    lora = lora.reshape(*lora.shape[:-1], 5, -1)
    delta = torch.einsum("bsfr,frd->bsfd", lora, p.mix_b)   # (B,S,5,D)
    return {name: x + dx * (p.mu[i] + delta[:, :, i])
            for i, name in enumerate(MIX_NAMES)}


def time_mix(p: TimeMix, x, cfg: ModelConfig, shift_last=None, wkv_state=None):
    """RWKV-6 attention replacement.  x: (B,S,D), already layer-normed.
    Returns (y (B,S,D), the last input row (B,D) for the next token shift,
    the WKV state (B,H,hd,hd) f32)."""
    B, S, D = x.shape
    H, hd = n_heads(cfg), cfg.rwkv_head_dim
    mixed = _ddlerp(p, x, _token_shift(x, shift_last))
    r = (mixed["r"] @ p.wr).view(B, S, H, hd)
    k = (mixed["k"] @ p.wk).view(B, S, H, hd)
    v = (mixed["v"] @ p.wv).view(B, S, H, hd)
    g = F.silu(mixed["g"] @ p.wg)
    logw = -torch.exp(p.w0 + (torch.tanh(mixed["w"] @ p.decay_a) @ p.decay_b).float())
    y, new_state = wkv6_fwd(r, k, v, logw.view(B, S, H, hd), p.u, wkv_state)
    # per-head group norm, f32
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, unbiased=False, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    y = y.reshape(B, S, D) * p.ln_g + p.ln_b
    y = (y.to(x.dtype) * g) @ p.wo
    return y, x[:, -1, :], new_state


def channel_mix(p: ChannelMix, x, shift_last=None):
    shifted = _token_shift(x, shift_last)
    xk = x + (shifted - x) * p.mu_k
    xr = x + (shifted - x) * p.mu_r
    k = torch.square(torch.relu(xk @ p.wk))
    return torch.sigmoid(xr @ p.wr) * (k @ p.wv), x[:, -1, :]
