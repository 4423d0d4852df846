"""Mamba-2 (SSD) block: the torch twin of ``repro.models.mamba2`` for serving
and training.

Layout as the reference: x (B,S,H,P) with H heads of head dim P, a scalar
decay per head, B/C projections shared by the heads (n_groups = 1), state
size N.  Prefill (:func:`mamba2_apply`) runs its scan through
``kernels.ssd_scan.ssd_scan_fwd``: the Hopper kernel for CUDA tensors, its
plain chunked version for CPU tensors, both in the kernel's chunks of 64
(``cfg.ssm_chunk``, the reference's chunk, changes only the rounding, so the
port does not read it).  With grad enabled and an input that requires grad
(training) the scan goes through :class:`~repro_torch.kernels.ssd_scan.
SSDScan`, whose backward is the SSD backward kernel; otherwise (serving,
under ``torch.no_grad()``) it calls the forward alone.  Decode (:func:`mamba2_decode_step`)
is the one-token recurrence in plain torch ops, as it is plain jnp in the
reference.  A_log, D_skip and dt_bias are f32 whatever the model dtype, as
in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn as tnn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan_fwd
from repro_torch.models import nn


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def conv_dim(cfg: ModelConfig) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_state              # x, B, C share the conv


class Mamba2(tnn.Module):
    """in_proj (D, 2·di + 2·N + H) for z, x, B, C, dt; depthwise conv_w (K, C)
    and conv_b (C,); A_log, D_skip, dt_bias (H,) f32; gamma (di,); out_proj
    (di, D)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        D, di, N, H = cfg.d_model, d_inner(cfg), cfg.ssm_state, n_ssm_heads(cfg)
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = nn.param(D, 2 * di + 2 * N + H, **kw)
        self.conv_w = nn.param(cfg.ssm_conv, conv_dim(cfg), **kw)
        self.conv_b = nn.param(conv_dim(cfg), **kw)
        self.A_log = nn.param(H, **f32)
        self.D_skip = nn.param(H, **f32)
        self.dt_bias = nn.param(H, **f32)
        self.gamma = nn.param(di, **kw)
        self.out_proj = nn.param(di, D, **kw)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's init: A = -linspace(1, 16, H), unit D skip, zero
        dt bias and conv bias, conv weights 0.1 * N(0, 1)."""
        nn.dense_init_(self.in_proj, gen)
        nn.normal_(self.conv_w, 0.1, gen)
        self.conv_b.zero_()
        H = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H, device=self.A_log.device)))
        self.D_skip.fill_(1.0)
        self.dt_bias.zero_()
        self.gamma.zero_()
        nn.dense_init_(self.out_proj, gen)


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B,S,C); w: (K,C).  Summed tap by tap in
    x's dtype, as the reference sums."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _split(cfg: ModelConfig, zxbcdt):
    """(z, conv_in = [x, B, C], dt) views of the input projection."""
    di, N = d_inner(cfg), cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])


def mamba2_apply(p: Mamba2, x, cfg: ModelConfig, state: dict | None = None,
                 return_state: bool = False):
    """One Mamba-2 block over a sequence.  x: (B,S,D).

    ``state`` ({"ssm": (B,H,P,N) f32, ...}) seeds the scan; None means zero
    state.  With ``return_state`` also returns {"conv" (B,K-1,C), "ssm"
    (B,H,P,N) f32}, the carry for continuing generation after a prefill."""
    B, S, _ = x.shape
    di, N = d_inner(cfg), cfg.ssm_state
    H, P = n_ssm_heads(cfg), cfg.ssm_head_dim

    z, conv_in, dt = _split(cfg, x @ p.in_proj)
    conv_out = F.silu(_causal_conv(conv_in, p.conv_w, p.conv_b))
    xs, Bc, Cc = conv_out[..., :di], conv_out[..., di:di + N], conv_out[..., di + N:]
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    h0 = state["ssm"] if state is not None else None
    xh = xs.view(B, S, H, P)
    args = (xh, dt, A, Bc, Cc, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        y, h_last = SSDScan.apply(*args)
    else:
        y, h_last = ssd_scan_fwd(*args)
    y = y + p.D_skip[None, None, :, None].to(y.dtype) * xh
    y = nn.rmsnorm(y.reshape(B, S, di), p.gamma, cfg.norm_eps) * F.silu(z)
    out = y @ p.out_proj
    if return_state:
        K = cfg.ssm_conv
        conv = F.pad(conv_in, (0, 0, max(0, K - 1 - S), 0))[:, -(K - 1):]
        return out, {"conv": conv, "ssm": h_last}
    return out


# ---------------------------------------------------------------------------
# Decode (recurrent) path
# ---------------------------------------------------------------------------

def mamba2_init_state(cfg: ModelConfig, batch: int, n_stack: int, *, device, dtype) -> dict:
    """Zero carry for ``n_stack`` layers: conv window in the model dtype, the
    SSM state in f32 (as ``hybrid_init_cache`` keeps it)."""
    H, P = n_ssm_heads(cfg), cfg.ssm_head_dim
    return {
        "conv": torch.zeros((n_stack, batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                            device=device, dtype=dtype),
        "ssm": torch.zeros((n_stack, batch, H, P, cfg.ssm_state), device=device,
                           dtype=torch.float32),
    }


def mamba2_decode_step(p: Mamba2, x, state: dict, cfg: ModelConfig):
    """x: (B,1,D); state (one layer): conv (B,K-1,C), ssm (B,H,P,N).
    Returns (out (B,1,D), new state).  Dtypes follow the reference's
    promotions: the update term is formed in x's dtype, the state and the
    readout y in the state's dtype (f32 in the cache)."""
    B = x.shape[0]
    di, N = d_inner(cfg), cfg.ssm_state
    H, P = n_ssm_heads(cfg), cfg.ssm_head_dim

    z, conv_in, dt = _split(cfg, x[:, 0] @ p.in_proj)
    window = torch.cat([state["conv"], conv_in[:, None, :]], dim=1)   # (B,K,C)
    conv_out = (window.float() * p.conv_w.float()).sum(dim=1).to(x.dtype) + p.conv_b
    conv_out = F.silu(conv_out)
    xs, Bc, Cc = conv_out[:, :di], conv_out[:, di:di + N], conv_out[:, di + N:]

    dt = F.softplus(dt.float() + p.dt_bias)                            # (B,H)
    A = -torch.exp(p.A_log)
    da = torch.exp(dt * A)
    xh = xs.reshape(B, H, P)
    upd = torch.einsum("bn,bhp,bh->bhpn", Bc.float(), xh.float(),
                       dt.to(xh.dtype).float()).to(xh.dtype)
    ssm = state["ssm"]
    h = ssm * da[:, :, None, None].to(ssm.dtype) + upd
    y = torch.einsum("bn,bhpn->bhp", Cc.to(h.dtype), h)
    y = y + p.D_skip[None, :, None].to(y.dtype) * xh
    y = y.reshape(B, di).to(x.dtype)
    y = nn.rmsnorm(y, p.gamma, cfg.norm_eps) * F.silu(z)
    out = (y @ p.out_proj)[:, None, :].to(x.dtype)
    return out, {"conv": window[:, 1:], "ssm": h.to(ssm.dtype)}

