"""RWKV-6 WKV: the Hopper kernel and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.wkv6`` (see
``csrc/wkv6_fwd.cu`` for the design and what bounds it on the card).  It
computes what the model path ``repro.models.rwkv6.wkv_chunked`` does, which
is wider than the Pallas kernel: an initial state ``s0`` in, the last state
``S_last`` out, and any S, including the single token of a decode step (the
last chunk is masked, where the Pallas wrapper asserts that the chunk
divides S).  y and the state are f32 whatever the dtype of r, k, v.

``wkv6_fwd`` dispatches by the device of its inputs: a CPU tensor goes to
``wkv6_plain``; a CUDA tensor launches a kernel or raises.  On the card, S = 1
(a decode step) runs the decode kernel in either dtype; S > 1 runs the
tensor-core kernel for bfloat16, which copies 16 bytes at a time, so r, k
and v need 16-byte-aligned data and batch, time and head strides in
multiples of 8 elements, and logw 16-byte-aligned data and strides in
multiples of 4 (``_check`` raises otherwise; nothing is copied), and the
CUDA-core kernel for float32, which takes any strides.  Each function counts
its own runs in a plain integer attribute (``wkv6_fwd.launches``,
``wkv6_plain.calls``): one launch per call of the wrapper, whichever kernel
it runs; ``wkv6_fwd.decode_launches`` counts the S = 1 ones among them.

The backward (the reference trains by autodiff of ``wkv_chunked``; it has no
Pallas backward) is ``wkv6_bwd``: a CUDA kernel (``csrc/wkv6_bwd.cu``) for
CUDA tensors, the explicit chunked ``wkv6_bwd_plain`` for CPU tensors,
counted in ``wkv6_bwd.launches`` and ``wkv6_bwd_plain.calls``.
:class:`WKV6` is the autograd Function around the forward and it.  The S = 1
decode kernel has no backward: serving runs under ``no_grad``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

HEAD_DIMS = (64,)                # rwkv6-1.6b's head dim
CHUNK = 32                       # the kernel's chunk, as the reference's; the plain default
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _acc(t) -> torch.dtype:
    """The plain versions' arithmetic: float32, or float64 for float64
    inputs (as ``torch.autograd.gradcheck`` gives them)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def wkv6_plain(r, k, v, logw, u, s0=None, *, chunk: int = CHUNK):
    """Chunk-parallel WKV in torch ops, the twin of ``rwkv6.wkv_chunked``.

    r, k, v: (B,S,H,hd); logw: (B,S,H,hd) f32 <= 0; u: (H,hd) f32; s0:
    (B,H,hd,hd) f32 or None.  Returns (y (B,S,H,hd) f32, S_last (B,H,hd,hd)
    f32).  A ragged last chunk is padded with r = k = v = logw = 0, which
    leaves y and the state unchanged."""
    wkv6_plain.calls += 1
    acc = _acc(r)
    B, S, H, hd = r.shape
    Q = min(chunk, S)
    pad = -S % Q
    rf, kf, vf, wf = (F.pad(t.to(acc), (0, 0, 0, 0, 0, pad)) for t in (r, k, v, logw))
    u = u.to(acc)
    mask_lt = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device), diagonal=-1)
    m5 = mask_lt[None, :, :, None, None]
    state = (torch.zeros((B, H, hd, hd), dtype=acc, device=r.device)
             if s0 is None else s0.to(acc))
    ys = []
    for c0 in range(0, S + pad, Q):
        rc, kc, vc, wc = (t[:, c0:c0 + Q] for t in (rf, kf, vf, wf))    # (B,Q,H,hd)
        cw = torch.cumsum(wc, dim=1)                                     # inclusive
        # exponent cw[t] - w[t] - cw[i] <= 0 for i < t; the masked entries
        # (positive exponents) are never exponentiated
        expo = (cw - wc)[:, :, None] - cw[:, None, :]                    # (B,T,I,H,hd)
        dec = torch.where(m5, torch.exp(torch.where(m5, expo, 0.0)), 0.0)
        att = torch.einsum("bthd,btihd,bihd->btih", rc, dec, kc)
        diag = torch.einsum("bthd,hd,bthd->bth", rc, u, kc)
        y = torch.einsum("btih,bihd->bthd", att, vc) + diag[..., None] * vc
        y = y + torch.einsum("bthk,bhkv->bthv", rc * torch.exp(cw - wc), state)
        kdec = kc * torch.exp(cw[:, -1:] - cw)
        state = state * torch.exp(cw[:, -1])[..., None] + \
            torch.einsum("bihk,bihv->bhkv", kdec, vc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], state


wkv6_plain.calls = 0


def _revcumsum(t, dim: int):
    """sum over i >= k along ``dim``, the backward of an inclusive cumsum."""
    return torch.flip(torch.cumsum(torch.flip(t, (dim,)), dim), (dim,))


def wkv6_bwd_plain(r, k, v, logw, u, s0, dy, dS_last, *, chunk: int = CHUNK):
    """Explicit chunked backward of :func:`wkv6_plain` in torch ops, f32
    arithmetic: the algorithm the kernel follows, not a call to autograd.

    dy: (B,S,H,hd) gradient of y; dS_last: (B,H,hd,hd) gradient of S_last or
    None (zero).  Returns (dr, dk, dv, dlogw, du, ds0), each in its input's
    dtype (ds0 f32 also when s0 is None).  Per chunk, with cw the inclusive
    cumsum of w = logw, a = cw - w (exclusive), e_ti = exp(a_t - cw_i) for
    i < t (every exponent <= 0), A_ti = sum_c r_t e_ti k_i, D_ti = dy_t . v_i,
    S the state at the chunk's start and dS the gradient of the state at its
    end:
      dv_i = sum_{t>i} A_ti dy_t + (r_i u k_i) dy_i + (k_i o exp(cw_Q - cw_i)) dS
      dr_t = sum_{i<t} D_ti e_ti o k_i + exp(a_t) o S dy_t + u o k_t D_tt
      dk_i = sum_{t>i} D_ti e_ti o r_t + exp(cw_Q - cw_i) o dS v_i + u o r_i D_ii
      du   = sum_t r_t o k_t D_tt
      dS  <- exp(cw_Q) o dS + sum_t (r_t o exp(a_t))^T dy_t   (the carry, backward)
    dlogw reaches w through cw and through a = cw - w: with da_t = r_t o (dr_t
    less its u term) and dcw_i = -k_i o (dk_i less its u term), plus on the
    last row exp(cw_Q) o rowsum(S o dS) + sum_i k_i o (its dS term),
    dlogw = revcumsum(dcw + da) - da within the chunk."""
    wkv6_bwd_plain.calls += 1
    acc = _acc(r)
    B, S, H, hd = r.shape
    Q = min(chunk, S)
    pad = -S % Q
    dev = r.device
    rf, kf, vf, wf, dyf = (F.pad(t.to(acc), (0, 0, 0, 0, 0, pad))
                           for t in (r, k, v, logw, dy))
    u = u.to(acc)
    mask_lt = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev), diagonal=-1)
    m5 = mask_lt[None, :, :, None, None]
    chunks = range(0, S + pad, Q)

    # the chunk-start states, from s0
    state = torch.zeros((B, H, hd, hd), dtype=acc, device=dev) if s0 is None \
        else s0.to(acc)
    starts = []
    for c0 in chunks:
        starts.append(state)
        cw = torch.cumsum(wf[:, c0:c0 + Q], dim=1)
        kdec = kf[:, c0:c0 + Q] * torch.exp(cw[:, -1:] - cw)
        state = state * torch.exp(cw[:, -1])[..., None] + \
            torch.einsum("bihk,bihv->bhkv", kdec, vf[:, c0:c0 + Q])

    dS = torch.zeros((B, H, hd, hd), dtype=acc, device=dev) if dS_last is None \
        else dS_last.to(acc)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(u)
    for c0, st in zip(reversed(chunks), reversed(starts)):
        rc, kc, vc, wc, dyc = (t[:, c0:c0 + Q] for t in (rf, kf, vf, wf, dyf))
        cw = torch.cumsum(wc, dim=1)
        a = cw - wc
        ea = torch.exp(a)
        eq = torch.exp(cw[:, -1:] - cw)                                  # exp(cw_Q - cw_i)
        expo = a[:, :, None] - cw[:, None, :]                            # (B,T,I,H,hd)
        dec = torch.where(m5, torch.exp(torch.where(m5, expo, 0.0)), 0.0)
        att = torch.einsum("bthd,btihd,bihd->btih", rc, dec, kc)
        dvd = torch.einsum("bthv,bihv->btih", dyc, vc)                   # dy_t . v_i
        diag = torch.einsum("bthv,bthv->bth", dyc, vc)[..., None]        # D_tt
        bonus = torch.einsum("bthd,hd,bthd->bth", rc, u, kc)[..., None]
        dr_att = (torch.einsum("btih,btihd,bihd->bthd", dvd, dec, kc)
                  + ea * torch.einsum("bhkv,bthv->bthk", st, dyc))
        dk_att = (torch.einsum("btih,btihd,bthd->bihd", dvd, dec, rc)
                  + eq * torch.einsum("bhkv,bihv->bihk", dS, vc))
        dr[:, c0:c0 + Q] = dr_att + u * kc * diag
        dk[:, c0:c0 + Q] = dk_att + u * rc * diag
        dv[:, c0:c0 + Q] = (torch.einsum("btih,bthv->bihv", att, dyc) + bonus * dyc
                            + torch.einsum("bihk,bhkv->bihv", kc * eq, dS))
        du = du + (rc * kc * diag).sum((0, 1))
        da = rc * dr_att
        dcw = -kc * dk_att
        dcw[:, -1] += (torch.exp(cw[:, -1]) * (st * dS).sum(-1)
                       + (kc * eq * torch.einsum("bhkv,bihv->bihk", dS, vc)).sum(1))
        dw[:, c0:c0 + Q] = _revcumsum(dcw + da, 1) - da
        dS = dS * torch.exp(cw[:, -1])[..., None] + \
            torch.einsum("bthk,bthv->bhkv", rc * ea, dyc)
    return (dr[:, :S].to(r.dtype), dk[:, :S].to(k.dtype), dv[:, :S].to(v.dtype),
            dw[:, :S], du, dS)


wkv6_bwd_plain.calls = 0


def bind(lib: ctypes.CDLL):
    """The C entry point ``wkv6_fwd`` of a built library, typed."""
    fn = lib.wkv6_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 14 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from repro_torch.kernels import build

    return bind(build.load("wkv6_fwd"))


def _check(r, k, v, logw, u, s0):
    if any(t.ndim != 4 for t in (r, k, v, logw)) or u.ndim != 2:
        raise ValueError(f"wkv6_fwd takes r, k, v, logw (B,S,H,hd) and u (H,hd); got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw, u)]}")
    B, S, H, hd = r.shape
    if any(tuple(t.shape) != (B, S, H, hd) for t in (k, v, logw)) or \
            tuple(u.shape) != (H, hd):
        raise ValueError(f"shapes disagree: {[tuple(t.shape) for t in (r, k, v, logw, u)]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel (takes {HEAD_DIMS})")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must share one dtype, float32 or bfloat16; got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"logw and u must be float32; got {logw.dtype}, {u.dtype}")
    tensors = [r, k, v, logw, u] + ([s0] if s0 is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if any(t.stride(-1) != 1 for t in (r, k, v, logw)):
        raise ValueError("the last dim of r, k, v and logw must be contiguous")
    if s0 is not None and (tuple(s0.shape) != (B, H, hd, hd) or s0.dtype != torch.float32
                           or not s0.is_contiguous()):
        raise ValueError(f"s0 must be contiguous float32 {(B, H, hd, hd)}; got "
                         f"{s0.dtype} {tuple(s0.shape)}")
    if B == 0 or S == 0 or H == 0:
        raise ValueError(f"empty WKV: r {tuple(r.shape)}")
    # The kernels read s0 and write S_last as float4; the bf16 kernel of S > 1
    # copies r, k, v 16 bytes (8 elements) at a time and reads logw as
    # float4.  A quick test first (it runs on every call); the one that names
    # the fault only when it fails.
    if s0 is not None and s0.data_ptr() % 16:
        raise ValueError(f"s0: data must be 16-byte aligned; got address {s0.data_ptr():#x}")
    if r.dtype == torch.bfloat16 and S > 1 and (
            (r.data_ptr() | k.data_ptr() | v.data_ptr() | logw.data_ptr()) % 16
            or any(s % 8 for t in (r, k, v) for s in t.stride()[:3])
            or any(s % 4 for s in logw.stride()[:3])):
        _check_bf16_alignment(r, k, v, logw)


def _check_bf16_alignment(r, k, v, logw):
    for name, t, m in (("r", r, 8), ("k", k, 8), ("v", v, 8), ("logw", logw, 4)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned for the bfloat16 kernel; "
                             f"got address {t.data_ptr():#x} (storage offset "
                             f"{t.storage_offset()})")
        for dim, what in ((0, "batch"), (1, "time"), (2, "head")):
            # the stride of a size-1 dim is never used
            if t.shape[dim] > 1 and t.stride(dim) % m:
                raise ValueError(f"{name}: {what} stride {t.stride(dim)} is not a multiple "
                                 f"of {m} elements (the bfloat16 kernel reads 16-byte rows)")


def wkv6_fwd(r, k, v, logw, u, s0=None):
    """WKV forward, (y f32, S_last f32).  Shapes as :func:`wkv6_plain`.

    On CUDA tensors this launches a Hopper kernel on the current stream
    (r, k, v float32 or bfloat16, logw and u float32, last dims contiguous;
    hd in ``HEAD_DIMS``; s0 16-byte aligned; for bfloat16 at S > 1, r, k,
    v with 16-byte-aligned data and batch, time and head strides in
    multiples of 8 elements and logw with 16-byte-aligned data and strides
    in multiples of 4, which ``time_mix``'s views have; float32, and S = 1,
    take any other strides).
    CPU tensors go to :func:`wkv6_plain`, in the kernel's chunks of
    ``CHUNK``.  Any other device raises."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_fwd runs on cuda or cpu tensors, not {r.device}")
    _check(r, k, v, logw, u, s0)
    y, s_last = launch(_kernel_fn(), r, k, v, logw, u, s0)
    wkv6_fwd.launches += 1
    if r.shape[1] == 1:
        wkv6_fwd.decode_launches += 1
    return y, s_last


def launch(fn, r, k, v, logw, u, s0):
    """Allocate (y, S_last) and launch ``fn``, a ctypes binding of the C entry
    point ``wkv6_fwd``, on checked CUDA tensors; raise if the launch fails."""
    B, S, H, hd = r.shape
    u = u.contiguous()
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_last = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                s0.data_ptr() if s0 is not None else None, y.data_ptr(), s_last.data_ptr(),
                B, S, H, hd,
                *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3],
                *y.stride()[:2], _DTYPE_CODE[r.dtype],
                torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_fwd kernel launch failed: cudaError {rc}")
    return y, s_last


wkv6_fwd.launches = 0            # every launch
wkv6_fwd.decode_launches = 0     # the S = 1 ones (the decode kernel), counted in launches too


def bind_bwd(lib: ctypes.CDLL):
    """The C entry point ``wkv6_bwd`` of a built library, typed."""
    fn = lib.wkv6_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel_fn():
    from repro_torch.kernels import build

    return bind_bwd(build.load("wkv6_bwd"))


def _check_bwd(r, k, v, logw, u, s0, dy, dS_last):
    _check(r, k, v, logw, u, s0)
    if dy.shape != r.shape or dy.dtype != torch.float32 or dy.device != r.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous float32 {tuple(r.shape)} on {r.device}; "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    B, _, H, hd = r.shape
    if dS_last is not None and (tuple(dS_last.shape) != (B, H, hd, hd)
                                or dS_last.dtype != torch.float32
                                or not dS_last.is_contiguous() or dS_last.device != r.device):
        raise ValueError(f"dS_last must be contiguous float32 {(B, H, hd, hd)} on "
                         f"{r.device}; got {dS_last.dtype} {tuple(dS_last.shape)}")


def wkv6_bwd(r, k, v, logw, u, s0, dy, dS_last):
    """WKV backward, (dr, dk, dv, dlogw, du, ds0), from the forward's inputs,
    the gradient dy of y (f32) and dS_last of S_last (None: zero).

    On CUDA tensors this launches the backward kernel on the current stream
    (the inputs as :func:`wkv6_fwd` takes them; dy is made
    contiguous first, as autograd may hand over any layout; dS_last
    contiguous f32).  Its per-batch partials of du are summed here in a fixed
    order (no atomics, so the result does not change from run to run).  CPU
    tensors go to :func:`wkv6_bwd_plain`.  Any other device raises."""
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, logw, u, s0, dy, dS_last)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd runs on cuda or cpu tensors, not {r.device}")
    dy = dy.contiguous()
    _check_bwd(r, k, v, logw, u, s0, dy, dS_last)
    dr, dk, dv, dlogw, du_part, ds0 = launch_bwd(_bwd_kernel_fn(), r, k, v, logw, u, s0,
                                                 dy, dS_last)
    wkv6_bwd.launches += 1
    return dr, dk, dv, dlogw, du_part.sum(0), ds0


def launch_bwd(fn, r, k, v, logw, u, s0, dy, dS_last):
    """Allocate the outputs (dr, dk, dv in r's dtype, dlogw, du per batch
    (B,H,hd), ds0, all f32 but the first three) and the chunk-start states'
    scratch (B,H,nc,hd,hd) f32, and launch ``fn``, a ctypes binding of the C
    entry point ``wkv6_bwd``, on checked CUDA tensors; raise if the launch
    fails."""
    B, S, H, hd = r.shape
    nc = -(-S // CHUNK)
    u = u.contiguous()
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty((B, S, H, hd), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dlogw = torch.empty((B, S, H, hd), **f32)
    du_part = torch.empty((B, H, hd), **f32)
    ds0 = torch.empty((B, H, hd, hd), **f32)
    states = torch.empty((B, H, nc, hd, hd), **f32)
    with torch.cuda.device(r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                s0.data_ptr() if s0 is not None else None, dy.data_ptr(),
                dS_last.data_ptr() if dS_last is not None else None, states.data_ptr(),
                dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
                du_part.data_ptr(), ds0.data_ptr(), B, S, H, hd,
                *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3],
                _DTYPE_CODE[r.dtype], torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: cudaError {rc}")
    return dr, dk, dv, dlogw, du_part, ds0


wkv6_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """(y, S_last) of the WKV with a gradient: the forward runs
    :func:`wkv6_fwd` and keeps its inputs; the backward runs
    :func:`wkv6_bwd` on them.  Both dispatch by device, so CPU tensors take
    the plain versions and CUDA tensors the kernels.  A gradient of S_last
    that autograd does not hand over (training never reads it) is zero."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        y, s_last = wkv6_fwd(r, k, v, logw, u, s0)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        ctx.set_materialize_grads(False)
        return y, s_last

    @staticmethod
    def backward(ctx, dy, dS_last):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=logw.dtype, device=r.device)
        dr, dk, dv, dlogw, du, ds0 = wkv6_bwd(r, k, v, logw, u, s0, dy, dS_last)
        return dr, dk, dv, dlogw, du, (ds0 if s0 is not None else None)
