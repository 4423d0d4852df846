"""Flash attention forward and backward: the Hopper kernels and their plain
PyTorch versions.

The forward is the port of the Pallas TPU kernel
``repro.kernels.flash_attention`` (see ``csrc/flash_attention_fwd.cu`` for
the design, what bounds it on the card, and where it deliberately differs
from the Pallas kernel: the ``Sk - Sq`` causal offset, ragged lengths,
strided (B,S,H,d) reads, and an lse output).  The backward is the port of
the FlashAttention-2 backward the JAX package writes at the HLO level,
``repro.models.flash._vjp_bwd`` (see ``csrc/flash_attention_bwd.cu``):
``flash_attention_bwd`` gives (dq, dk, dv) from q, k, v, the forward's o
and lse, and do, and :class:`FlashAttention` ties the two together for
autograd.

``flash_attention_fwd`` dispatches by the device of its inputs: a CPU tensor
goes to ``flash_attention_plain``; a CUDA tensor launches the kernel or
raises.  bfloat16 runs the tensor-core kernel, which copies 16 bytes at a
time, so its inputs need 16-byte-aligned data and batch, row and head
strides that are multiples of 8 elements (``_check`` raises otherwise;
nothing is copied); float32 runs the CUDA-core kernel, which takes any
strides.  The forward takes the head-dim pairs ``FWD_HEAD_DIMS``: v as
wide as q and k (64, 96, 112, 128 or 256), or q/k 192 and v 128 (MLA); the
backward the same pairs (``BWD_HEAD_DIMS``); any other pair raises before
launch.  The backward follows the same rule for q, k, v and do: bfloat16
at the pairs of ``BWD_TC_HEAD_DIMS`` (head dim 64, 96, 112 or 128, and
192 / 128) runs tensor-core kernels that copy 16 bytes at a time, and
float32 (and bfloat16 at 256) CUDA-core kernels that take any strides.
Each function counts its own runs in a plain integer attribute
(``flash_attention_fwd.launches``, ``flash_attention_plain.calls``,
``flash_attention_bwd.launches``, ``flash_attention_bwd_plain.calls``) so a
run can show which path it took; ``flash_attention_fwd.noncausal_launches``
and ``flash_attention_bwd.noncausal_launches`` count the launches with
``causal=False`` (an encoder, a cross-attention) among their launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

HEAD_DIMS = (64, 96, 112, 128, 256)
# (d of q and k, dv of v and o) the forward kernel takes: dv = d, and
# DeepSeek-V3's MLA prefill (128 nope + 64 rope for q/k, 128 for v).
FWD_HEAD_DIMS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
# The pairs the backward kernels take: the forward's.
BWD_HEAD_DIMS = FWD_HEAD_DIMS
# (d, dv) pairs whose bf16 backward runs on the tensor cores.
BWD_TC_HEAD_DIMS = ((64, 64), (96, 96), (112, 112), (128, 128), (192, 128))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _band(q0: int, q1: int, Sq: int, Sk: int, causal: bool, window: int):
    """Keys [lo, hi) that queries [q0, q1) can see (query i sits at key
    position Sk - Sq + i)."""
    off = Sk - Sq
    hi = min(Sk, max(0, off + q1)) if causal else Sk
    lo = max(0, off + q0 - window + 1) if window else 0
    return lo, hi


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                          block_q=128, block_k=128):
    """Tiled online-softmax attention in torch ops: the same function as the
    kernel.  q: (B,Sq,Hq,d); k, v: (B,Sk,Hkv,d|dv).  Returns
    (o (B,Sq,Hq,dv) in q's dtype, lse (B,Hq,Sq) f32).  f32 math throughout;
    only k tiles that meet a q tile's causal/window band are visited."""
    flash_attention_plain.calls += 1
    B, Sq, Hq, d = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    off = Sk - Sq
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, d).float()
    kf, vf = k.float(), v.float()
    o = torch.empty((B, Sq, Hkv, G, dv), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        lo, hi = _band(q0, q1, Sq, Sk, causal, window)
        m = torch.full((B, Hkv, G, q1 - q0), float("-inf"), device=dev)
        l = torch.zeros((B, Hkv, G, q1 - q0), device=dev)
        acc = torch.zeros((B, Hkv, G, q1 - q0, dv), device=dev)
        qpos = off + torch.arange(q0, q1, device=dev)
        for k0 in range((lo // block_k) * block_k, hi, block_k):
            k1 = min(k0 + block_k, Sk)
            s = torch.einsum("bqhgd,bshd->bhgqs", qg[:, q0:q1], kf[:, k0:k1]) * scale
            if causal or window:
                kpos = torch.arange(k0, k1, device=dev)
                ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
                if causal:
                    ok &= qpos[:, None] >= kpos[None, :]
                if window:
                    ok &= qpos[:, None] - kpos[None, :] < window
                s = s.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a row with nothing visible yet keeps m = -inf; exp stays finite
            m_use = m_new.masked_fill(m_new == float("-inf"), 0.0)
            p = torch.exp(s - m_use[..., None])
            corr = torch.exp(m - m_use)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqs,bshd->bhgqd", p, vf[:, k0:k1])
            acc = acc * corr[..., None] + pv
            m = m_new
        lc = l.clamp_min(1e-30)
        o[:, q0:q1] = (acc / lc[..., None]).permute(0, 3, 1, 2, 4)
        lse[..., q0:q1] = m + torch.log(lc)
    return o.reshape(B, Sq, Hq, dv).to(q.dtype), lse.reshape(B, Hq, Sq)


flash_attention_plain.calls = 0


def bind(lib: ctypes.CDLL):
    """The C entry point ``flash_attention_fwd`` of a built library, typed."""
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from repro_torch.kernels import build

    return bind(build.load("flash_attention_fwd"))


def _check(q, k, v):
    _check_qkv(q, k, v)
    pair = (q.shape[3], v.shape[3])
    if pair not in FWD_HEAD_DIMS:
        raise ValueError(f"head dims (d {pair[0]}, dv {pair[1]}) not supported by the "
                         f"kernel (takes {FWD_HEAD_DIMS})")
    # bf16: cp.async moves 16 bytes (8 elements), so every row of every head
    # must start on a 16-byte boundary.  A quick test of all three first (it
    # runs on every call); the one that names the fault only when it fails.
    if q.dtype == torch.bfloat16:
        _check_bf16_alignment(q=q, k=k, v=v)


def _check_qkv(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (B,S,H,d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k must be (B,Sk,Hkv,{d}) like q {tuple(q.shape)} and v "
                         f"(B,Sk,Hkv,dv); got {tuple(k.shape)}, {tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, "
                         f"{v.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last dim of q, k and v must be contiguous")
    if B == 0 or Sq == 0 or k.shape[1] == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")


def _check_bf16_alignment(**tensors):
    ptrs = [t.data_ptr() for t in tensors.values()]
    strides = [st for t in tensors.values() for st in t.stride()[:3]]
    if not (any(p % 16 for p in ptrs) or any(st % 8 for st in strides)):
        return
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: bfloat16 data must be 16-byte aligned; got "
                             f"address {t.data_ptr():#x} (storage offset "
                             f"{t.storage_offset()})")
        for dim, what in ((0, "batch"), (1, "row"), (2, "head")):
            # the stride of a size-1 dim is never used
            if t.shape[dim] > 1 and t.stride(dim) % 8:
                raise ValueError(f"{name}: {what} stride {t.stride(dim)} is not a "
                                 f"multiple of 8 elements (bfloat16 takes 16-byte rows)")


def flash_attention_fwd(q, k, v, *, causal=True, window=0, scale=None):
    """Attention forward, (o (B,Sq,Hq,dv), lse).  q: (B,Sq,Hq,d); k:
    (B,Sk,Hkv,d); v: (B,Sk,Hkv,dv).

    On CUDA tensors this launches the Hopper kernel ((d, dv) in
    ``FWD_HEAD_DIMS``: dv = d in 64, 96, 112, 128, 256, or 192 and 128; float32
    or bfloat16; last dim contiguous; for bfloat16, 16-byte aligned data and
    strides in multiples of 8) on the current stream.  CPU tensors go to
    :func:`flash_attention_plain`.  Any other device raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check(q, k, v)
    o, lse = launch(_kernel_fn(), q, k, v, causal=causal, window=window, scale=scale)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.noncausal_launches += not causal
    return o, lse


def launch(fn, q, k, v, *, causal, window, scale):
    """Allocate (o, lse) and launch ``fn``, a ctypes binding of the C entry
    point ``flash_attention_fwd``, on checked CUDA tensors; raise if the
    launch fails."""
    B, Sq, Hq, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty((B, Sq, Hq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                B, Sq, Sk, Hq, Hkv, d, dv,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                float(scale), int(bool(causal)), int(window), _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: cudaError {rc}")
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.noncausal_launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True, window=0, scale=None,
                              block_q=128, block_k=128):
    """The gradient of attention by explicit recompute from lse, in torch
    ops: the same function as the backward kernel (not autograd of the
    forward).  q: (B,Sq,Hq,d); k: (B,Sk,Hkv,d); v: (B,Sk,Hkv,dv); o, do:
    (B,Sq,Hq,dv); lse: (B,Hq,Sq) f32.  Returns (dq, dk, dv) in the dtypes of
    q, k and v.  f32 math throughout:

        delta = rowsum(do * o) (over dv),  P = exp(scale q k^T - lse),
        dS = P (do v^T - delta) scale,  dq = dS k,  dk = dS^T q,  dv = P^T do,

    with dk and dv summed over the query heads of each GQA group; only tile
    pairs that meet the causal/window band are visited."""
    flash_attention_bwd_plain.calls += 1
    B, Sq, Hq, d = q.shape
    _, Sk, Hkv, dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    off = Sk - Sq
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, G, d).float()
    dog = do.reshape(B, Sq, Hkv, G, dv).float()
    kf, vf = k.float(), v.float()
    delta = (dog * o.reshape(B, Sq, Hkv, G, dv).float()).sum(-1).permute(0, 2, 3, 1)
    lseg = lse.reshape(B, Hkv, G, Sq)
    dq = torch.zeros((B, Sq, Hkv, G, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Sk, Hkv, d), dtype=torch.float32, device=dev)
    dvv = torch.zeros((B, Sk, Hkv, dv), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        lo, hi = _band(q0, q1, Sq, Sk, causal, window)
        qpos = off + torch.arange(q0, q1, device=dev)
        qc, doc = qg[:, q0:q1], dog[:, q0:q1]
        lse_c, dl_c = lseg[..., q0:q1, None], delta[..., q0:q1, None]
        for k0 in range((lo // block_k) * block_k, hi, block_k):
            k1 = min(k0 + block_k, Sk)
            kc, vc = kf[:, k0:k1], vf[:, k0:k1]
            s = torch.einsum("bqhgd,bshd->bhgqs", qc, kc) * scale
            kpos = torch.arange(k0, k1, device=dev)
            ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                ok &= qpos[:, None] >= kpos[None, :]
            if window:
                ok &= qpos[:, None] - kpos[None, :] < window
            # a row that sees no key has lse = -inf; all its entries are masked
            p = torch.where(ok, torch.exp(s - lse_c), 0.0)
            dp = torch.einsum("bqhgd,bshd->bhgqs", doc, vc)
            ds = p * (dp - dl_c) * scale
            dq[:, q0:q1] += torch.einsum("bhgqs,bshd->bqhgd", ds, kc)
            dk[:, k0:k1] += torch.einsum("bhgqs,bqhgd->bshd", ds, qc)
            dvv[:, k0:k1] += torch.einsum("bhgqs,bqhgd->bshd", p, doc)
    return dq.reshape(B, Sq, Hq, d).to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


flash_attention_bwd_plain.calls = 0


def bind_bwd(lib: ctypes.CDLL):
    """The C entry point ``flash_attention_bwd`` of a built library, typed."""
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 15
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel_fn():
    from repro_torch.kernels import build

    return bind_bwd(build.load("flash_attention_bwd"))


def _check_bwd(q, k, v, o, lse, do):
    _check_qkv(q, k, v)
    pair = (q.shape[3], v.shape[3])
    if pair not in BWD_HEAD_DIMS:
        raise ValueError(f"head dims (d {pair[0]}, dv {pair[1]}) not supported by the "
                         f"backward kernel (takes {BWD_HEAD_DIMS})")
    out_shape = q.shape[:3] + (v.shape[3],)
    for name, t in (("o", o), ("do", do)):
        if t.shape != out_shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(out_shape)} {q.dtype} on {q.device} "
                             f"(q's rows at v's width); got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"the last dim of {name} must be contiguous")
    B, Sq, Hq, _ = q.shape
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be contiguous float32 ({B}, {Hq}, {Sq}) on {q.device}; "
                         f"got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    if q.dtype == torch.bfloat16 and pair in BWD_TC_HEAD_DIMS:
        _check_bf16_alignment(q=q, k=k, v=v, do=do)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0, scale=None):
    """Attention backward, (dq, dk, dv), from the forward's inputs, its o and
    lse, and the output gradient do.

    On CUDA tensors this launches the Hopper kernels ((d, dv) in
    ``BWD_HEAD_DIMS``; float32 or bfloat16; last dims contiguous; for bfloat16 at the pairs of
    ``BWD_TC_HEAD_DIMS``, 16-byte aligned data and strides in multiples of
    8, which MLA's v, a view of the decompressed (B,S,H,dn+dv) buffer, meets)
    on the current stream.  do is made contiguous first: autograd may hand
    over any layout.  CPU tensors go to :func:`flash_attention_bwd_plain`.  Any other
    device raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, not {q.device}")
    do = do.contiguous()
    _check_bwd(q, k, v, o, lse, do)
    out = launch_bwd(_bwd_kernel_fn(), q, k, v, o, lse, do, causal=causal, window=window,
                     scale=scale)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.noncausal_launches += not causal
    return out


def launch_bwd(fn, q, k, v, o, lse, do, *, causal, window, scale):
    """Allocate (dq, dk, dv) and the delta scratch and launch ``fn``, a
    ctypes binding of the C entry point ``flash_attention_bwd``, on checked
    CUDA tensors; raise if a launch fails."""
    B, Sq, Hq, d = q.shape
    Sk, Hkv, d_v = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dq = torch.empty((B, Sq, Hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, Hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, Hkv, d_v), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, Sq, Sk, Hq, Hkv, d, d_v,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                *do.stride()[:3],
                float(scale), int(bool(causal)), int(window), _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {rc}")
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.noncausal_launches = 0


class FlashAttention(torch.autograd.Function):
    """softmax(scale q k^T) v with a gradient: the forward runs
    :func:`flash_attention_fwd` and keeps (q, k, v, o, lse); the backward
    runs :func:`flash_attention_bwd` on them.  Both dispatch by device, so
    CPU tensors take the plain versions and CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None
