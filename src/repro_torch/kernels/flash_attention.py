"""Flash attention forward: the Hopper kernel and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.flash_attention`` (see
``csrc/flash_attention_fwd.cu`` for the design, what bounds it on the card,
and where it deliberately differs from the Pallas kernel: the ``Sk - Sq``
causal offset, ragged lengths, strided (B,S,H,d) reads, and an lse output).

``flash_attention_fwd`` dispatches by the device of its inputs: a CPU tensor
goes to ``flash_attention_plain``; a CUDA tensor launches the kernel or
raises.  bfloat16 runs the tensor-core kernel, which copies 16 bytes at a
time, so its inputs need 16-byte-aligned data and batch, row and head
strides that are multiples of 8 elements (``_check`` raises otherwise;
nothing is copied); float32 runs the CUDA-core kernel, which takes any
strides.  Each function counts its own runs in a plain integer attribute
(``flash_attention_fwd.launches``, ``flash_attention_plain.calls``) so a run
can show which path it took.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

HEAD_DIMS = (64, 112, 128, 256)
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
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
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (B,S,H,d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k, v must be (B,Sk,Hkv,{d}) like q {tuple(q.shape)}; "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel "
                         f"(takes {HEAD_DIMS})")
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
    # bf16: cp.async moves 16 bytes (8 elements), so every row of every head
    # must start on a 16-byte boundary.  A quick test of all three first (it
    # runs on every call); the one that names the fault only when it fails.
    if q.dtype == torch.bfloat16 and (
            (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16
            or any(s % 8 for s in q.stride()[:3] + k.stride()[:3] + v.stride()[:3])):
        _check_bf16_alignment(q, k, v)


def _check_bf16_alignment(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
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
    """Attention forward, (o, lse).  q: (B,Sq,Hq,d); k, v: (B,Sk,Hkv,d).

    On CUDA tensors this launches the Hopper kernel (head dim 64, 112, 128
    or 256; float32 or bfloat16; last dim contiguous; for bfloat16, 16-byte
    aligned data and strides in multiples of 8) on the current stream.  CPU
    tensors go to :func:`flash_attention_plain`.  Any other device raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check(q, k, v)
    o, lse = launch(_kernel_fn(), q, k, v, causal=causal, window=window, scale=scale)
    flash_attention_fwd.launches += 1
    return o, lse


def launch(fn, q, k, v, *, causal, window, scale):
    """Allocate (o, lse) and launch ``fn``, a ctypes binding of the C entry
    point ``flash_attention_fwd``, on checked CUDA tensors; raise if the
    launch fails."""
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty((B, Sq, Hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                B, Sq, Sk, Hq, Hkv, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                float(scale), int(bool(causal)), int(window), _DTYPE_CODE[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: cudaError {rc}")
    return o, lse


flash_attention_fwd.launches = 0
