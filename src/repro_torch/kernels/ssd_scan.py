"""Mamba-2 SSD chunked scan: the Hopper kernel and its plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.ssd_scan`` (see
``csrc/ssd_scan_fwd.cu`` for the design and what bounds it on the card).
It computes what the model path ``repro.models.mamba2.ssd_chunked`` does,
which is wider than the Pallas kernel: an initial state ``h0`` in, the last
state ``h_last`` out, and any S (the last chunk is masked, where the Pallas
wrapper asserts that the chunk divides S).

Rounding follows the model path: ``xdt = x * dt`` is formed in x's dtype,
``dA = dt * A`` in f32, every product and the state in f32, and y is cast
to x's dtype.

``ssd_scan_fwd`` dispatches by the device of its inputs: a CPU tensor goes
to ``ssd_scan_plain``; a CUDA tensor launches the kernel or raises.
bfloat16 runs the tensor-core kernel, which copies 16 bytes at a time, so
x, B_ and C need 16-byte-aligned data and batch, time (and x's head)
strides that are multiples of 8 elements (``_check`` raises otherwise;
nothing is copied); float32 runs the CUDA-core kernel, which takes any
strides.  Each function counts its own runs in a plain integer attribute
(``ssd_scan_fwd.launches``, ``ssd_scan_plain.calls``).

The backward (the reference trains by autodiff of ``ssd_chunked``; it has
no Pallas backward) is ``ssd_scan_bwd``: a CUDA kernel (``csrc/
ssd_scan_bwd.cu``) for CUDA tensors, the explicit chunked
``ssd_scan_bwd_plain`` for CPU tensors, counted in
``ssd_scan_bwd.launches`` and ``ssd_scan_bwd_plain.calls``.
:class:`SSDScan` is the autograd Function around the forward and it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

# (head dim P, state size N) pairs the kernel is instantiated for: zamba2-7b's.
SHAPES = ((64, 64),)
CHUNK = 64                       # the kernel's chunk; the plain version's default
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _acc(t) -> torch.dtype:
    """The plain versions' arithmetic: float32, or float64 for float64
    inputs (as ``torch.autograd.gradcheck`` gives them)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def ssd_scan_plain(x, dt, A, B_, C, h0=None, *, chunk: int = CHUNK):
    """Chunked SSD scan in torch ops, the twin of ``mamba2.ssd_chunked``.

    x: (B,S,H,P); dt: (B,S,H) f32 post-softplus; A: (H,) f32 < 0; B_, C:
    (B,S,N) shared by the heads; h0: (B,H,P,N) f32 or None.  Returns
    (y (B,S,H,P) in x's dtype, h_last (B,H,P,N) f32).  A ragged last chunk
    is padded with dt = 0 and x = B = C = 0, which leaves y and the state
    unchanged."""
    ssd_scan_plain.calls += 1
    acc = _acc(x)
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    pad = -S % Q
    dA = (dt * A[None, None, :]).to(acc)                     # (B,S,H), <= 0
    xdt = x * dt[..., None].to(x.dtype)
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    m4 = mask[None, :, :, None]
    h = (torch.zeros((Bb, H, P, N), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc))
    ys = []
    for c0 in range(0, S + pad, Q):
        x_c = xdt[:, c0:c0 + Q].to(acc)                       # (B,Q,H,P)
        dA_c = dA[:, c0:c0 + Q]                               # (B,Q,H)
        B_c = B_[:, c0:c0 + Q].to(acc)                        # (B,Q,N)
        C_c = C[:, c0:c0 + Q].to(acc)
        cum = torch.cumsum(dA_c, dim=1)
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # (B,Q,Q,H)
        # the masked half has diff > 0: never exponentiate it
        L = torch.where(m4, torch.exp(torch.where(m4, diff, 0.0)), 0.0)
        cb = torch.einsum("bin,bjn->bij", C_c, B_c)
        y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * L, x_c)
        decay_end = torch.exp(cum[:, -1:, :] - cum)           # (B,Q,H)
        s_c = torch.einsum("bjh,bjhp,bjn->bhpn", decay_end, x_c, B_c)
        y_inter = torch.einsum("bin,bhpn->bihp", C_c, h) * torch.exp(cum)[..., None]
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + s_c
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1)[:, :S], h


ssd_scan_plain.calls = 0


def _revcumsum(t, dim: int):
    """sum over i >= k along ``dim``, the backward of an inclusive cumsum."""
    return torch.flip(torch.cumsum(torch.flip(t, (dim,)), dim), (dim,))


def ssd_scan_bwd_plain(x, dt, A, B_, C, h0, dy, dh_last, *, chunk: int = CHUNK):
    """Explicit chunked backward of :func:`ssd_scan_plain` in torch ops, f32
    arithmetic: the algorithm the kernel follows, not a call to autograd.

    dy: (B,S,H,P) gradient of y; dh_last: (B,H,P,N) gradient of h_last or
    None (zero).  Returns (dx, ddt, dA, dB_, dC, dh0), each in its input's
    dtype (dh0 f32 also when h0 is None).  Per chunk, with cum the inclusive
    cumsum of dA = dt A, L_ij = exp(cum_i - cum_j) (i >= j), G = (C B^T) o L
    and dh the gradient of the state at the chunk's end:
      d(xdt)_j = sum_i G_ij dy_i + exp(cum_Q - cum_j) dh B_j
      dB_j = sum_i L_ij (dy_i . xdt_j) C_i + exp(cum_Q - cum_j) xdt_j^T dh
      dC_i = sum_j L_ij (dy_i . xdt_j) B_j + exp(cum_i) dy_i^T h
      dh  <- exp(cum_Q) dh + sum_i exp(cum_i) dy_i^T C_i    (the carry, backward)
    and d(dA) is the reverse cumsum of d(cum) within the chunk, d(cum) taking
    the row sums less the column sums of G o (dy . xdt), the inter-chunk
    term and the state terms.  Every exponent is <= 0, as in the forward.
    As autograd does, d(xdt) is rounded to x's dtype before dx = d(xdt) dt
    and ddt = sum_p d(xdt) x + d(dA) A are formed."""
    ssd_scan_bwd_plain.calls += 1
    acc = _acc(x)
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    pad = -S % Q
    dev = x.device
    dA = (dt * A[None, None, :]).to(acc)
    xdt = x * dt[..., None].to(x.dtype)
    xdt, dyf = (F.pad(t.to(acc), (0, 0, 0, 0, 0, pad)) for t in (xdt, dy))
    dA = F.pad(dA, (0, 0, 0, pad))
    Bf, Cf = (F.pad(t.to(acc), (0, 0, 0, pad)) for t in (B_, C))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    m4 = mask[None, :, :, None]
    chunks = range(0, S + pad, Q)

    # the chunk-start states, from h0
    h = torch.zeros((Bb, H, P, N), dtype=acc, device=dev) if h0 is None \
        else h0.to(acc)
    starts = []
    for c0 in chunks:
        starts.append(h)
        cum = torch.cumsum(dA[:, c0:c0 + Q], dim=1)
        dend = torch.exp(cum[:, -1:] - cum)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bjh,bjhp,bjn->bhpn", dend, xdt[:, c0:c0 + Q], Bf[:, c0:c0 + Q])

    dh = torch.zeros((Bb, H, P, N), dtype=acc, device=dev) if dh_last is None \
        else dh_last.to(acc)
    dxdt, ddA = torch.empty_like(xdt), torch.empty_like(dA)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    for c0, h in zip(reversed(chunks), reversed(starts)):
        x_c, dy_c = xdt[:, c0:c0 + Q], dyf[:, c0:c0 + Q]            # (B,Q,H,P)
        B_c, C_c = Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]               # (B,Q,N)
        cum = torch.cumsum(dA[:, c0:c0 + Q], dim=1)                 # (B,Q,H)
        ecum, elast = torch.exp(cum), torch.exp(cum[:, -1])
        dend = torch.exp(cum[:, -1:] - cum)
        diff = cum[:, :, None, :] - cum[:, None, :, :]              # (B,Q,Q,H) [i, j]
        L = torch.where(m4, torch.exp(torch.where(m4, diff, 0.0)), 0.0)
        cb = torch.einsum("bin,bjn->bij", C_c, B_c)
        G = cb[..., None] * L
        dx_dot = torch.einsum("bihp,bjhp->bijh", dy_c, x_c)         # dy_i . xdt_j
        W = L * dx_dot
        M = G * dx_dot
        dhB = torch.einsum("bhpn,bjn->bjhp", dh, B_c)               # dh B_j
        xdh = torch.einsum("bjhp,bhpn->bjhn", x_c, dh)              # xdt_j^T dh
        dyh = torch.einsum("bihp,bhpn->bihn", dy_c, h)              # dy_i^T h
        dxdt[:, c0:c0 + Q] = (torch.einsum("bijh,bihp->bjhp", G, dy_c)
                              + dend[..., None] * dhB)
        dB[:, c0:c0 + Q] = (torch.einsum("bijh,bin->bjn", W, C_c)
                            + torch.einsum("bjh,bjhn->bjn", dend, xdh))
        dC[:, c0:c0 + Q] = (torch.einsum("bijh,bjn->bin", W, B_c)
                            + torch.einsum("bih,bihn->bin", ecum, dyh))
        state = dend * torch.einsum("bjhn,bjn->bjh", xdh, B_c)      # d(cum_Q) share of row j
        dcum = (M.sum(2) - M.sum(1) + ecum * torch.einsum("bihn,bin->bih", dyh, C_c)
                - state)
        dcum[:, -1] += elast * (h * dh).sum((2, 3)) + state.sum(1)
        ddA[:, c0:c0 + Q] = _revcumsum(dcum, 1)
        dh = dh * elast[:, :, None, None] + torch.einsum("bih,bihp,bin->bhpn", ecum, dy_c, C_c)

    dxdt = dxdt[:, :S].to(x.dtype)
    ddA = ddA[:, :S]
    dx = dxdt * dt[..., None].to(x.dtype)
    ddt = (dxdt.to(acc) * x.to(acc)).sum(-1) + ddA * A[None, None, :]
    dA_grad = (ddA * dt).sum((0, 1))
    return (dx, ddt, dA_grad, dB[:, :S].to(B_.dtype), dC[:, :S].to(C.dtype), dh)


ssd_scan_bwd_plain.calls = 0


def bind(lib: ctypes.CDLL):
    """The C entry point ``ssd_scan_fwd`` of a built library, typed."""
    fn = lib.ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel_fn():
    from repro_torch.kernels import build

    return bind(build.load("ssd_scan_fwd"))


def _check(x, dt, A, B_, C, h0):
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B_.ndim != 3 or C.ndim != 3:
        raise ValueError(f"ssd_scan_fwd takes x (B,S,H,P), dt (B,S,H), A (H,), "
                         f"B_/C (B,S,N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B_.shape)}, {tuple(C.shape)}")
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    if (tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,)
            or tuple(B_.shape) != (Bb, S, N) or tuple(C.shape) != (Bb, S, N)):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B_ {tuple(B_.shape)}, C {tuple(C.shape)}")
    if (P, N) not in SHAPES:
        raise ValueError(f"(head dim, state) = {(P, N)} not supported by the kernel "
                         f"(takes {SHAPES})")
    if x.dtype not in _DTYPE_CODE or B_.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B_, C must share one dtype, float32 or bfloat16; got "
                         f"{x.dtype}, {B_.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32; got {dt.dtype}, {A.dtype}")
    tensors = [x, dt, A, B_, C] + ([h0] if h0 is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if any(t.stride(-1) != 1 for t in (x, B_, C)):
        raise ValueError("the last dim of x, B_ and C must be contiguous")
    if h0 is not None and (tuple(h0.shape) != (Bb, H, P, N) or h0.dtype != torch.float32
                           or not h0.is_contiguous()):
        raise ValueError(f"h0 must be contiguous float32 {(Bb, H, P, N)}; got "
                         f"{h0.dtype} {tuple(h0.shape)}")
    if Bb == 0 or S == 0 or H == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}")
    # bf16: cp.async moves 16 bytes (8 elements), so every row of every head
    # must start on a 16-byte boundary.  A quick test first (it runs on every
    # call); the one that names the fault only when it fails.
    if x.dtype == torch.bfloat16 and (
            (x.data_ptr() | B_.data_ptr() | C.data_ptr()) % 16
            or any(s % 8 for s in x.stride()[:3] + B_.stride()[:2] + C.stride()[:2])
            or (h0 is not None and h0.data_ptr() % 8)):
        _check_bf16_alignment(x, B_, C, h0)


def _check_bf16_alignment(x, B_, C, h0):
    if h0 is not None and h0.data_ptr() % 8:
        raise ValueError(f"h0: data must be 8-byte aligned for the bfloat16 kernel; got "
                         f"address {h0.data_ptr():#x}")
    for name, t in (("x", x), ("B_", B_), ("C", C)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: bfloat16 data must be 16-byte aligned; got "
                             f"address {t.data_ptr():#x} (storage offset "
                             f"{t.storage_offset()})")
        for dim, what in ((0, "batch"), (1, "time"), (2, "head"))[:t.ndim - 1]:
            # the stride of a size-1 dim is never used
            if t.shape[dim] > 1 and t.stride(dim) % 8:
                raise ValueError(f"{name}: {what} stride {t.stride(dim)} is not a "
                                 f"multiple of 8 elements (bfloat16 takes 16-byte rows)")


def ssd_scan_fwd(x, dt, A, B_, C, h0=None):
    """SSD scan forward, (y, h_last).  Shapes as :func:`ssd_scan_plain`.

    On CUDA tensors this launches the Hopper kernel on the current stream
    (x, B_, C float32 or bfloat16 with their last dim contiguous; for
    bfloat16, 16-byte-aligned data and batch, time and head strides in
    multiples of 8 elements, which ``mamba2_apply``'s views of the conv
    output have: row stride H·P + 2N = 7,296 at zamba2-7b, B and C at
    offsets 7,168 and 7,232; float32 takes any other strides; dt, A float32
    with any strides; (P, N) in ``SHAPES``).  CPU tensors go to
    :func:`ssd_scan_plain`, in the kernel's chunks of ``CHUNK``.  Any other
    device raises."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B_, C, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_fwd runs on cuda or cpu tensors, not {x.device}")
    _check(x, dt, A, B_, C, h0)
    y, h_last = launch(_kernel_fn(), x, dt, A, B_, C, h0)
    ssd_scan_fwd.launches += 1
    return y, h_last


def launch(fn, x, dt, A, B_, C, h0):
    """Allocate (y, h_last) and launch ``fn``, a ctypes binding of the C
    entry point ``ssd_scan_fwd``, on checked CUDA tensors; raise if the
    launch fails."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    A = A.contiguous()
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C.data_ptr(),
                h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                h_last.data_ptr(), Bb, S, H, P, N,
                *x.stride()[:3], *dt.stride(), *B_.stride()[:2], *C.stride()[:2],
                *y.stride()[:2], _DTYPE_CODE[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_fwd kernel launch failed: cudaError {rc}")
    return y, h_last


ssd_scan_fwd.launches = 0


def bind_bwd(lib: ctypes.CDLL):
    """The C entry point ``ssd_scan_bwd`` of a built library, typed."""
    fn = lib.ssd_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel_fn():
    from repro_torch.kernels import build

    return bind_bwd(build.load("ssd_scan_bwd"))


def _check_bwd(x, dt, A, B_, C, h0, dy, dh_last):
    _check(x, dt, A, B_, C, h0)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous {x.dtype} {tuple(x.shape)} on {x.device}; "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    Bb, _, H, P = x.shape
    N = B_.shape[-1]
    if dh_last is not None and (tuple(dh_last.shape) != (Bb, H, P, N)
                                or dh_last.dtype != torch.float32
                                or not dh_last.is_contiguous() or dh_last.device != x.device):
        raise ValueError(f"dh_last must be contiguous float32 {(Bb, H, P, N)} on {x.device}; "
                         f"got {dh_last.dtype} {tuple(dh_last.shape)}")


def ssd_scan_bwd(x, dt, A, B_, C, h0, dy, dh_last):
    """SSD scan backward, (dx, ddt, dA, dB_, dC, dh0), from the forward's
    inputs, the gradient dy of y and dh_last of h_last (None: zero).

    On CUDA tensors this launches the backward kernel on the current stream
    (the inputs as :func:`ssd_scan_fwd` takes them; dy is made contiguous
    first, as autograd may hand over any layout; dh_last contiguous f32).
    Its per-head partials of dB_ and dC and per-batch partials of dA are
    summed here over that axis in a fixed order (no atomics, so the result
    does not change from run to run).  CPU tensors go to
    :func:`ssd_scan_bwd_plain`.  Any other device raises."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, A, B_, C, h0, dy, dh_last)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on cuda or cpu tensors, not {x.device}")
    dy = dy.contiguous()
    _check_bwd(x, dt, A, B_, C, h0, dy, dh_last)
    dx, ddt, dA_part, dB_part, dC_part, dh0 = launch_bwd(_bwd_kernel_fn(), x, dt, A, B_, C,
                                                         h0, dy, dh_last)
    ssd_scan_bwd.launches += 1
    return (dx, ddt, dA_part.sum(0), dB_part.sum(2).to(B_.dtype),
            dC_part.sum(2).to(C.dtype), dh0)


def launch_bwd(fn, x, dt, A, B_, C, h0, dy, dh_last):
    """Allocate the outputs (dx, ddt, dA per batch (B,H), dB_ and dC per head
    (B,S,H,N) f32, dh0) and the chunk-start states' scratch (B,H,nc,P,N)
    f32, and launch ``fn``, a ctypes binding of the C entry point
    ``ssd_scan_bwd``, on checked CUDA tensors; raise if the launch fails."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    nc = -(-S // CHUNK)
    A = A.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bb, S, H), **f32)
    dA_part = torch.empty((Bb, H), **f32)
    dB_part = torch.empty((Bb, S, H, N), **f32)
    dC_part = torch.empty((Bb, S, H, N), **f32)
    dh0 = torch.empty((Bb, H, P, N), **f32)
    states = torch.empty((Bb, H, nc, P, N), **f32)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C.data_ptr(),
                h0.data_ptr() if h0 is not None else None, dy.data_ptr(),
                dh_last.data_ptr() if dh_last is not None else None, states.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA_part.data_ptr(), dB_part.data_ptr(),
                dC_part.data_ptr(), dh0.data_ptr(), Bb, S, H, P, N,
                *x.stride()[:3], *dt.stride(), *B_.stride()[:2], *C.stride()[:2],
                _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError {rc}")
    return dx, ddt, dA_part, dB_part, dC_part, dh0


ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """(y, h_last) of the SSD scan with a gradient: the forward runs
    :func:`ssd_scan_fwd` and keeps its inputs; the backward runs
    :func:`ssd_scan_bwd` on them.  Both dispatch by device, so CPU tensors
    take the plain versions and CUDA tensors the kernels.  A gradient of
    h_last that autograd does not hand over (training never reads h_last)
    is zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, h0):
        y, h_last = ssd_scan_fwd(x, dt, A, B_, C, h0)
        ctx.save_for_backward(x, dt, A, B_, C, h0)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, A, B_, C, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dh0 = ssd_scan_bwd(x, dt, A, B_, C, h0, dy, dh_last)
        return dx, ddt, dA, dB, dC, (dh0 if h0 is not None else None)
