"""The port's WKV6 against the JAX package.

``wkv6_plain`` (the kernel's plain version, which the CPU path runs) is
held to the Pallas kernel in interpret mode (zero initial state, chunks that
divide S: all it takes), to ``repro.kernels.ref.wkv6_ref``, and to the model
path ``repro.models.rwkv6.wkv_chunked`` with a nonzero s0, whose S_last it
must match too, with r, k, v in bf16 as the model passes them; it is causal
(the prefix property) and takes ragged S and S = 1 (a decode step).  Bound:
max|Δ| / max|reference| below 2e-5 (tests/test_kernels.py; y and the state
are f32 whatever the input dtype).  The kernel itself is held to the plain
version on the card (``gpu`` marker) at the same bound, and so is its
arithmetic, emulated here: the bf16 kernel's sub-chunk factoring, hi + lo
bf16 splits and f32 sums must stay inside that bound on the CPU first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rwkv6 as jrwkv6
from repro_torch import configs
from repro_torch.kernels import ref as tref
from repro_torch.kernels.wkv6 import _check, wkv6_fwd, wkv6_plain
from repro_torch.models import rwkv6 as trwkv6

BOUND = 2e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


def _inputs(seed, B, S, H, hd, dtype="float32", s0=False):
    """Same values for both frameworks: r, k, v in ``dtype``; logw, u, s0
    f32 (the distributions of tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    arrs = {name: rng.normal(0, 1, (B, S, H, hd)).astype(np.float32) for name in "rkv"}
    arrs["logw"] = -rng.uniform(0.02, 3.0, (B, S, H, hd)).astype(np.float32)
    arrs["u"] = rng.normal(0, 0.5, (H, hd)).astype(np.float32)
    if s0:
        arrs["s0"] = rng.normal(0, 1, (B, H, hd, hd)).astype(np.float32)
    jx = {k: jnp.asarray(a, JDT[dtype] if k in "rkv" else jnp.float32)
          for k, a in arrs.items()}
    tx = {k: torch.from_numpy(a).to(TDT[dtype] if k in "rkv" else torch.float32)
          for k, a in arrs.items()}
    return jx, tx


def _args(d):
    return d["r"], d["k"], d["v"], d["logw"], d["u"]


@pytest.mark.parametrize("S,H,hd,chunk", [(32, 2, 16, 8), (64, 1, 32, 32),
                                          (128, 4, 64, 32)])
def test_plain_matches_pallas_and_ref(S, H, hd, chunk):
    j, t = _inputs(3, 2, S, H, hd)
    want = jops.wkv6(*_args(j), chunk=chunk, interpret=True)
    y, s_last = wkv6_plain(*_args(t), chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (2, S, H, hd)
    assert s_last.dtype == torch.float32 and s_last.shape == (2, H, hd, hd)
    assert _rel(y, want) < BOUND
    assert _rel(y, jref.wkv6_ref(*_args(j))) < BOUND


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref(dtype):
    j, t = _inputs(4, 2, 40, 3, 16, dtype)
    got = tref.wkv6_ref(*_args(t))
    assert got.dtype == torch.float32
    assert _rel(got, jref.wkv6_ref(*_args(j))) < BOUND


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,jchunk", [
    (64, 32, 32),      # chunks divide S
    (50, 32, 50),      # ragged: the port pads its last chunk, the model path takes one chunk of S
    (1, 32, 1),        # one decode step
])
def test_plain_matches_model_path_with_s0(S, chunk, jchunk, dtype):
    j, t = _inputs(5, 2, S, 3, 16, dtype, s0=True)
    want_y, want_s = jrwkv6.wkv_chunked(*_args(j), jchunk, j["s0"])
    y, s_last = wkv6_plain(*_args(t), t["s0"], chunk=chunk)
    assert _rel(y, want_y) < BOUND
    assert _rel(s_last, want_s) < BOUND


def test_decode_steps_equal_one_scan():
    """S_last carries the recurrence: S = 1 steps chained through s0 equal
    one scan over the whole sequence."""
    _, t = _inputs(6, 2, 12, 2, 16)
    y, s = wkv6_plain(*_args(t))
    state, ys = None, []
    for i in range(12):
        yi, state = wkv6_plain(*(a[:, i:i + 1] for a in _args(t)[:4]), t["u"], state)
        ys.append(yi)
    assert _rel(torch.cat(ys, 1), y) < BOUND
    assert _rel(state, s) < BOUND


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_plain_prefix_property(seed):
    """Causality: the output at t depends only on inputs at times <= t."""
    _, t = _inputs(seed, 1, 32, 2, 8)
    full, _ = wkv6_plain(*_args(t), chunk=8)
    half, _ = wkv6_plain(*(a[:, :16] for a in _args(t)[:4]), t["u"], chunk=8)
    np.testing.assert_allclose(full[:, :16].numpy(), half.numpy(), atol=1e-5, rtol=1e-5)


def _load(module, tree):
    module.load_state_dict({k: torch.tensor(_f32(v)).to(getattr(module, k).dtype)
                            for k, v in tree.items()})
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [24, 1])
def test_time_and_channel_mix_match_jax(S, dtype):
    """One RWKV-6 block of reduced rwkv6 from nonzero shift and WKV states:
    prefill-sized and decode-sized (S = 1, through the kernel wrapper too)."""
    jcfg = jconfigs.get_reduced("rwkv6-1.6b").with_(dtype=dtype)
    tcfg = configs.get_reduced("rwkv6-1.6b").with_(dtype=dtype)
    jp = jax.tree.map(lambda a: a[0], jrwkv6.rwkv6_init(jax.random.PRNGKey(2), jcfg, 1,
                                                        JDT[dtype]))
    tm = _load(trwkv6.TimeMix(tcfg, "cpu", TDT[dtype]), jp["tm"])
    cm = _load(trwkv6.ChannelMix(tcfg, "cpu", TDT[dtype]), jp["cm"])
    rng = np.random.default_rng(10)
    D, H, hd = tcfg.d_model, trwkv6.n_heads(tcfg), tcfg.rwkv_head_dim
    x = rng.normal(0, 1, (2, S, D)).astype(np.float32)
    last = rng.normal(0, 1, (2, D)).astype(np.float32)
    s0 = rng.normal(0, 0.5, (2, H, hd, hd)).astype(np.float32)
    jx, jl = jnp.asarray(x, JDT[dtype]), jnp.asarray(last, JDT[dtype])
    tx, tl = torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(last).to(TDT[dtype])
    tol = 1e-4 if dtype == "float32" else 3e-2
    jy, jshift, jstate = jrwkv6.time_mix(jp["tm"], jx, jcfg, jl, jnp.asarray(s0))
    ty, tshift, tstate = trwkv6.time_mix(tm, tx, tcfg, tl, torch.from_numpy(s0))
    assert ty.dtype == TDT[dtype] and tstate.dtype == torch.float32
    assert _rel(ty, jy) < tol
    assert _rel(tstate, jstate) < tol
    assert torch.equal(tshift, tx[:, -1])
    jy, _ = jrwkv6.channel_mix(jp["cm"], jx, jl)
    ty, _ = trwkv6.channel_mix(cm, tx, tl)
    assert _rel(ty, jy) < tol


def test_wrapper_dispatches_by_device():
    _, t = _inputs(7, 1, 4, 2, 16)
    launches, calls = wkv6_fwd.launches, wkv6_plain.calls
    wkv6_fwd(*_args(t))
    assert wkv6_plain.calls == calls + 1
    assert wkv6_fwd.launches == launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        wkv6_fwd(*(a.to("meta") for a in _args(t)))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    """x as bf16 hi + lo halves (f32 values)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _no_lo(x):
    """x rounded to bf16 once, with no lo half."""
    return _bf16(x), torch.zeros_like(x)


def _mm3(a, b, split):
    """a @ b with both operands split: hi hi + hi lo + lo hi, f32 sums."""
    (ah, al), (bh, bl) = split(a), split(b)
    return ah @ bh + ah @ bl + al @ bh


def _mm2(a, b, split):
    """a @ b with a split and b exact in bf16: hi b + lo b, f32 sums."""
    ah, al = split(a)
    return ah @ b + al @ b


def _emulate_bf16_kernel(r, k, v, logw, u, s0=None, Q=32, sub=16, split=_split):
    """The arithmetic of the bf16 tensor-core kernel (csrc/wkv6_fwd.cu,
    namespace tc) in torch: per chunk of 32, the two diagonal 16 x 16 score
    blocks with the exact per-(t, i, c) exponent in f32, the block of rows
    16-31 x columns 0-15 factored at b = 15 as r~ k~^T with both operands
    split hi + lo, y = A v (A split) + rd S (both split), S = e^{cw_Q} S +
    kd^T v (kd split), every sum in f32."""
    B, S, H, D = r.shape
    pad = -S % Q
    rf, kf, vf, wf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)).transpose(1, 2)
                      for t in (r, k, v, logw))                          # (B,H,S',D)
    state = torch.zeros((B, H, D, D)) if s0 is None else s0.float().clone()
    lower = torch.tril(torch.ones((sub, sub), dtype=torch.bool), diagonal=-1)[:, :, None]
    ys = []
    for c0 in range(0, S + pad, Q):
        rc, kc, vc, wc = (t[:, :, c0:c0 + Q] for t in (rf, kf, vf, wf))
        cw = torch.cumsum(wc, dim=2)
        cm = cw - wc
        cwq, cwb = cw[:, :, -1:], cw[:, :, sub - 1:sub]
        A = torch.zeros((B, H, Q, Q))
        for s in (0, sub):
            d = slice(s, s + sub)
            expo = cm[:, :, d, None, :] - cw[:, :, None, d, :]
            dec = torch.where(lower, torch.exp(torch.where(lower, expo, 0.0)), 0.0)
            A[:, :, d, d] = (torch.einsum("bhtc,bhtic,bhic->bhti", rc[:, :, d], dec, kc[:, :, d])
                             + torch.diag_embed((rc[:, :, d] * u[:, None] * kc[:, :, d]).sum(-1)))
        kt = kc[:, :, :sub] * torch.exp(cwb - cw[:, :, :sub])
        rt = rc[:, :, sub:] * torch.exp(cm[:, :, sub:] - cwb)
        A[:, :, sub:, :sub] = _mm3(rt, kt.transpose(-1, -2), split)
        y = _mm2(A, vc, split) + _mm3(rc * torch.exp(cm), state, split)
        kd = kc * torch.exp(cwq - cw)
        state = state * torch.exp(cwq).transpose(-1, -2) + _mm2(kd.transpose(-1, -2), vc, split)
        ys.append(y)
    return torch.cat(ys, dim=2).transpose(1, 2)[:, :S], state


@pytest.mark.parametrize("decay", ["tests", "rwkv6 model"])
@pytest.mark.parametrize("S", [1, 33, 300])
def test_bf16_kernel_arithmetic_within_bound(S, decay):
    """The bf16 kernel's precision budget, checked on the CPU: its emulated
    arithmetic against wkv6_plain, with s0, at the bound of the card test,
    on the tests' decay range (-0.02 to -3 a step) and on the served model's
    (logw = -exp(w0 + small), w0 = -2: about -0.135 a step)."""
    _, t = _inputs(11, 2, S, 2, 64, "bfloat16", s0=True)
    if decay == "rwkv6 model":
        noise = np.random.default_rng(12).normal(0, 1, tuple(t["logw"].shape))
        t["logw"] = -torch.exp(torch.from_numpy(-2.0 + 0.01 * noise).float())
    y, s_last = _emulate_bf16_kernel(*_args(t), t["s0"])
    py, ps = wkv6_plain(*_args(t), t["s0"])
    assert _rel(y, py) < BOUND
    assert _rel(s_last, ps) < BOUND


def test_bf16_kernel_emulation_needs_the_splits():
    """The check above has teeth: with every decayed operand rounded to bf16
    once (no lo half) the same arithmetic misses the bound."""
    _, t = _inputs(11, 2, 300, 2, 64, "bfloat16", s0=True)
    y, s_last = _emulate_bf16_kernel(*_args(t), t["s0"], split=_no_lo)
    py, ps = wkv6_plain(*_args(t), t["s0"])
    assert max(_rel(y, py), _rel(s_last, ps)) > 10 * BOUND


def _views(dtype, extra=0, offset=0, B=2, S=5, H=2, hd=64):
    """r, k, v, logw as (B,S,H,hd) views of (B, S, H*hd + extra) buffers that
    start `offset` elements in, as time_mix's matmul outputs are."""
    def one(dt):
        buf = torch.zeros(B * S * (H * hd + extra) + offset, dtype=dt)
        return buf[offset:].view(B, S, H * hd + extra)[..., :H * hd].view(B, S, H, hd)
    return one(dtype), one(dtype), one(dtype), one(torch.float32)


@pytest.mark.parametrize("case", ["storage_offset", "row_stride", "logw_row_stride",
                                  "float32_any_stride", "model_views"])
def test_check_bf16_alignment(case):
    """The bf16 kernel copies 16 bytes at a time: _check raises on views it
    cannot copy so (naming the tensor and the stride) and never copies;
    float32 r, k, v take any stride, and time_mix's views pass."""
    u = torch.zeros((2, 64))
    if case == "storage_offset":
        r, k, v, logw = _views(torch.bfloat16, offset=1)
        with pytest.raises(ValueError, match="r: data must be 16-byte aligned"):
            _check(r, k, v, logw, u, None)
    elif case == "row_stride":
        r, k, v, logw = _views(torch.bfloat16, extra=4)
        with pytest.raises(ValueError, match="r: batch stride .* not a multiple of 8"):
            _check(r, k, v, logw, u, None)
        r1 = r[:1]
        with pytest.raises(ValueError, match="r: time stride 132 is not a multiple of 8"):
            _check(r1, k[:1], v[:1], logw[:1].contiguous(), u, None)
    elif case == "logw_row_stride":
        r, k, v, _ = _views(torch.bfloat16)
        logw = _views(torch.float32, extra=2)[3]
        with pytest.raises(ValueError, match="logw: batch stride .* multiple of 4"):
            _check(r, k, v, logw, u, None)
    elif case == "float32_any_stride":
        r, k, v, _ = _views(torch.float32, extra=3, offset=1)
        _check(r, k, v, _views(torch.float32, extra=1, offset=3)[3], u, None)
    else:
        _check(*_views(torch.bfloat16), u, torch.zeros((2, 2, 64, 64)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,hd,s0", [
    (2, 512, 8, 64, False),
    (2, 300, 8, 64, True),          # ragged, with an initial state
    (4, 1, 8, 64, True),            # one decode step
    (2, 77, 4, 64, True),
    (3, 40, 2, 64, False),
    (2, 16, 4, 64, True),           # one sub-chunk
    (2, 31, 4, 64, True),           # one ragged chunk
    (2, 33, 4, 64, True),           # a chunk and one row
    (2, 4096, 4, 64, True),         # 128 chunks of state updates
    (1, 512, 32, 64, True),         # batch 1
])
def test_kernel_matches_plain_on_card(B, S, H, hd, s0, dtype, cuda_device):
    _, t = _inputs(8, B, S, H, hd, dtype, s0=s0)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    launches = wkv6_fwd.launches
    y, s_last = wkv6_fwd(*_args(t), t.get("s0"))
    torch.cuda.synchronize()
    assert wkv6_fwd.launches == launches + 1
    py, ps = wkv6_plain(*_args(t), t.get("s0"))
    assert y.dtype == torch.float32
    assert _rel(y, py) <= BOUND
    assert _rel(s_last, ps) <= BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_decode_steps_equal_one_launch_on_card(dtype, cuda_device):
    """One prefill launch, then 8 S = 1 launches (the decode kernel) chained
    through S_last, equal one launch over the concatenation."""
    _, t = _inputs(13, 2, 72, 8, 64, dtype, s0=True)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    y, s = wkv6_fwd(*_args(t), t["s0"])
    yp, state = wkv6_fwd(*(a[:, :64] for a in _args(t)[:4]), t["u"], t["s0"])
    ys = [yp]
    for i in range(64, 72):
        yi, state = wkv6_fwd(*(a[:, i:i + 1] for a in _args(t)[:4]), t["u"], state)
        ys.append(yi)
    torch.cuda.synchronize()
    assert _rel(torch.cat(ys, 1), y) <= BOUND
    assert _rel(state, s) <= BOUND
