"""The port's SSD scan against the JAX package.

``ssd_scan_plain`` (the kernel's plain version, which the CPU path runs) is
held to the Pallas kernel in interpret mode (zero initial state, chunks that
divide S: all it takes), to ``repro.kernels.ref.ssd_ref``, and to the model
path ``repro.models.mamba2.ssd_chunked`` with a nonzero h0, whose h_last it
must match too; it is causal (the prefix property) and takes ragged S.
Bounds are those of tests/test_kernels.py: max|Δ| / max|reference| below
2e-5 in f32 and 3e-2 in bf16 (the bf16 output is rounded on both sides).
The kernel itself is held to the plain version on the card (``gpu``
marker) at the same bounds, states at 2e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jmamba2
from repro_torch import configs
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import _check, ssd_scan_fwd, ssd_scan_plain
from repro_torch.models import mamba2 as tmamba2

BOUND = {"float32": 2e-5, "bfloat16": 3e-2}
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


def _inputs(seed, B, S, H, P, N, dtype, h0=False):
    """Same values for both frameworks: x, B, C in ``dtype``; dt, A, h0 f32
    (the distributions of tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    arrs = {
        "x": rng.normal(0, 1, (B, S, H, P)).astype(np.float32),
        "dt": rng.uniform(0.05, 1.0, (B, S, H)).astype(np.float32),
        "A": -rng.uniform(0.3, 2.0, (H,)).astype(np.float32),
        "B_": rng.normal(0, 1, (B, S, N)).astype(np.float32),
        "C": rng.normal(0, 1, (B, S, N)).astype(np.float32),
    }
    if h0:
        arrs["h0"] = rng.normal(0, 1, (B, H, P, N)).astype(np.float32)
    low = ("x", "B_", "C")
    jx = {k: jnp.asarray(a, JDT[dtype] if k in low else jnp.float32) for k, a in arrs.items()}
    tx = {k: torch.from_numpy(a).to(TDT[dtype] if k in low else torch.float32)
          for k, a in arrs.items()}
    return jx, tx


def _args(d):
    return d["x"], d["dt"], d["A"], d["B_"], d["C"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,P,N,chunk", [
    (64, 2, 16, 8, 16),
    (128, 3, 32, 16, 32),
    (128, 1, 64, 64, 64),
])
def test_plain_matches_pallas_and_ref(S, H, P, N, chunk, dtype):
    j, t = _inputs(2, 2, S, H, P, N, dtype)
    want = jops.ssd_scan(*_args(j), chunk=chunk, interpret=True)
    y, h_last = ssd_scan_plain(*_args(t), chunk=chunk)
    assert y.dtype == TDT[dtype] and y.shape == (2, S, H, P)
    assert h_last.dtype == torch.float32 and h_last.shape == (2, H, P, N)
    assert _rel(y, want) < BOUND[dtype]
    oracle = jref.ssd_ref(*(a.astype(jnp.float32) for a in _args(j)))
    assert _rel(y, oracle) < BOUND[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref(dtype):
    j, t = _inputs(3, 2, 40, 3, 16, 8, dtype)
    want = jref.ssd_ref(*_args(j))
    got = tref.ssd_ref(*_args(t))
    assert got.dtype == torch.float32
    assert _rel(got, want) < 2e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,jchunk", [
    (64, 16, 16),      # chunks divide S
    (50, 16, 50),      # ragged: the port pads its last chunk, the model path takes one chunk of S
    (7, 16, 7),        # shorter than a chunk
])
def test_plain_matches_model_path_with_h0(S, chunk, jchunk, dtype):
    j, t = _inputs(4, 2, S, 3, 16, 8, dtype, h0=True)
    want_y, want_h = jmamba2.ssd_chunked(*_args(j), jchunk, h0=j["h0"])
    y, h_last = ssd_scan_plain(*_args(t), t["h0"], chunk=chunk)
    assert _rel(y, want_y) < BOUND[dtype]
    assert _rel(h_last, want_h) < 2e-5


def test_ragged_equals_padded_with_zero_steps():
    """Padding with dt = 0 and x = B = C = 0 leaves y and the state as they
    are: a ragged scan equals the head of the scan of the padded input."""
    _, t = _inputs(5, 1, 37, 2, 16, 8, "float32", h0=True)
    y, h = ssd_scan_plain(*_args(t), t["h0"], chunk=16)
    padded = {k: torch.nn.functional.pad(v, (0, 0) * (v.ndim - 2) + (0, 11))
              for k, v in t.items() if k in ("x", "dt", "B_", "C")}
    padded["A"] = t["A"]
    y2, h2 = ssd_scan_plain(*_args(padded), t["h0"], chunk=16)
    np.testing.assert_allclose(y.numpy(), y2[:, :37].numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(h.numpy(), h2.numpy(), atol=1e-6, rtol=1e-6)


def test_chained_scans_equal_one_scan():
    """h_last carries the scan: two halves chained through h0 equal one scan."""
    _, t = _inputs(6, 2, 96, 2, 16, 8, "float32")
    y, h = ssd_scan_plain(*_args(t), chunk=32)
    first = {k: v[:, :40] if v.ndim > 1 else v for k, v in t.items()}
    second = {k: v[:, 40:] if v.ndim > 1 else v for k, v in t.items()}
    y1, h1 = ssd_scan_plain(*_args(first), chunk=32)
    y2, h2 = ssd_scan_plain(*_args(second), h1, chunk=32)
    assert _rel(torch.cat([y1, y2], 1), y) < 2e-5
    assert _rel(h2, h) < 2e-5


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_plain_prefix_property(seed):
    """Causality: the output at t depends only on inputs at times <= t."""
    _, t = _inputs(seed, 1, 64, 2, 8, 8, "float32")
    full, _ = ssd_scan_plain(*_args(t), chunk=16)
    half, _ = ssd_scan_plain(*(a[:, :32] if a.ndim > 1 else a for a in _args(t)), chunk=16)
    np.testing.assert_allclose(full[:, :32].numpy(), half.numpy(), atol=1e-4, rtol=1e-4)


def _mamba2_pair(dtype):
    """One Mamba-2 block of reduced zamba2, initialised by JAX, in both."""
    jcfg = jconfigs.get_reduced("zamba2-7b").with_(dtype=dtype)
    tcfg = configs.get_reduced("zamba2-7b").with_(dtype=dtype)
    jp = jax.tree.map(lambda a: a[0], jmamba2.mamba2_init(jax.random.PRNGKey(1), jcfg, 1,
                                                          JDT[dtype]))
    tp = tmamba2.Mamba2(tcfg, "cpu", TDT[dtype])
    tp.load_state_dict({k: torch.tensor(_f32(v)).to(getattr(tp, k).dtype)
                        for k, v in jp.items()})
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_jax(dtype):
    """mamba2_apply (scan through the kernel wrapper) from a nonzero state,
    its returned carry, then decode steps from that carry."""
    jcfg, jp, tcfg, tp = _mamba2_pair(dtype)
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (2, 24, tcfg.d_model)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (2, tmamba2.n_ssm_heads(tcfg), tcfg.ssm_head_dim,
                             tcfg.ssm_state)).astype(np.float32)
    tol = 1e-4 if dtype == "float32" else BOUND[dtype]
    jout, jst = jmamba2.mamba2_apply(jp, jnp.asarray(x, JDT[dtype]), jcfg,
                                     state={"ssm": jnp.asarray(h0)}, return_state=True)
    tout, tst = tmamba2.mamba2_apply(tp, torch.from_numpy(x).to(TDT[dtype]), tcfg,
                                     state={"ssm": torch.from_numpy(h0)}, return_state=True)
    assert tout.dtype == TDT[dtype] and tst["ssm"].dtype == torch.float32
    assert _rel(tout, jout) < tol
    assert _rel(tst["ssm"], jst["ssm"]) < tol
    assert _rel(tst["conv"], jst["conv"]) < 1e-6
    jst = {"conv": jst["conv"], "ssm": jst["ssm"].astype(jnp.float32)}
    for t in range(3):
        xt = rng.normal(0, 1, (2, 1, tcfg.d_model)).astype(np.float32)
        jout, jst = jmamba2.mamba2_decode_step(jp, jnp.asarray(xt, JDT[dtype]), jst, jcfg)
        tout, tst = tmamba2.mamba2_decode_step(tp, torch.from_numpy(xt).to(TDT[dtype]),
                                               tst, tcfg)
        assert tout.dtype == TDT[dtype] and tst["ssm"].dtype == torch.float32
        assert _rel(tout, jout) < tol
        assert _rel(tst["ssm"], jst["ssm"]) < tol


def test_wrapper_dispatches_by_device():
    _, t = _inputs(7, 1, 8, 2, 64, 64, "float32")
    launches, calls = ssd_scan_fwd.launches, ssd_scan_plain.calls
    ssd_scan_fwd(*_args(t))
    assert ssd_scan_plain.calls == calls + 1
    assert ssd_scan_fwd.launches == launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd_scan_fwd(*(a.to("meta") for a in _args(t)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,h0", [
    (2, 512, 8, 64, 64, False),
    (2, 300, 8, 64, 64, True),       # ragged, with an initial state
    (1, 1000, 4, 64, 64, True),
    (2, 77, 5, 64, 64, False),
    (3, 1, 2, 64, 64, True),         # a single step
    (2, 63, 3, 64, 64, True),        # the chunk edges: one short chunk,
    (2, 64, 3, 64, 64, True),        # one whole chunk,
    (2, 65, 3, 64, 64, False),       # one row into a second chunk,
    (2, 128, 3, 64, 64, True),       # two whole chunks
    (1, 4096, 4, 64, 64, True),      # a long prompt from a state
])
def test_kernel_matches_plain_on_card(B, S, H, P, N, h0, dtype, cuda_device):
    _, t = _inputs(8, B, S, H, P, N, dtype, h0=h0)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    launches = ssd_scan_fwd.launches
    y, h_last = ssd_scan_fwd(*_args(t), t.get("h0"))
    torch.cuda.synchronize()
    assert ssd_scan_fwd.launches == launches + 1
    py, ph = ssd_scan_plain(*_args(t), t.get("h0"))
    assert y.dtype == py.dtype
    assert _rel(y, py) <= BOUND[dtype]
    assert _rel(h_last, ph) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,split", [(512, 200), (300, 64), (130, 65)])
def test_kernel_chained_through_h_last_on_card(S, split, dtype, cuda_device):
    """Two kernel calls chained through h_last -> h0 equal one call: y and
    h_last at the kernel-vs-plain limits."""
    _, t = _inputs(10, 2, S, 4, 64, 64, dtype, h0=True)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    first = {k: v[:, :split] if v.ndim > 1 and k != "h0" else v for k, v in t.items()}
    second = {k: v[:, split:] if v.ndim > 1 and k != "h0" else v for k, v in t.items()}
    y, h = ssd_scan_fwd(*_args(t), t["h0"])
    y1, h1 = ssd_scan_fwd(*_args(first), t["h0"])
    y2, h2 = ssd_scan_fwd(*_args(second), h1)
    torch.cuda.synchronize()
    assert _rel(torch.cat([y1, y2], 1), y) <= BOUND[dtype]
    assert _rel(h2, h) <= 2e-5


def _views(dtype, B=2, S=5, H=3, P=64, N=64, extra=0):
    """x, B_, C as views of one conv output (B,S,H*P + 2N + extra), the way
    mamba2_apply passes them, and dt, A."""
    conv = torch.zeros((B, S, H * P + 2 * N + extra), dtype=dtype)
    x = conv[..., :H * P].view(B, S, H, P)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:H * P + 2 * N]
    return x, torch.zeros((B, S, H)), -torch.ones(H), Bm, Cm


def _offset(t, by):
    """The same shape and strides as t, `by` elements further into a larger buffer."""
    buf = torch.zeros(t.untyped_storage().nbytes() // t.element_size() + by, dtype=t.dtype)
    return buf.as_strided(t.shape, t.stride(), by)


@pytest.mark.parametrize("case,match", [
    ("x_storage_offset", "x: bfloat16 data must be 16-byte aligned"),
    ("B_storage_offset", "B_: bfloat16 data must be 16-byte aligned"),
    ("time_stride", "x: time stride 324 is not a multiple of 8"),
    ("B_batch_stride", "B_: batch stride 364 is not a multiple of 8"),
    ("x_head_stride", "x: head stride 68 is not a multiple of 8"),
    ("h0_offset", "h0: data must be 8-byte aligned"),
])
def test_check_rejects_misaligned_bf16(case, match):
    """The bf16 kernel copies 16-byte rows: _check raises on a view it cannot
    take, naming the tensor and the stride, and copies nothing."""
    x, dt, A, Bm, Cm = _views(torch.bfloat16)
    h0 = None
    if case == "x_storage_offset":
        x = _offset(x, 4)
    elif case == "B_storage_offset":
        Bm = _offset(Bm, 1)
    elif case == "time_stride":
        x, dt, A, Bm, Cm = _views(torch.bfloat16, B=1, extra=4)   # batch stride unused
    elif case == "B_batch_stride":
        Bm = torch.zeros(1024, dtype=torch.bfloat16).as_strided((2, 5, 64), (364, 72, 1))
    elif case == "x_head_stride":
        x = torch.zeros(4096, dtype=torch.bfloat16).as_strided((2, 5, 3, 64), (1024, 200, 68, 1))
    elif case == "h0_offset":
        h0 = torch.zeros(2 * 3 * 64 * 64 + 1)[1:].view(2, 3, 64, 64)
    with pytest.raises(ValueError, match=match):
        _check(x, dt, A, Bm, Cm, h0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_check_takes_the_model_views(dtype):
    """mamba2_apply's views of the conv output qualify in both dtypes (row
    stride H·P + 2N, B and C at offsets H·P and H·P + N), with a state."""
    x, dt, A, Bm, Cm = _views(TDT[dtype])
    assert x.stride()[:3] == (5 * 320, 320, 64) and Bm.storage_offset() == 192
    _check(x, dt, A, Bm, Cm, torch.zeros((2, 3, 64, 64)))


def test_check_takes_any_float32_stride():
    """The f32 kernel reads element by element: misaligned views are fine."""
    x, dt, A, Bm, Cm = _views(torch.float32, extra=3)
    _check(_offset(x, 1), dt, A, _offset(Bm, 3), Cm, None)
