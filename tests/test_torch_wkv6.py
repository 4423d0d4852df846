"""The port's WKV6 against the JAX package.

``wkv6_plain`` (the kernel's plain version, which the CPU path runs) is
held to the Pallas kernel in interpret mode (zero initial state, chunks that
divide S: all it takes), to ``repro.kernels.ref.wkv6_ref``, and to the model
path ``repro.models.rwkv6.wkv_chunked`` with a nonzero s0, whose S_last it
must match too, with r, k, v in bf16 as the model passes them; it is causal
(the prefix property) and takes ragged S and S = 1 (a decode step).  Bound:
max|Δ| / max|reference| below 2e-5 (tests/test_kernels.py; y and the state
are f32 whatever the input dtype).  The kernel itself is held to the plain
version on the card (``gpu`` marker) at the same bound.
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
from repro.models import rwkv6 as jrwkv6
from repro_torch import configs
from repro_torch.kernels import ref as tref
from repro_torch.kernels.wkv6 import wkv6_fwd, wkv6_plain
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,hd,s0", [
    (2, 512, 8, 64, False),
    (2, 300, 8, 64, True),          # ragged, with an initial state
    (4, 1, 8, 64, True),            # one decode step
    (2, 77, 4, 64, True),
    (3, 40, 2, 64, False),
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
