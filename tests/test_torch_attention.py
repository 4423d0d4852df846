"""The port's attention against the JAX package.

``flash_attention_plain`` (the kernel's plain version, which the CPU path
runs) is held to the Pallas kernel in interpret mode on the Sq == Sk sweep
and windows of tests/test_kernels.py, and to ``repro.kernels.ref`` for
Sq < Sk and ragged lengths, which the Pallas kernel does not take; its lse
is held to a logsumexp of the reference scores, at head dim 96 and
non-causal with Sq != Sk (cross-attention) too.  Tolerances are those of
tests/test_kernels.py: f32 2e-4, bf16 3e-2.  The kernel itself is held to
the plain version on the card (``gpu`` marker): o per row (max|Δ| of a row
over max|plain| of that row) at those bounds, and lse, f32 on both sides,
at 2e-4 absolute for every input dtype.  The bfloat16 kernel's input rules
(16-byte-aligned data, strides in multiples of 8) are checked on the CPU.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (
    _check,
    _check_bwd,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_plain,
)
from repro_torch.models import attention as tattn

TOL = {"float32": dict(atol=2e-4, rtol=2e-4), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, B, Sq, Sk, Hq, Hkv, d, dtype, dv=None):
    """Same values for both frameworks: f32 numpy draws rounded to dtype; v
    is ``dv`` wide (d by default)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, s).astype(np.float32)
            for s in ((B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, dv or d))]
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _lse_ref(q, k, causal, window):
    """logsumexp over keys of the masked reference scores, (B,Hq,Sq)."""
    q, k = _f32(q), _f32(k)
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kk = np.repeat(k, Hq // Hkv, axis=2)
    s = np.einsum("bqhd,bshd->bhqs", q, kk) / math.sqrt(d)
    qpos = (Sk - Sq) + np.arange(Sq)
    kpos = np.arange(Sk)
    m = np.ones((Sq, Sk), bool)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= qpos[:, None] - kpos[None, :] < window
    s = np.where(m, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    return (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,Hq,Hkv,d,bq,bk", [
    (128, 4, 4, 64, 64, 64),      # MHA
    (128, 4, 1, 32, 32, 64),      # MQA, uneven blocks
    (256, 8, 2, 64, 128, 128),    # GQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_sweep(S, Hq, Hkv, d, bq, bk, causal, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(0, 2, S, S, Hq, Hkv, d, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                                interpret=True)
    o, lse = flash_attention_plain(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert o.dtype == q.dtype and o.shape == q.shape
    np.testing.assert_allclose(_f32(o), _f32(want), **TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, causal, 0), **TOL[dtype])


@pytest.mark.parametrize("window", [32, 96])
def test_plain_matches_pallas_window(window):
    (jq, jk, jv), (q, k, v) = _inputs(1, 1, 256, 256, 4, 2, 32, "float32")
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                block_q=64, block_k=64, interpret=True)
    o, lse = flash_attention_plain(q, k, v, causal=True, window=window,
                                   block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(o), _f32(want), **TOL["float32"])
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, True, window),
                               **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,window,causal", [
    (32, 160, 0, True),           # Sq < Sk: chunked prefill against a longer cache
    (48, 200, 64, True),          # Sq < Sk with a window
    (100, 100, 0, True),          # ragged S: blocks do not divide it
    (77, 77, 20, True),           # ragged S with a window
    (60, 90, 0, False),           # ragged, bidirectional
])
def test_plain_matches_ref_offset_and_ragged(Sq, Sk, window, causal, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(2, 2, Sq, Sk, 4, 2, 16, dtype)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    o, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                   block_q=32, block_k=32)
    np.testing.assert_allclose(_f32(o), _f32(want), **TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, causal, window),
                               **TOL[dtype])
    mine = tref.attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_f32(mine), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,d,causal", [
    (150, 150, 96, True),         # phi-3-vision's head dim, ragged
    (40, 90, 96, True),           # d 96, Sq < Sk
    (40, 130, 64, False),         # non-causal Sq < Sk: cross-attention, prompt < frames
    (150, 70, 64, False),         # non-causal Sq > Sk: a prompt longer than the frames
    (70, 70, 96, False),          # the encoder's bidirectional self-attention at d 96
])
def test_plain_matches_ref_d96_and_noncausal(Sq, Sk, d, causal, dtype):
    """The plain version at head dim 96 and non-causal with Sq != Sk (the
    encoder-decoder's cross-attention) against repro.kernels.ref."""
    (jq, jk, jv), (q, k, v) = _inputs(9, 2, Sq, Sk, 4, 2, d, dtype)
    want = jref.attention_ref(jq, jk, jv, causal=causal)
    o, lse = flash_attention_plain(q, k, v, causal=causal, block_q=32, block_k=64)
    assert o.shape == (2, Sq, 4, d)
    np.testing.assert_allclose(_f32(o), _f32(want), **TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, causal, 0), **TOL[dtype])


def test_noncausal_attention_matches_jax_model_path():
    """models.attention non-causal with Sq != Sk on the CPU equals the
    reference's model-path attention (its cross-attention call)."""
    (jq, jk, jv), (q, k, v) = _inputs(10, 2, 48, 80, 4, 4, 16, "float32")
    want = jattn.attention(jq, jk, jv, causal=False, chunk_q=16, chunk_k=32)
    got = tattn.attention(q, k, v, causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_refuses_d96_naming_a18b(dtype):
    """The forward takes d 96; the backward does not (ROADMAP A18b): its
    check raises before any launch, where the kernel's switch has no case."""
    _, (q, k, v) = _inputs(11, 1, 8, 8, 2, 2, 96, dtype)
    o, lse = flash_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="d 96, dv 96.*ROADMAP A18b"):
        _check_bwd(q, k, v, o, lse, torch.ones_like(o))
    _, (q, k, v) = _inputs(11, 1, 8, 8, 2, 2, 64, dtype)
    o, lse = flash_attention_plain(q, k, v)
    _check_bwd(q, k, v, o, lse, torch.ones_like(o))


def test_attention_matches_jax_model_path():
    """models.attention on the CPU equals the reference's model-path attention."""
    (jq, jk, jv), (q, k, v) = _inputs(3, 2, 64, 64, 4, 1, 16, "float32")
    want = jattn.attention(jq, jk, jv, causal=True, chunk_q=16, chunk_k=32, window=24)
    got = tattn.attention(q, k, v, causal=True, window=24)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,length", [(4, 4, 9), (4, 1, 16), (8, 2, 1)])
def test_decode_attention_matches_jax(Hq, Hkv, length, dtype):
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (2, Hq, 32)).astype(np.float32)
    kc = rng.normal(0, 1, (2, 16, Hkv, 32)).astype(np.float32)
    vc = rng.normal(0, 1, (2, 16, Hkv, 32)).astype(np.float32)
    want = jattn.decode_attention(*(jnp.asarray(a, JDT[dtype]) for a in (q, kc, vc)),
                                  jnp.asarray(length))
    got = tattn.decode_attention(
        *(torch.from_numpy(a).to(TDT[dtype]) for a in (q, kc, vc)), length)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def test_wrapper_dispatches_by_device():
    _, (q, k, v) = _inputs(5, 1, 8, 8, 2, 2, 64, "float32")
    launches, calls = flash_attention_fwd.launches, flash_attention_plain.calls
    flash_attention_fwd(q, k, v)
    assert flash_attention_plain.calls == calls + 1
    assert flash_attention_fwd.launches == launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))


def _bf16(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["storage_offset", "row_stride", "packed_views",
                                  "float32_any_stride"])
def test_check_bf16_alignment(case):
    """The bf16 kernel copies 16 bytes at a time: _check raises on a view it
    cannot read that way, naming the tensor and the stride, and takes the
    aligned strided views the model path and a packed qkv buffer give."""
    B, S, H, d = 2, 8, 2, 64
    q, k, v = (_bf16((B, S, H, d), i) for i in range(3))
    _check(q, k, v)
    if case == "storage_offset":
        bad = _bf16((B * S * H * d + 1,), 3)[1:].view(B, S, H, d)
        assert bad.storage_offset() == 1
        with pytest.raises(ValueError, match="q: bfloat16 data must be 16-byte aligned"):
            _check(bad, k, v)
    elif case == "row_stride":
        bad = _bf16((B, S, H * d + 4), 3)[..., :H * d].unflatten(-1, (H, d))
        assert bad.stride(1) == H * d + 4
        with pytest.raises(ValueError, match=f"k: row stride {H * d + 4} is not a "
                                             "multiple of 8"):
            _check(q, bad, v)
    elif case == "packed_views":
        packed = _bf16((B, S, 3, H, d), 3)
        _check(packed[:, :, 0], packed[:, :, 1], packed[:, :, 2])
    else:
        buf = _bf16((B, S, H * d + 3), 3).float()
        odd = buf[..., 1:H * d + 1].unflatten(-1, (H, d))
        assert odd.storage_offset() == 1 and odd.stride(1) == H * d + 3
        _check(odd, odd, odd)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,d,causal,window,packed", [
    (2, 256, 256, 8, 8, 128, True, 0, False),
    (1, 200, 200, 8, 1, 256, True, 0, False),
    (2, 96, 1000, 5, 5, 64, True, 0, False),
    (1, 700, 700, 6, 2, 128, True, 128, False),
    (2, 333, 333, 4, 4, 112, True, 0, False),    # zamba2's head dim
    (2, 17, 17, 4, 2, 128, True, 0, False),      # S inside one tile
    (2, 65, 65, 4, 2, 128, True, 0, False),      # one row past a tile edge
    (2, 1, 300, 8, 2, 128, True, 0, False),      # Sq = 1 against Sk = 300
    (1, 256, 256, 64, 8, 128, True, 0, False),   # GQA 64:8 (qwen2-72b)
    (2, 200, 200, 8, 8, 128, True, 0, True),     # views of one packed (B,S,3,H,d)
    (2, 100, 400, 4, 4, 128, True, 128, False),  # window 128 with Sq < Sk
    (2, 60, 90, 4, 2, 64, False, 0, False),      # bidirectional, ragged
    (2, 130, 190, 4, 2, 64, True, 0, False),     # each head dim, Sq < Sk, ragged
    (2, 130, 190, 4, 2, 112, True, 0, False),
    (2, 130, 190, 4, 2, 128, True, 0, False),
    (2, 130, 190, 4, 2, 256, True, 0, False),
    (2, 130, 190, 4, 2, 96, True, 0, False),     # phi-3-vision's head dim
    (1, 300, 300, 8, 8, 96, True, 0, False),     # d 96, ragged
    (2, 200, 200, 4, 4, 96, False, 0, False),    # d 96, bidirectional
    (2, 128, 256, 4, 4, 64, False, 0, False),    # cross-attention: Sq < Sk, non-causal
    (2, 300, 100, 4, 4, 64, False, 0, False),    # non-causal Sq > Sk
    (2, 77, 130, 4, 2, 96, False, 0, False),     # non-causal Sq < Sk at d 96, ragged
])
def test_kernel_matches_plain_on_card(B, Sq, Sk, Hq, Hkv, d, causal, window, packed,
                                      dtype, cuda_device):
    _, (q, k, v) = _inputs(6, B, Sq, Sk, Hq, Hkv, d, dtype)
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    if packed:
        buf = torch.stack((q, k, v), dim=2)          # (B, S, 3, H, d)
        q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
        assert not q.is_contiguous()
    launches = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == launches + 1
    po, plse = flash_attention_plain(q, k, v, causal=causal, window=window)
    o, po = _f32(o.cpu()), _f32(po.cpu())
    row_rel = np.abs(o - po).max(-1) / np.abs(po).max(-1)
    assert row_rel.max() <= TOL[dtype]["rtol"], row_rel.max()
    np.testing.assert_allclose(lse.cpu().numpy(), plse.cpu().numpy(), atol=2e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,v_view", [
    (2, 256, 256, 8, 8, True, True),      # deepseek-v3 MLA prefill, v a view of (k_nope, v)
    (2, 300, 300, 8, 8, True, False),     # ragged S
    (2, 100, 400, 4, 4, True, True),      # Sq < Sk
    (2, 1, 300, 8, 8, True, False),       # Sq = 1 against Sk = 300
    (2, 17, 17, 4, 2, True, False),       # S inside one tile, GQA
    (2, 60, 90, 4, 4, False, False),      # bidirectional, ragged
])
def test_kernel_at_192_128_matches_plain_on_card(B, Sq, Sk, Hq, Hkv, causal, v_view, dtype,
                                                 cuda_device):
    """The d 192 / dv 128 instantiation (MLA prefill) against the plain version,
    at the bounds of test_kernel_matches_plain_on_card."""
    _, (q, k, v) = _inputs(8, B, Sq, Sk, Hq, Hkv, 192, dtype, dv=128)
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    if v_view:                # as MLA hands it over: v = kv[..., 128:] of (B, S, H, 256)
        v = torch.cat((torch.zeros_like(v), v), dim=-1)[..., 128:]
        assert not v.is_contiguous()
    scale = 1.0 / math.sqrt(192)
    launches = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == launches + 1 and o.shape == (B, Sq, Hq, 128)
    po, plse = flash_attention_plain(q, k, v, causal=causal, scale=scale)
    o, po = _f32(o.cpu()), _f32(po.cpu())
    row_rel = np.abs(o - po).max(-1) / np.abs(po).max(-1)
    assert row_rel.max() <= TOL[dtype]["rtol"], row_rel.max()
    np.testing.assert_allclose(lse.cpu().numpy(), plse.cpu().numpy(), atol=2e-4, rtol=0)


@pytest.mark.gpu
def test_backward_on_card_refuses_d96(cuda_device):
    """A d-96 backward on the card raises naming ROADMAP A18b and launches nothing."""
    _, (q, k, v) = _inputs(12, 1, 64, 64, 2, 2, 96, "bfloat16")
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    o, lse = flash_attention_fwd(q, k, v)
    launches = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="ROADMAP A18b"):
        flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o))
    assert flash_attention_bwd.launches == launches
