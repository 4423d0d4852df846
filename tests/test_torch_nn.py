"""The port's nn primitives against ``repro.models.nn`` in f32 at 1e-5, on
the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import nn as jnn
from repro_torch.models import nn as tnn

TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(*arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays])


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 48)])
def test_rmsnorm(shape):
    rng = _rng()
    x = rng.normal(0, 2, shape).astype(np.float32)
    g = rng.normal(0, 0.5, shape[-1:]).astype(np.float32)
    (jx, jg), (tx, tg) = _pair(x, g)
    np.testing.assert_allclose(tnn.rmsnorm(tx, tg, 1e-5).numpy(),
                               np.asarray(jnn.rmsnorm(jx, jg, 1e-5)), **TOL)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 48)])
def test_layernorm(shape):
    rng = _rng(5)
    x = rng.normal(1, 2, shape).astype(np.float32)
    g = rng.normal(1, 0.5, shape[-1:]).astype(np.float32)
    b = rng.normal(0, 0.5, shape[-1:]).astype(np.float32)
    (jx, jg, jb), (tx, tg, tb) = _pair(x, g, b)
    np.testing.assert_allclose(tnn.layernorm(tx, tg, tb, 1e-5).numpy(),
                               np.asarray(jnn.layernorm(jx, jg, jb, 1e-5)), **TOL)


def test_layernorm_keeps_bf16_with_f32_gains():
    x = torch.from_numpy(_rng().normal(0, 1, (4, 32)).astype(np.float32)).bfloat16()
    out = tnn.layernorm(x, torch.ones(32), torch.zeros(32))
    assert out.dtype == torch.bfloat16


def test_rmsnorm_keeps_bf16():
    x = torch.from_numpy(_rng().normal(0, 1, (4, 32)).astype(np.float32)).bfloat16()
    assert tnn.rmsnorm(x, torch.zeros(32, dtype=torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_act_fn(name):
    x = _rng(1).normal(0, 3, (1000,)).astype(np.float32)
    (jx,), (tx,) = _pair(x)
    np.testing.assert_allclose(tnn.act_fn(name)(tx).numpy(),
                               np.asarray(jnn.act_fn(name)(jx)), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_ffn(act):
    rng = _rng(2)
    d, f = 32, 48
    in_w = 2 * f if act in ("swiglu", "geglu") else f
    x = rng.normal(0, 1, (2, 7, d)).astype(np.float32)
    wi = (rng.normal(0, 1, (d, in_w)) / np.sqrt(d)).astype(np.float32)
    wo = (rng.normal(0, 1, (f, d)) / np.sqrt(f)).astype(np.float32)
    (jx, jwi, jwo), (tx, twi, two) = _pair(x, wi, wo)
    want = jnn.ffn_apply({"wi": jwi, "wo": jwo}, jx, act)
    np.testing.assert_allclose(tnn.ffn_apply(twi, two, tx, act).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [1e4, 1e5])
@pytest.mark.parametrize("pos_shape", ["batched", "shared"])
def test_rope(theta, pos_shape):
    rng = _rng(3)
    x = rng.normal(0, 1, (2, 9, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 500, (2, 9)) if pos_shape == "batched"
           else np.arange(9) + 40).astype(np.int32)
    (jx, jp), (tx, tp) = _pair(x, pos)
    np.testing.assert_allclose(tnn.apply_rope(tx, tp.long(), theta).numpy(),
                               np.asarray(jnn.apply_rope(jx, jp, theta)), **TOL)
    np.testing.assert_allclose(tnn.rope_freqs(16, theta).numpy(),
                               np.asarray(jnn.rope_freqs(16, theta)), **TOL)


def test_embed_lookup():
    rng = _rng(4)
    emb = rng.normal(0, 1, (50, 8)).astype(np.float32)
    tok = rng.integers(0, 50, (3, 6)).astype(np.int64)
    np.testing.assert_array_equal(
        tnn.embed_lookup(torch.from_numpy(emb), torch.from_numpy(tok)).numpy(),
        np.asarray(jnn.embed_lookup(jnp.asarray(emb), jnp.asarray(tok))))


def test_dtype_of():
    for name in ("bfloat16", "float32", "float16"):
        assert str(tnn.dtype_of(name)) == f"torch.{name}"


def _rmsnorm_autograd(x, gamma, eps=1e-5):
    """The same arithmetic as plain ops, differentiated by autograd."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def test_rmsnorm_backward_gradcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 16, dtype=torch.float64, generator=gen, requires_grad=True)
    g = (0.3 * torch.randn(16, dtype=torch.float64, generator=gen)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: tnn.rmsnorm(a, b, 1e-5), (x, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_matches_autograd(dtype):
    """The hand-written backward against autograd of the same ops: f32 at
    1e-6 (relative to each gradient's largest element); bf16 within one
    bf16 step of autograd's bf16 gradient (both round one f32 value)."""
    gen = torch.Generator().manual_seed(1)
    x0 = (2 * torch.randn(2, 7, 64, generator=gen)).to(dtype)
    g0 = (0.5 * torch.randn(64, generator=gen)).to(dtype)
    dy = torch.randn(2, 7, 64, generator=gen).to(dtype)
    grads = []
    for fn in (tnn.rmsnorm, _rmsnorm_autograd):
        x, g = x0.clone().requires_grad_(), g0.clone().requires_grad_()
        y = fn(x, g, 1e-5)
        y.backward(dy)
        grads.append((y.detach(), x.grad, g.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype == dtype
        if dtype == torch.float32:
            scale = want.abs().max()
            assert ((got - want).abs().max() / scale).item() < 1e-6
        else:
            step = torch.finfo(torch.bfloat16).eps * want.float().abs().clamp_min(1e-30)
            assert bool(((got.float() - want.float()).abs() <= step).all())


def _layernorm_autograd(x, gamma, beta, eps=1e-5):
    """The same arithmetic as plain ops, differentiated by autograd."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(xf.var(dim=-1, unbiased=False, keepdim=True) + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def test_layernorm_backward_gradcheck():
    gen = torch.Generator().manual_seed(2)
    x = (1 + torch.randn(3, 4, 16, dtype=torch.float64, generator=gen)).requires_grad_()
    g = (1 + 0.3 * torch.randn(16, dtype=torch.float64, generator=gen)).requires_grad_()
    b = (0.3 * torch.randn(16, dtype=torch.float64, generator=gen)).requires_grad_()
    assert torch.autograd.gradcheck(lambda *a: tnn.layernorm(*a, 1e-5), (x, g, b))


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 48)])
def test_layernorm_value_and_grads_match_jax(shape):
    """Value and the gradients of x, gamma and beta against jax.vjp of the
    reference's layernorm, f32 at the module's 1e-5."""
    import jax

    rng = _rng(6)
    x = rng.normal(1, 2, shape).astype(np.float32)
    g = rng.normal(1, 0.5, shape[-1:]).astype(np.float32)
    b = rng.normal(0, 0.5, shape[-1:]).astype(np.float32)
    dy = rng.normal(0, 1, shape).astype(np.float32)
    (jx, jg, jb, jdy), (tx, tg, tb, tdy) = _pair(x, g, b, dy)
    want, vjp = jax.vjp(lambda *a: jnn.layernorm(*a, 1e-5), jx, jg, jb)
    tx, tg, tb = (t.requires_grad_() for t in (tx, tg, tb))
    got = tnn.layernorm(tx, tg, tb, 1e-5)
    got.backward(tdy)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, w in zip((tx, tg, tb), vjp(jdy)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5 * np.abs(w).max(),
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_backward_matches_autograd(dtype):
    """The hand-written backward against autograd of the same ops, bf16 x
    beside f32 gains as in rwkv6: f32 at 1e-6 (relative to each gradient's
    largest element); bf16 x's gradient within one bf16 step of autograd's
    (both round one f32 value)."""
    gen = torch.Generator().manual_seed(3)
    x0 = (1 + 2 * torch.randn(2, 7, 64, generator=gen)).to(dtype)
    g0 = 1 + 0.5 * torch.randn(64, generator=gen)
    b0 = 0.5 * torch.randn(64, generator=gen)
    dy = torch.randn(2, 7, 64, generator=gen).to(dtype)
    grads = []
    for fn in (tnn.layernorm, _layernorm_autograd):
        x, g, b = (t.clone().requires_grad_() for t in (x0, g0, b0))
        y = fn(x, g, b, 1e-5)
        y.backward(dy)
        grads.append((y.detach(), x.grad, g.grad, b.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        if got.dtype == torch.float32:
            scale = want.abs().max()
            assert ((got - want).abs().max() / scale).item() < 1e-6
        else:
            step = torch.finfo(torch.bfloat16).eps * want.float().abs().clamp_min(1e-30)
            assert bool(((got.float() - want.float()).abs() <= step).all())


def test_layernorm_saves_no_f32_copy_of_x():
    """What the backward keeps: x itself and two f32 values a row."""
    x = torch.randn(4, 8, 64, dtype=torch.bfloat16, requires_grad=True)
    g, b = torch.ones(64, requires_grad=True), torch.zeros(64, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        tnn.layernorm(x, g, b)
    big = [t for t in saved if t.numel() == x.numel()]
    assert len(big) == 1 and big[0].dtype == torch.bfloat16
    assert sum(t.numel() for t in saved if t.numel() != x.numel() and t.dim() == 3) == 2 * 32
