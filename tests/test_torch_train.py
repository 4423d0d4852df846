"""The port's training pieces against the JAX package, on the same inputs.

* The attention backward: the plain explicit-recompute version (and the
  ``FlashAttention`` autograd path through it) against ``jax.vjp`` of
  ``repro.models.attention.attention`` (dense schedule) and of
  ``repro.models.flash.flash_attention_hlo``, at f32 atol = rtol = 2e-4,
  the bound of tests/test_flash.py.
* One optimizer update (AdamW, Lion; f32 and bf16 moments; clip active)
  against ``repro.train.optimizer.opt_update``: rel 1e-6 in f32, within one
  bf16 ulp in bf16.
* ``Model.loss`` and every gradient against ``jax.value_and_grad`` of the
  JAX ``Model.loss`` on weights carried by ``repro_torch.convert``: f32
  loss rel 1e-4 and grads 2e-4; bf16 loss 3e-2 (the bf16 bound of
  tests/test_kernels.py) and grads 5e-2.  In bf16 the gradients of the
  attention projections carry the rounding of both frameworks: on these
  inputs JAX's own bf16 gradients lie up to 3.7e-2 (max|Δ| / max|f32|) from
  the f32 gradients of the same weights, and the port's up to 3.9e-2, so
  the two differ by up to 3.9e-2 without either being wrong.  The SSM
  families (zamba2-7b, rwkv6-1.6b) are noisier in bf16: JAX's own bf16
  gradients lie up to 1.1e-1 (zamba2, A_log) and 3.4e-1 (rwkv6) from the
  f32 gradients at the same weights, the port's up to 7.5e-2 and 4.5e-1,
  and the two frameworks' up to 1.9e-1 and 2.5e-1 from each other (eager
  torch rounds every op to bf16, where XLA fuses elementwise chains at
  higher precision: with --xla_allow_excess_precision=false JAX's rwkv6
  gradients lie as far from f32 as the port's).  So there each bf16
  gradient is held to JAX's at 5e-2 plus twice JAX's own distance from the
  f32 gradient of the same weights on that leaf.
* The MoE / MLA training path (moonshot-v1-16b-a3b, deepseek-v3-671b): the
  plain backward at d 192 / dv 128 (and ``FlashAttention`` through it)
  against ``jax.vjp`` of the reference's ``attention`` at MLA's scale
  1/sqrt(192), f32 2e-4; ``Model.loss``, its metrics (ce, aux, mtp) and
  every gradient against ``jax.value_and_grad`` of the reference's
  ``decoder_loss`` at the bounds above, bf16 under the reference's expert
  picks (replayed through ``moe.ROUTE_LOG``: a near-tie flips on bf16
  rounding, see tests/test_torch_moe.py), f32 on the port's own; each
  option (``mtp=False``, ``aux_loss_weight=0``, ``remat="full"``, a chunked
  CE, a ``moe_token_chunk`` that splits the tokens) in f32.
* ``gpu``: the backward kernel against its plain version on the card, and a
  3-step train of a cut llama on the card against the CPU; the same at
  d 192 / dv 128, the cut MoE models trained on the card against the CPU
  (under the CPU's picks) and a MoE train step repeated bit for bit.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ModelOpts as JModelOpts
from repro.models import build as jbuild
from repro.models.attention import attention as jattention
from repro.models.flash import flash_attention_hlo
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.convert import params_from_jax_numpy
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.models import ModelOpts, build, moe
from repro_torch.train import optimizer as topt
from test_torch_moe import jax_picks, route_log

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# ---------------------------------------------------------------------------
# Attention backward
# ---------------------------------------------------------------------------

# (label, B, Sq, Sk, Hq, Hkv, d, causal, window, JAX tiles (cq, ck))
BWD_CASES = [
    ("causal", 2, 64, 64, 4, 4, 32, True, 0, (16, 32)),
    ("window", 2, 64, 64, 4, 4, 32, True, 24, (16, 32)),
    ("Sq < Sk", 2, 32, 96, 4, 4, 32, True, 0, (16, 32)),
    ("GQA 8:2", 2, 64, 64, 8, 2, 32, True, 0, (16, 32)),
    ("ragged S=17", 1, 17, 17, 4, 2, 16, True, 0, (17, 17)),
    ("bidirectional", 1, 40, 40, 2, 2, 16, False, 0, (20, 40)),
]


def _bwd_inputs(B, Sq, Sk, Hq, Hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d), (B, Sq, Hq, d))]


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_plain_backward_matches_jax_vjp(case):
    _, B, Sq, Sk, Hq, Hkv, d, causal, window, (cq, ck) = case
    q, k, v, do = _bwd_inputs(B, Sq, Sk, Hq, Hkv, d)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    scale = 1.0 / np.sqrt(d)
    wants = {
        "attention": jax.vjp(lambda a, b, c: jattention(
            a, b, c, causal=causal, chunk_q=cq, chunk_k=ck, window=window,
            schedule="dense"), jq, jk, jv)[1](jdo),
        "flash_attention_hlo": jax.vjp(lambda a, b, c: flash_attention_hlo(
            a, b, c, causal, cq, ck, window, scale, False), jq, jk, jv)[1](jdo),
    }
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    calls = flash_attention_bwd_plain.calls
    tiled = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal, window=window,
                                      block_q=16, block_k=32)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = FlashAttention.apply(*leaves, causal, window, None)
    through_autograd = torch.autograd.grad(out, leaves, tdo)
    assert flash_attention_bwd_plain.calls == calls + 2
    for name, want in wants.items():
        for got in (tiled, through_autograd):
            for g, w in zip(got, want):
                np.testing.assert_allclose(_np(g), np.asarray(w), atol=2e-4, rtol=2e-4,
                                           err_msg=name)


def test_backward_dispatches_by_device():
    q, k, v, do = map(torch.from_numpy, _bwd_inputs(1, 8, 8, 2, 2, 16))
    o, lse = flash_attention_plain(q, k, v)
    launches, calls = flash_attention_bwd.launches, flash_attention_bwd_plain.calls
    flash_attention_bwd(q, k, v, o, lse, do)
    assert (flash_attention_bwd.launches, flash_attention_bwd_plain.calls) == \
        (launches, calls + 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_bwd(*(t.to("meta") for t in (q, k, v, o, lse, do)))


def test_attention_takes_the_forward_alone_without_grad():
    """Serving (no_grad) calls the forward only: no graph, no backward."""
    from repro_torch.models.attention import attention

    q, k, v, _ = map(torch.from_numpy, _bwd_inputs(1, 8, 8, 2, 2, 16))
    q.requires_grad_()
    with torch.no_grad():
        assert attention(q, k, v).grad_fn is None
    assert attention(q, k, v).grad_fn is not None


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-38)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,wd", [("adamw", 0.0), ("adamw", 0.1), ("lion", 0.05)])
def test_opt_update_matches_jax(name, wd, moment_dtype):
    """Three updates in a row (bias correction at counts 1..3) with the
    global-norm clip active; bf16 moments go with bf16 params, as the
    full-width llama2-7b train step runs them."""
    rng = np.random.default_rng(3)
    pdt = "bfloat16" if moment_dtype == "bfloat16" else "float32"
    shapes = {"emb": (16, 8), "layers.0.w": (8, 12), "ln": (8,)}
    params = {n: rng.normal(0, 1, s).astype(np.float32) for n, s in shapes.items()}
    lr = 1e-3 if name == "adamw" else 3e-4
    jcfg = jopt.OptConfig(name=name, lr=lr, weight_decay=wd, grad_clip=1.0,
                          moment_dtype=moment_dtype)
    tcfg = topt.OptConfig(name=name, lr=lr, weight_decay=wd, grad_clip=1.0,
                          moment_dtype=moment_dtype)
    jp = {n: jnp.asarray(a, JDT[pdt]) for n, a in params.items()}
    tp = {n: torch.from_numpy(a).to(TDT[pdt]) for n, a in params.items()}
    jst, tst = jopt.opt_init(jp, jcfg), topt.opt_init(tp, tcfg)
    for step in range(3):
        grads = {n: rng.normal(0, 3, s).astype(np.float32) for n, s in shapes.items()}
        jg = {n: jnp.asarray(a, JDT[pdt]) for n, a in grads.items()}
        tg = {n: torch.from_numpy(a).to(TDT[pdt]) for n, a in grads.items()}
        jp, jst, jm = jopt.opt_update(jg, jst, jp, jcfg)
        tp, tst, tm = topt.opt_update(tg, tst, tp, tcfg)
        assert float(jm["grad_norm"]) > 1.0          # the clip acts
        assert _rel(tm["grad_norm"], jm["grad_norm"]) < 1e-6
        assert tst["count"] == int(jst["count"]) == step + 1
        assert all(tp[n].dtype == TDT[pdt] for n in shapes)
        moments = [k for k in ("m", "v") if k in jst]
        assert sorted(moments) == sorted(k for k in ("m", "v") if k in tst)
        assert all(tst[k][n].dtype == TDT[moment_dtype] for k in moments for n in shapes)
        pairs = [(tp[n], jp[n]) for n in shapes]
        pairs += [(tst[k][n], jst[k][n]) for k in moments for n in shapes]
        for got, want in pairs:
            if moment_dtype == "float32":
                assert _rel(got, want) < 1e-6
            else:
                w = _np(want)
                assert np.all(np.abs(_np(got) - w) <= _bf16_ulp(w))


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------

LOSS_ARCHS = ["llama2-7b", "gpt2-1.5b", "gemma-2b", "starcoder2-3b", "zamba2-7b", "rwkv6-1.6b"]
SSM_ARCHS = ("zamba2-7b", "rwkv6-1.6b")         # bf16 bound: see the module docstring
TOL_LOSS = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_GRAD = {"float32": 2e-4, "bfloat16": 5e-2}     # bf16: see the module docstring


def _loss_pair(arch, dtype, jopts=None, topts=None, seed=0):
    jcfg = jconfigs.get_reduced(arch).with_(dtype=dtype)
    cfg = configs.get_reduced(arch).with_(dtype=dtype)
    jm = jbuild(jcfg, jopts or JModelOpts())
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build(cfg, device="cpu", opts=topts or ModelOpts())
    tp = tm.load(params_from_jax_numpy(jax.tree.map(np.asarray, jp), cfg))
    return cfg, jm, jp, tm, tp


def _check_loss_and_grads(arch, dtype, jopts=None, topts=None, S=32):
    cfg, jm, jp, tm, tp = _loss_pair(arch, dtype, jopts, topts)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, {"tokens": jnp.asarray(toks)})
    tl, metrics = tm.loss(tp, {"tokens": torch.from_numpy(toks).long()})
    tl.backward()
    assert _rel(tl, jl) < TOL_LOSS[dtype]
    assert torch.equal(metrics["ce"], tl)
    want = params_from_jax_numpy(jax.tree.map(np.asarray, jg), cfg)
    got = dict(tp.named_parameters())
    assert sorted(want) == sorted(got)
    noise = {name: 0.0 for name in want}
    if dtype == "bfloat16" and arch in SSM_ARCHS:
        # JAX's own bf16 rounding error: its distance from the f32 gradient
        # at the same (bf16) weights
        jm32 = jbuild(jconfigs.get_reduced(arch).with_(dtype="float32"), jopts or JModelOpts())
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        (_, _), jg32 = jax.value_and_grad(jm32.loss, has_aux=True)(
            jp32, {"tokens": jnp.asarray(toks)})
        f32 = params_from_jax_numpy(jax.tree.map(np.asarray, jg32),
                                    cfg.with_(dtype="float32"))
        noise = {name: _rel(g, f32[name]) for name, g in want.items()}
    for name, g in want.items():
        assert got[name].grad.dtype == got[name].dtype == want[name].dtype, name
        assert _rel(got[name].grad, g) < TOL_GRAD[dtype] + 2 * noise[name], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_jax(arch, dtype):
    _check_loss_and_grads(arch, dtype)


@pytest.mark.parametrize("opts", [dict(remat="full"), dict(loss_chunk=8)],
                         ids=["remat", "loss_chunk"])
def test_loss_options_match_jax(opts):
    """remat="full" (torch.utils.checkpoint per block) and the sequence-
    chunked cross-entropy give the reference's loss and gradients."""
    _check_loss_and_grads("llama2-7b", "float32", JModelOpts(**opts), ModelOpts(**opts))


@pytest.mark.parametrize("opts", [dict(remat="full"), dict(loss_chunk=8)],
                         ids=["remat", "loss_chunk"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_loss_options_match_jax(arch, opts):
    """The same for the hybrid and RWKV-6 losses: remat="full" checkpoints
    one SSM layer with its shared-block application (zamba2) or one block
    (rwkv6), as the reference's jax.checkpoint of its scanned body."""
    _check_loss_and_grads(arch, "float32", JModelOpts(**opts), ModelOpts(**opts))


# ---------------------------------------------------------------------------
# MoE / MLA training
# ---------------------------------------------------------------------------

MLA_DIMS = (192, 128)
# (label, B, Sq, Sk, Hq, Hkv, causal, JAX tiles (cq, ck)) at d 192 / dv 128
MLA_BWD_CASES = [
    ("causal", 2, 40, 40, 2, 2, True, (8, 20)),
    ("Sq < Sk", 2, 24, 72, 2, 2, True, (8, 24)),
    ("ragged S=17 GQA 4:2", 1, 17, 17, 4, 2, True, (17, 17)),
]


@pytest.mark.parametrize("case", MLA_BWD_CASES, ids=[c[0] for c in MLA_BWD_CASES])
def test_plain_backward_at_192_128_matches_jax_vjp(case):
    """The gradient the MLA attention takes: q, k 192 wide, v 128, scale
    1/sqrt(192), against jax.vjp of the reference's attention, and through
    FlashAttention (the autograd path the port's model takes)."""
    _, B, Sq, Sk, Hq, Hkv, causal, (cq, ck) = case
    d, dv = MLA_DIMS
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.normal(0, 1, s).astype(np.float32) for s in (
        (B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, dv), (B, Sq, Hq, dv)))
    scale = 1.0 / np.sqrt(d)
    want = jax.vjp(lambda a, b, c: jattention(a, b, c, causal=causal, chunk_q=cq, chunk_k=ck,
                                              scale=scale), *map(jnp.asarray, (q, k, v))
                   )[1](jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal, scale=scale)
    tiled = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal, scale=scale,
                                      block_q=16, block_k=32)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = FlashAttention.apply(*leaves, causal, 0, scale)
    assert out.shape == (B, Sq, Hq, dv)
    through_autograd = torch.autograd.grad(out, leaves, tdo)
    for got in (tiled, through_autograd):
        assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=2e-4, rtol=2e-4)


MOE_ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]


@functools.cache
def _jax_params(arch, dtype):
    """The reference's weights of a reduced config, drawn once per module
    (JAX arrays are immutable)."""
    return jbuild(jconfigs.get_reduced(arch).with_(dtype=dtype)).init(jax.random.PRNGKey(0))


def _check_moe_loss(arch, dtype, jopts=None, topts=None, S=32, monkeypatch=None):
    """Loss, metrics and every gradient of a reduced MoE model against the
    reference's; bf16 runs the port under the reference's picks."""
    cfg = configs.get_reduced(arch).with_(dtype=dtype)
    jm = jbuild(jconfigs.get_reduced(arch).with_(dtype=dtype), jopts or JModelOpts())
    jp = _jax_params(arch, dtype)
    tm = build(cfg, device="cpu", opts=topts or ModelOpts())
    tp = tm.load(params_from_jax_numpy(jax.tree.map(np.asarray, jp), cfg))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    with jax_picks(monkeypatch) if dtype == "bfloat16" else contextlib.nullcontext([]) as picks:
        # jitted (a fresh function, traced here with the recording top_k)
        (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda *a: jm.loss(*a), has_aux=True))(
            jp, {"tokens": jnp.asarray(toks)})
    T, chunk = 2 * S, (topts or ModelOpts()).moe_token_chunk
    n_calls = cfg.n_moe_layers * (T // chunk if chunk < T and T % chunk == 0 else 1)
    assert len(picks) == (n_calls if dtype == "bfloat16" else 0)
    with route_log(picks) as log:
        tl, metrics = tm.loss(tp, {"tokens": torch.from_numpy(toks).long()})
    assert len(log.seen) == n_calls and not log.replay
    tl.backward()
    assert _rel(tl, jl) < TOL_LOSS[dtype]
    assert sorted(metrics) == sorted(jmet)
    for key, want in jmet.items():
        assert _rel(metrics[key], want) < TOL_LOSS[dtype], key
    want = params_from_jax_numpy(jax.tree.map(np.asarray, jg), cfg)
    got = dict(tp.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        if got[name].grad is None:      # a leaf the loss leaves out (mtp=False)
            assert name.startswith("mtp.") and not np.any(_np(g)), name
            continue
        assert got[name].grad.dtype == got[name].dtype == want[name].dtype, name
        assert _rel(got[name].grad, g) < TOL_GRAD[dtype], name
    return metrics


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_match_jax(arch, dtype, monkeypatch):
    metrics = _check_moe_loss(arch, dtype, monkeypatch=monkeypatch)
    assert ("mtp" in metrics) == (arch == "deepseek-v3-671b")
    assert float(metrics["aux"].detach()) > 0


MOE_OPTS = {"mtp_off": dict(mtp=False), "aux_weight_0": dict(aux_loss_weight=0.0),
            "remat": dict(remat="full"), "loss_chunk": dict(loss_chunk=8),
            "token_chunk": dict(moe_token_chunk=16)}


@pytest.mark.parametrize("opt", sorted(MOE_OPTS))
def test_moe_loss_options_match_jax(opt, monkeypatch):
    """Each knob of the MoE / MLA loss on reduced deepseek-v3 (MLA, MoE and
    the MTP block), f32: the MTP term off, the aux term weighted 0, every
    block recomputed in the backward (a MoE block under its forward's
    picks), the CE in sequence chunks, and a dispatch chunk of 16 of the 64
    tokens (the aux loss the mean of four chunks')."""
    kw = MOE_OPTS[opt]
    metrics = _check_moe_loss("deepseek-v3-671b", "float32", JModelOpts(**kw), ModelOpts(**kw),
                              monkeypatch=monkeypatch)
    assert ("mtp" in metrics) == (opt != "mtp_off")


def test_remat_replays_the_forward_picks():
    """Under remat="full" each MoE block's recompute takes the picks its
    forward made, and ROUTE_LOG sees only the forward's calls: the
    gradients equal those without remat bit for bit on the CPU."""
    cfg = configs.get_reduced("moonshot-v1-16b-a3b").with_(dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)))
    grads = []
    for remat in ("none", "full"):
        m = build(cfg, device="cpu", opts=ModelOpts(remat=remat))
        params = m.init()
        with route_log() as log:
            m.loss(params, {"tokens": toks})[0].backward()
        assert len(log.seen) == cfg.n_moe_layers
        grads.append({n: p.grad for n, p in params.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(grads[1][n], g), n


def test_dispatch_backward_is_the_sum_of_slot_gradients():
    """moe.Dispatch: each kept pick's row holds its token, the rest are
    zero; a token's gradient is the sum of its K rows' (a dropped pick adds
    nothing), as autograd's backward of the indexing it replaces."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (5, 3)).astype(np.float32)).requires_grad_()
    slot = torch.tensor([[0, 7], [1, 2], [7, 3], [4, 5], [6, 7]])
    buf = moe.Dispatch.apply(x, slot, 7)
    ref = torch.zeros(8, 3).index_put((slot.reshape(-1),), x.repeat_interleave(2, 0))[:7]
    assert torch.equal(buf, ref)
    g = torch.from_numpy(rng.normal(0, 1, (7, 3)).astype(np.float32))
    (got,) = torch.autograd.grad(buf, x, g)
    want = torch.zeros(5, 3)
    for t in range(5):
        for s_ in slot[t].tolist():
            if s_ < 7:
                want[t] += g[s_]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("plan_kw", [{}, {"zero_stage": 1}, {"zero_stage": 3},
                                     {"zero_stage": 1, "offload": True}],
                         ids=["dp", "zero1", "zero3", "offload"])
def test_moe_plans_across_a_mesh_raise_naming_a14b(plan_kw):
    """compile_train_step refuses the MoE family: its layout across a mesh
    is ROADMAP A14b (make_train_step trains it, above and on the card)."""
    from repro_torch.parallel.plan import ExecutionPlan
    from repro_torch.train.step import check_plan

    with pytest.raises(NotImplementedError, match="A14b"):
        check_plan(configs.get_reduced("deepseek-v3-671b"), ExecutionPlan(**plan_kw))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_input_specs_and_dummy_batch(arch):
    from repro_torch.configs import ShapeConfig

    m = build(configs.get_reduced(arch), device="cpu")
    assert m.input_specs(ShapeConfig("t", 16, 2, "train"))["tokens"].shape == (2, 16)
    assert m.input_specs(ShapeConfig("d", 16, 2, "decode"))["tokens"].shape == (2,)
    b = m.dummy_batch(ShapeConfig("t", 16, 2, "train"))
    loss, metrics = m.loss(m.init(), b)
    assert b["tokens"].shape == (2, 16) and int(b["tokens"].max()) < m.cfg.vocab_size
    assert bool(torch.isfinite(loss)) and "aux" in metrics


def test_input_specs_and_dummy_batch():
    from repro_torch.configs import ShapeConfig

    m = build(configs.get_reduced("llama2-7b"), device="cpu")
    specs = m.input_specs(ShapeConfig("t", 32, 4, "train"))
    assert specs["tokens"].shape == (4, 32) and specs["tokens"].device.type == "meta"
    assert m.input_specs(ShapeConfig("d", 32, 4, "decode"))["tokens"].shape == (4,)
    b = m.dummy_batch(ShapeConfig("t", 32, 4, "train"))["tokens"]
    assert b.shape == (4, 32) and 0 <= int(b.min()) and int(b.max()) < 256


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# The bwd_kernels cases of chip_smoke.py: (label, B, Sq, Sk, Hq, Hkv, d, causal,
# window, dtype).
GPU_BWD_CASES = [
    ("llama2-7b train", 4, 512, 512, 32, 32, 128, True, 0, "bfloat16"),
    ("llama2-7b train f32", 4, 512, 512, 32, 32, 128, True, 0, "float32"),
    ("gpt2-1.5b train d=64", 4, 512, 512, 25, 25, 64, True, 0, "bfloat16"),
    ("ragged S=17", 2, 17, 17, 8, 8, 128, True, 0, "bfloat16"),
    ("ragged S=65", 2, 65, 65, 8, 8, 128, True, 0, "float32"),
    ("ragged S=100", 2, 100, 100, 8, 8, 64, True, 0, "bfloat16"),
    ("Sq < Sk", 2, 128, 640, 8, 8, 128, True, 0, "bfloat16"),
    ("window 96", 2, 512, 512, 8, 2, 128, True, 96, "bfloat16"),
    ("GQA 64:8", 1, 256, 256, 64, 8, 128, True, 0, "bfloat16"),
    ("d=112", 2, 256, 256, 8, 8, 112, True, 0, "bfloat16"),
    ("d=256 MQA", 2, 256, 256, 8, 1, 256, True, 0, "bfloat16"),
    ("d=256 f32", 1, 200, 200, 4, 2, 256, True, 0, "float32"),
    ("bidirectional", 2, 256, 256, 8, 8, 128, False, 0, "bfloat16"),
]
TOL_BWD = {"float32": 2e-4, "bfloat16": 3e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_BWD_CASES, ids=[c[0] for c in GPU_BWD_CASES])
def test_backward_kernel_matches_plain(case, cuda_device):
    """dq, dk and dv from the kernel against the plain version on the same
    inputs: max|Δ| / max|plain| at f32 2e-4, bf16 3e-2."""
    _, B, Sq, Sk, Hq, Hkv, d, causal, window, dtype = case
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(s, generator=gen, device=cuda_device).to(TDT[dtype])
                   for s in ((B, Sq, Hq, d), (B, Sk, Hkv, d), (B, Sk, Hkv, d),
                             (B, Sq, Hq, d)))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_plain(q, k, v, **kw)
    launches = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == launches + 1
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == TDT[dtype] and bool(torch.isfinite(g).all())
        assert _rel(g, w) <= TOL_BWD[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan_kw", [{}, {"ga_steps": 2}, {"gc": True}],
                         ids=["plain", "ga2", "gc"])
def test_train_on_card_matches_cpu(plan_kw, dtype, cuda_device):
    """Three AdamW steps of a cut llama (head dim 128, so the kernels take
    it) on the card and on the CPU from the same weights and batches, at
    TOL_LOSS and TOL_GRAD: f32 losses rel 1e-4 and step-1 gradients 2e-4;
    bf16, which runs the backward's tensor-core kernels, 3e-2 and 5e-2."""
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.parallel.plan import ExecutionPlan
    from repro_torch.train.step import make_train_step

    cfg = configs.get("llama2-7b").with_(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2,
                                          d_ff=512, vocab_size=512, dtype=dtype)
    plan = ExecutionPlan(**plan_kw)
    opts = ModelOpts(remat="full" if plan.gc else "none", loss_chunk=0)
    optcfg = topt.OptConfig(lr=1e-3)
    data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=100, global_batch=2))
    cpu = build(cfg, device="cpu", opts=opts)
    gpu = build(cfg, device=cuda_device, opts=opts)
    pc = cpu.init()
    pg = gpu.load({k: v.to(cuda_device) for k, v in pc.state_dict().items()})
    grads = []
    for m, p in ((cpu, pc), (gpu, pg)):
        loss, _ = m.loss(p, {"tokens": torch.from_numpy(data.batch(0)).long().to(m.device)})
        loss.backward()
        grads.append({n: t.grad.detach().cpu() for n, t in p.named_parameters()})
        p.zero_grad(set_to_none=True)
    for n, g in grads[0].items():
        assert _rel(grads[1][n], g) <= TOL_GRAD[dtype], n
    sc, sg = topt.opt_init(pc, optcfg), topt.opt_init(pg, optcfg)
    step_c = make_train_step(cpu, plan, optcfg)
    step_g = make_train_step(gpu, plan, optcfg)
    for i in range(3):
        toks = torch.from_numpy(data.batch(i)).long()
        pc, sc, mc = step_c(pc, sc, {"tokens": toks})
        pg, sg, mg = step_g(pg, sg, {"tokens": toks.to(cuda_device)})
        assert _rel(mg["loss"], mc["loss"]) <= TOL_LOSS[dtype]


# The bwd_kernels cases of chip_smoke.py at d 192 / dv 128: (label, B, Sq, Sk,
# Hq, Hkv); deepseek-v3-671b's train shape first.  v is a view of the
# (B, S, H, 256) buffer MLA decompresses it into, as the model hands it over.
GPU_MLA_BWD_CASES = [
    ("deepseek-v3 train", 4, 512, 512, 128, 128),
    ("ragged S=300", 2, 300, 300, 128, 128),
    ("Sq < Sk", 2, 128, 640, 128, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GPU_MLA_BWD_CASES, ids=[c[0] for c in GPU_MLA_BWD_CASES])
def test_backward_kernel_matches_plain_at_192_128(case, dtype, cuda_device):
    _, B, Sq, Sk, Hq, Hkv = case
    d, dv = MLA_DIMS
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(TDT[dtype])

    q, k, do = randn(B, Sq, Hq, d), randn(B, Sk, Hkv, d), randn(B, Sq, Hq, dv)
    v = randn(B, Sk, Hkv, 2 * dv)[..., dv:]
    scale = 1.0 / np.sqrt(d)
    o, lse = flash_attention_plain(q, k, v, scale=scale)
    launches = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, scale=scale)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == launches + 1
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale=scale)
    assert [g.shape for g in got] == [q.shape, k.shape, (B, Sk, Hkv, dv)]
    for g, w in zip(got, want):
        assert g.dtype == TDT[dtype] and bool(torch.isfinite(g).all())
        assert _rel(g, w) <= TOL_BWD[dtype]


# The cut MoE models of chip_smoke.py's REFERENCE: full per-head dims (the
# kernels take them), 1 dense + 1 MoE layer of 8 experts top-2.
MOE_CUT = dict(n_layers=2, n_dense_layers=1, d_model=256, n_heads=2, n_kv_heads=2, d_ff=512,
               n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=128, vocab_size=512)
MLA_CUT = dict(q_lora_rank=64, kv_lora_rank=32)


def _moe_cut(arch, dtype):
    return configs.get(arch).with_(dtype=dtype, **MOE_CUT,
                                   **(MLA_CUT if arch == "deepseek-v3-671b" else {}))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan_kw", [{}, {"ga_steps": 2}, {"gc": True}],
                         ids=["plain", "ga2", "gc"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_on_card_matches_cpu(arch, plan_kw, dtype, cuda_device):
    """As test_train_on_card_matches_cpu for the cut MoE models, the card
    under the CPU's expert picks (a near-tie flips on bf16 rounding; the
    routers are held to each other in tests/test_torch_moe.py and by
    chip_smoke.py): step-1 loss and gradients, then 3 AdamW steps."""
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.parallel.plan import ExecutionPlan
    from repro_torch.train.step import make_train_step

    cfg = _moe_cut(arch, dtype)
    plan = ExecutionPlan(**plan_kw)
    opts = ModelOpts(remat="full" if plan.gc else "none", loss_chunk=0)
    optcfg = topt.OptConfig(lr=1e-3)
    data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=100, global_batch=2))
    cpu = build(cfg, device="cpu", opts=opts)
    gpu = build(cfg, device=cuda_device, opts=opts)
    pc = cpu.init()
    pg = gpu.load({k: v.to(cuda_device) for k, v in pc.state_dict().items()})

    def both(run_cpu, run_gpu):
        with route_log() as log:
            out_c = run_cpu()
        with route_log([e.numpy() for _, _, e in log.seen]) as replay:
            out_g = run_gpu()
        assert not replay.replay and len(replay.seen) == len(log.seen)
        return out_c, out_g

    grads = []
    toks = torch.from_numpy(data.batch(0)).long()
    losses = both(lambda: cpu.loss(pc, {"tokens": toks})[0],
                  lambda: gpu.loss(pg, {"tokens": toks.to(cuda_device)})[0])
    assert _rel(losses[1], losses[0]) <= TOL_LOSS[dtype]
    for loss, p in zip(losses, (pc, pg)):
        loss.backward()
        grads.append({n: t.grad.detach().cpu() for n, t in p.named_parameters()})
        p.zero_grad(set_to_none=True)
    for n, g in grads[0].items():
        assert _rel(grads[1][n], g) <= TOL_GRAD[dtype], n
    sc, sg = topt.opt_init(pc, optcfg), topt.opt_init(pg, optcfg)
    step_c = make_train_step(cpu, plan, optcfg)
    step_g = make_train_step(gpu, plan, optcfg)
    for i in range(3):
        toks = torch.from_numpy(data.batch(i)).long()
        (pc, sc, mc), (pg, sg, mg) = both(lambda: step_c(pc, sc, {"tokens": toks}),
                                          lambda: step_g(pg, sg, {"tokens": toks.to(cuda_device)}))
        assert _rel(mg["loss"], mc["loss"]) <= TOL_LOSS[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_is_bit_repeatable(arch, cuda_device):
    """The same bf16 step twice on the card from the same weights: loss and
    every gradient the same bits (the dispatch's backward sums in a fixed
    order; the flash backward sums without atomics)."""
    cfg = _moe_cut(arch, "bfloat16")
    m = build(cfg, device=cuda_device, opts=ModelOpts(loss_chunk=0))
    params = m.init()
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 100)))
    runs = []
    for _ in range(2):
        loss, metrics = m.loss(params, {"tokens": toks.to(cuda_device)})
        loss.backward()
        runs.append((loss.detach(), {k: v.detach() for k, v in metrics.items()},
                     {n: p.grad.clone() for n, p in params.named_parameters()}))
        params.zero_grad(set_to_none=True)
    (l0, m0, g0), (l1, m1, g1) = runs
    assert torch.equal(l0, l1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    for n, g in g0.items():
        assert torch.equal(g, g1[n]), n
