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
* ``gpu``: the backward kernel against its plain version on the card, and a
  3-step train of a cut llama on the card against the CPU.
"""

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
from repro_torch.models import ModelOpts, build
from repro_torch.train import optimizer as topt

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
