"""Training the SSM families in the port: the SSD-scan and WKV6 backward.

* ``ssd_scan_bwd_plain`` (the explicit chunked backward the kernel follows)
  against ``jax.vjp`` of ``repro.models.mamba2.ssd_chunked`` and against
  torch autograd of ``ssd_scan_plain``; ``wkv6_bwd_plain`` the same against
  ``repro.models.rwkv6.wkv_chunked`` and ``wkv6_plain``.  f32 and bf16,
  ragged S, nonzero initial state and last-state gradient.  Bounds, max|Δ| /
  max|reference| of each gradient: f32 2e-5, and 1e-4 for the gradients
  summed over batch, time or heads (dA, dB_, dC, du) and for dlogw (a
  reverse cumsum of differences); bf16 3e-2 (both sides round the
  gradients of bf16 inputs, and d(xdt) before dx and ddt, to bf16).
* ``SSDScan`` and ``WKV6`` under ``torch.autograd.gradcheck`` in float64
  (the plain versions compute in float64 for float64 inputs), over two
  chunks, the second ragged.
* The launcher trains the reduced zamba2-7b and rwkv6-1.6b on the CPU.
* ``gpu``: each backward kernel against its plain version on the card, at
  the train paths' shapes (zamba2-7b: x, B, C views of the conv output;
  rwkv6-1.6b: views of the projections) and around them; and 3 AdamW steps
  of cut zamba2 / rwkv6 configs on the card against the CPU.

Loss and gradients of the whole models against ``jax.value_and_grad`` are in
tests/test_torch_train.py (``LOSS_ARCHS``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro_torch.kernels.ssd_scan import (SSDScan, ssd_scan_bwd, ssd_scan_bwd_plain,
                                          ssd_scan_plain)
from repro_torch.kernels.wkv6 import WKV6, wkv6_bwd, wkv6_bwd_plain, wkv6_plain

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TOL_SUMMED = {"float32": 1e-4, "bfloat16": 3e-2}
SSD_NAMES = ("dx", "ddt", "dA", "dB_", "dC", "dh0")
SSD_SUMMED = ("dA", "dB_", "dC")
WKV_NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")
WKV_SUMMED = ("dlogw", "du")


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _check(got, wants, names, summed, dtype):
    for want in wants:
        for name, g, w in zip(names, got, want):
            bound = TOL_SUMMED[dtype] if name in summed else TOL[dtype]
            assert _rel(g, w) <= bound, (name, _rel(g, w))


# ---------------------------------------------------------------------------
# SSD scan backward
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, B, S, H, P, N, dtype):
    """x, B, C in ``dtype``; dt, A, h0, dh_last f32; dy in x's dtype."""
    rng = np.random.default_rng(seed)
    arrs = {"x": rng.normal(0, 1, (B, S, H, P)), "dt": rng.uniform(0.05, 1.0, (B, S, H)),
            "A": -rng.uniform(0.3, 2.0, (H,)), "B_": rng.normal(0, 1, (B, S, N)),
            "C": rng.normal(0, 1, (B, S, N)), "h0": rng.normal(0, 1, (B, H, P, N)),
            "dy": rng.normal(0, 1, (B, S, H, P)), "dh": rng.normal(0, 1, (B, H, P, N))}
    low = ("x", "B_", "C", "dy")
    jx = {k: jnp.asarray(a.astype(np.float32), JDT[dtype] if k in low else jnp.float32)
          for k, a in arrs.items()}
    tx = {k: torch.from_numpy(a.astype(np.float32)).to(TDT[dtype] if k in low else torch.float32)
          for k, a in arrs.items()}
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,jchunk,h0,dh", [
    (64, 16, 16, False, False),      # chunks divide S, zero state in and no state gradient
    (64, 16, 16, True, True),
    (50, 16, 50, True, True),        # ragged: the port pads, the model path takes one chunk of S
    (7, 16, 7, False, True),         # shorter than a chunk
])
def test_ssd_backward_matches_jax_and_autograd(S, chunk, jchunk, h0, dh, dtype):
    j, t = _ssd_inputs(11, 2, S, 3, 16, 8, dtype)
    jh0 = j["h0"] if h0 else jnp.zeros_like(j["h0"])
    jdh = j["dh"] if dh else jnp.zeros_like(j["dh"])
    _, vjp = jax.vjp(lambda x, dt, A, B_, C, h: jmamba2.ssd_chunked(x, dt, A, B_, C, jchunk, h0=h),
                     j["x"], j["dt"], j["A"], j["B_"], j["C"], jh0)
    want_jax = vjp((j["dy"], jdh))

    args = [t[k] for k in ("x", "dt", "A", "B_", "C")] + [t["h0"] if h0 else None]
    calls = ssd_scan_bwd_plain.calls
    got = ssd_scan_bwd_plain(*args, t["dy"], t["dh"] if dh else None, chunk=chunk)
    assert ssd_scan_bwd_plain.calls == calls + 1
    assert [g.dtype for g in got] == [a.dtype for a in args[:5]] + [torch.float32]

    leaves = [a.clone().requires_grad_() for a in args[:5]]
    leaves.append((args[5] if h0 else torch.zeros_like(t["h0"])).clone().requires_grad_())
    y, h_last = ssd_scan_plain(*leaves, chunk=chunk)
    want_torch = torch.autograd.grad((y, h_last), leaves,
                                     (t["dy"], t["dh"] if dh else torch.zeros_like(h_last)))
    _check(got, [want_jax, want_torch], SSD_NAMES, SSD_SUMMED, dtype)


def test_ssd_function_gradcheck():
    """SSDScan in float64 over two chunks of 64, the second ragged (S = 70)."""
    g = torch.Generator().manual_seed(0)
    d = dict(dtype=torch.float64)
    B, S, H, P, N = 1, 70, 1, 2, 2
    x = torch.randn(B, S, H, P, generator=g, **d)
    dt = 0.05 + torch.rand(B, S, H, generator=g, **d)
    A = -(0.3 + torch.rand(H, generator=g, **d))
    Bm, Cm = (torch.randn(B, S, N, generator=g, **d) for _ in range(2))
    h0 = torch.randn(B, H, P, N, generator=g, **d)
    inputs = [t.requires_grad_() for t in (x, dt, A, Bm, Cm, h0)]
    assert torch.autograd.gradcheck(lambda *a: SSDScan.apply(*a), inputs)


def test_ssd_function_takes_absent_state_gradient():
    """Training reads y only: h_last's gradient never arrives and counts as
    zero; an absent h0 gets no gradient."""
    _, t = _ssd_inputs(12, 1, 20, 2, 8, 4, "float32")
    leaves = [t[k].clone().requires_grad_() for k in ("x", "dt", "A", "B_", "C")]
    y, _ = SSDScan.apply(*leaves, None)
    got = torch.autograd.grad(y, leaves, t["dy"])
    want = ssd_scan_bwd_plain(*(t[k] for k in ("x", "dt", "A", "B_", "C")), None, t["dy"], None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_backward_dispatches_by_device():
    _, t = _ssd_inputs(13, 1, 8, 2, 64, 64, "float32")
    args = [t[k] for k in ("x", "dt", "A", "B_", "C")] + [None, t["dy"], None]
    launches, calls = ssd_scan_bwd.launches, ssd_scan_bwd_plain.calls
    ssd_scan_bwd(*args)
    assert (ssd_scan_bwd.launches, ssd_scan_bwd_plain.calls) == (launches, calls + 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd_scan_bwd(*(a.to("meta") if a is not None else None for a in args))


# ---------------------------------------------------------------------------
# WKV6 backward
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, B, S, H, hd, dtype):
    """r, k, v in ``dtype``; logw (-0.02..-3 a step), u, s0, dy, dS_last f32."""
    rng = np.random.default_rng(seed)
    arrs = {"r": rng.normal(0, 1, (B, S, H, hd)), "k": rng.normal(0, 1, (B, S, H, hd)),
            "v": rng.normal(0, 1, (B, S, H, hd)),
            "logw": -rng.uniform(0.02, 3.0, (B, S, H, hd)), "u": rng.normal(0, 0.5, (H, hd)),
            "s0": rng.normal(0, 1, (B, H, hd, hd)), "dy": rng.normal(0, 1, (B, S, H, hd)),
            "dS": rng.normal(0, 1, (B, H, hd, hd))}
    low = ("r", "k", "v")
    jx = {k: jnp.asarray(a.astype(np.float32), JDT[dtype] if k in low else jnp.float32)
          for k, a in arrs.items()}
    tx = {k: torch.from_numpy(a.astype(np.float32)).to(TDT[dtype] if k in low else torch.float32)
          for k, a in arrs.items()}
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,jchunk,s0,dS", [
    (64, 16, 16, False, False),
    (64, 16, 16, True, True),
    (50, 16, 50, True, True),        # ragged: the port pads, the model path takes one chunk of S
    (7, 16, 7, False, True),
])
def test_wkv_backward_matches_jax_and_autograd(S, chunk, jchunk, s0, dS, dtype):
    j, t = _wkv_inputs(21, 2, S, 3, 16, dtype)
    js0 = j["s0"] if s0 else jnp.zeros_like(j["s0"])
    jdS = j["dS"] if dS else jnp.zeros_like(j["dS"])
    _, vjp = jax.vjp(lambda r, k, v, w, u, s: jrwkv6.wkv_chunked(r, k, v, w, u, jchunk, s),
                     j["r"], j["k"], j["v"], j["logw"], j["u"], js0)
    want_jax = vjp((j["dy"], jdS))

    args = [t[k] for k in ("r", "k", "v", "logw", "u")] + [t["s0"] if s0 else None]
    calls = wkv6_bwd_plain.calls
    got = wkv6_bwd_plain(*args, t["dy"], t["dS"] if dS else None, chunk=chunk)
    assert wkv6_bwd_plain.calls == calls + 1
    assert [g.dtype for g in got] == [a.dtype for a in args[:5]] + [torch.float32]

    leaves = [a.clone().requires_grad_() for a in args[:5]]
    leaves.append((args[5] if s0 else torch.zeros_like(t["s0"])).clone().requires_grad_())
    y, s_last = wkv6_plain(*leaves, chunk=chunk)
    want_torch = torch.autograd.grad((y, s_last), leaves,
                                     (t["dy"], t["dS"] if dS else torch.zeros_like(s_last)))
    _check(got, [want_jax, want_torch], WKV_NAMES, WKV_SUMMED, dtype)


def test_wkv_function_gradcheck():
    """WKV6 in float64 over two chunks of 32, the second ragged (S = 40)."""
    g = torch.Generator().manual_seed(0)
    d = dict(dtype=torch.float64)
    B, S, H, hd = 1, 40, 1, 2
    r, k, v = (torch.randn(B, S, H, hd, generator=g, **d) for _ in range(3))
    logw = -(0.1 + torch.rand(B, S, H, hd, generator=g, **d))
    u = torch.randn(H, hd, generator=g, **d)
    s0 = torch.randn(B, H, hd, hd, generator=g, **d)
    inputs = [t.requires_grad_() for t in (r, k, v, logw, u, s0)]
    assert torch.autograd.gradcheck(lambda *a: WKV6.apply(*a), inputs)


def test_wkv_function_takes_absent_state_gradient():
    _, t = _wkv_inputs(22, 1, 20, 2, 8, "float32")
    leaves = [t[k].clone().requires_grad_() for k in ("r", "k", "v", "logw", "u")]
    y, _ = WKV6.apply(*leaves, None)
    got = torch.autograd.grad(y, leaves, t["dy"])
    want = wkv6_bwd_plain(*(t[k] for k in ("r", "k", "v", "logw", "u")), None, t["dy"], None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wkv_backward_dispatches_by_device():
    _, t = _wkv_inputs(23, 1, 8, 2, 64, "float32")
    args = [t[k] for k in ("r", "k", "v", "logw", "u")] + [None, t["dy"], None]
    launches, calls = wkv6_bwd.launches, wkv6_bwd_plain.calls
    wkv6_bwd(*args)
    assert (wkv6_bwd.launches, wkv6_bwd_plain.calls) == (launches, calls + 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        wkv6_bwd(*(a.to("meta") if a is not None else None for a in args))


def test_serving_takes_the_forward_alone():
    """Under no_grad (serving) the model paths call the forward kernels
    alone; with grad they go through the autograd Functions."""
    from repro_torch import configs
    from repro_torch.models import build

    for arch in ("zamba2-7b", "rwkv6-1.6b"):
        m = build(configs.get_reduced(arch), device="cpu")
        p = m.init()
        toks = torch.zeros((1, 8), dtype=torch.long)
        calls = (ssd_scan_bwd_plain.calls, wkv6_bwd_plain.calls)
        m.prefill(p, m.init_cache(1, 9), toks)
        loss, _ = m.loss(p, {"tokens": toks})
        assert (ssd_scan_bwd_plain.calls, wkv6_bwd_plain.calls) == calls
        loss.backward()
        n = m.cfg.n_layers
        assert (ssd_scan_bwd_plain.calls, wkv6_bwd_plain.calls) == (
            (calls[0] + n, calls[1]) if arch == "zamba2-7b" else (calls[0], calls[1] + n))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_launcher_trains_reduced_ssm_families(arch, tmp_path):
    """Reduced configs through launch.train on the CPU: the loss falls on
    the pipeline's batches, and a GA = 2 + GC restart resumes the run."""
    from repro_torch.launch.train import train

    kw = dict(arch=arch, reduced=True, batch=4, seq=32, lr=3e-3, device="cpu", log_every=1000)
    out = train(steps=12, ckpt_dir=str(tmp_path), ckpt_every=6, **kw)
    assert np.all(np.isfinite(out["losses"]))
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])
    resumed = train(steps=14, ckpt_dir=str(tmp_path), plan_kw={"ga_steps": 2, "gc": True}, **kw)
    assert len(resumed["losses"]) == 2 and np.all(np.isfinite(resumed["losses"]))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _bf16_step(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 at |t| (8 significant bits)."""
    e = torch.floor(torch.log2(t.float().abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


def _steps_apart(got, want) -> float:
    """max over elements of |got - want|, less 2e-5 max|want|, in bf16 steps
    at |want|."""
    d = (got.float() - want.float()).abs() - 2e-5 * want.float().abs().max()
    return float((d.clamp_min(0) / _bf16_step(want)).max())


def _kernel_ok(got, want, names, summed, rounded, dtype) -> dict[str, float]:
    """Kernel against plain on the same inputs.  Both compute in f32, so f32
    gradients hold at 2e-5 (1e-4 summed).  In bf16 the gradients that pass
    through a bf16 rounding (``rounded``, a dict of name: roundings on its
    path) may differ where the two f32 values straddle a rounding boundary:
    those hold at the bf16 bound 3e-2, and the ones handed back in bf16 also
    elementwise within one bf16 step per rounding (plus 2e-5 max|plain|)."""
    errs = {}
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and bool(torch.isfinite(g).all()), name
        errs[name] = _rel(g, w)
        if dtype == "bfloat16" and name in rounded:
            assert errs[name] <= 3e-2, (name, errs[name])
            if g.dtype == torch.bfloat16:
                assert _steps_apart(g, w) <= rounded[name], (name, _steps_apart(g, w))
        else:
            assert errs[name] <= (1e-4 if name in summed else 2e-5), (name, errs[name])
    return errs


# (B, S, H, h0/dh_last, dtype): the zamba2-7b train shape first.
GPU_SSD_CASES = [
    (4, 512, 112, False, "bfloat16"),
    (4, 512, 112, False, "float32"),
    (2, 300, 112, True, "bfloat16"),
    (2, 77, 16, True, "float32"),
    (1, 512, 112, True, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,state,dtype", GPU_SSD_CASES)
def test_ssd_backward_kernel_matches_plain(B, S, H, state, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    P = N = 64
    dt_ = TDT[dtype]
    conv = torch.randn((B, S, H * P + 2 * N), generator=gen, device=cuda_device).to(dt_)
    x = conv[..., :H * P].view(B, S, H, P)
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dt = 0.05 + 0.95 * torch.rand((B, S, H), generator=gen, device=cuda_device)
    A = -(0.3 + 1.7 * torch.rand((H,), generator=gen, device=cuda_device))
    h0, dh = (torch.randn((B, H, P, N), generator=gen, device=cuda_device) if state else None
              for _ in range(2))
    dy = torch.randn((B, S, H, P), generator=gen, device=cuda_device).to(dt_)
    args = (x, dt, A, Bm, Cm, h0, dy, dh)
    launches = ssd_scan_bwd.launches
    got = ssd_scan_bwd(*args)
    torch.cuda.synchronize()
    assert ssd_scan_bwd.launches == launches + 1
    want = ssd_scan_bwd_plain(*args)
    # dx rounds d(xdt), then d(xdt) dt: a flip of the first moves the product
    # by up to two steps before the second rounding
    _kernel_ok(got, want, SSD_NAMES, SSD_SUMMED, {"dx": 3, "ddt": 0, "dB_": 1, "dC": 1}, dtype)


# (B, S, H, s0/dS_last, dtype): the rwkv6-1.6b train shape first.
GPU_WKV_CASES = [
    (4, 512, 32, False, "bfloat16"),
    (4, 512, 32, False, "float32"),
    (2, 300, 32, True, "bfloat16"),
    (2, 33, 4, True, "float32"),
    (1, 512, 32, True, "bfloat16"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,state,dtype", GPU_WKV_CASES)
def test_wkv_backward_kernel_matches_plain(B, S, H, state, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    hd, dt_ = 64, TDT[dtype]
    proj = torch.randn((B, S, 3, H * hd), generator=gen, device=cuda_device).to(dt_)
    r, k, v = (proj[:, :, i].view(B, S, H, hd) for i in range(3))
    logw = -(0.02 + 2.98 * torch.rand((B, S, H, hd), generator=gen, device=cuda_device))
    u = 0.5 * torch.randn((H, hd), generator=gen, device=cuda_device)
    s0, dS = (torch.randn((B, H, hd, hd), generator=gen, device=cuda_device) if state
              else None for _ in range(2))
    dy = torch.randn((B, S, H, hd), generator=gen, device=cuda_device)
    args = (r, k, v, logw, u, s0, dy, dS)
    launches = wkv6_bwd.launches
    got = wkv6_bwd(*args)
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == launches + 1
    want = wkv6_bwd_plain(*args)
    _kernel_ok(got, want, WKV_NAMES, WKV_SUMMED, {"dr": 1, "dk": 1, "dv": 1}, dtype)


# The cut configs of chip_smoke.py's REFERENCE, which the kernels take.
CUT = {
    "zamba2-7b": dict(n_layers=4, d_model=256, n_heads=2, n_kv_heads=2, head_dim=112,
                      d_ff=512, ssm_state=64, ssm_head_dim=64, attn_every=2),
    "rwkv6-1.6b": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                       rwkv_head_dim=64, rwkv_lora_decay=16, rwkv_lora_mix=16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan_kw", [{}, {"ga_steps": 2}, {"gc": True}],
                         ids=["plain", "ga2", "gc"])
@pytest.mark.parametrize("arch", list(CUT))
def test_ssm_train_on_card_matches_cpu(arch, plan_kw, dtype, cuda_device):
    """Three AdamW steps of a cut config on the card and on the CPU from the
    same weights and batches: f32 losses rel 1e-4 and step-1 gradients
    2e-4; bf16 losses 3e-2 and each gradient within 5e-2 plus twice the
    CPU's own bf16 rounding error on that leaf (its distance from the f32
    gradient at the same weights), as chip_smoke.py's train_reference."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import ModelOpts, build
    from repro_torch.parallel.plan import ExecutionPlan
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.step import make_train_step

    cfg = configs.get(arch).with_(vocab_size=512, dtype=dtype, **CUT[arch])
    plan = ExecutionPlan(**plan_kw)
    opts = ModelOpts(remat="full" if plan.gc else "none", loss_chunk=0)
    optcfg = OptConfig(lr=1e-3)
    data = make_source(DataConfig(vocab_size=512, seq_len=100, global_batch=2))
    cpu, gpu = build(cfg, device="cpu", opts=opts), build(cfg, device=cuda_device, opts=opts)
    pc = cpu.init()
    pg = gpu.load({k: v.to(cuda_device) for k, v in pc.state_dict().items()})
    batch0 = torch.from_numpy(data.batch(0)).long()
    grads = []
    for m, p in ((cpu, pc), (gpu, pg)):
        loss, _ = m.loss(p, {"tokens": batch0.to(m.device)})
        loss.backward()
        grads.append({n: t.grad.detach().cpu() for n, t in p.named_parameters()})
        p.zero_grad(set_to_none=True)
    noise = {n: 0.0 for n in grads[0]}
    if dtype == "bfloat16":
        f32 = build(cfg.with_(dtype="float32"), device="cpu", opts=opts)
        p32 = f32.load({k: v.float() for k, v in pc.state_dict().items()})
        f32.loss(p32, {"tokens": batch0})[0].backward()
        noise = {n: _rel(grads[0][n], t.grad) for n, t in p32.named_parameters()}
    tol_loss, tol_grad = (1e-4, 2e-4) if dtype == "float32" else (3e-2, 5e-2)
    for n, g in grads[0].items():
        assert _rel(grads[1][n], g) <= tol_grad + 2 * noise[n], n
    sc, sg = opt_init(pc, optcfg), opt_init(pg, optcfg)
    step_c, step_g = make_train_step(cpu, plan, optcfg), make_train_step(gpu, plan, optcfg)
    for i in range(3):
        toks = torch.from_numpy(data.batch(i)).long()
        pc, sc, mc = step_c(pc, sc, {"tokens": toks})
        pg, sg, mg = step_g(pg, sg, {"tokens": toks.to(cuda_device)})
        assert _rel(mg["loss"], mc["loss"]) <= tol_loss
