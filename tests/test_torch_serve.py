"""The port's serving path against the JAX package on the same weights.

Reduced llama2-7b, gemma-2b, gpt2-1.5b and starcoder2-3b are initialised
by JAX, carried across with ``repro_torch.convert`` and served by both:
prefill and decode logits must match (f32 at 1e-4 relative, bf16 at 3e-2,
the bf16 bound of tests/test_kernels.py), greedy tokens must be equal in
f32, and the port's decode must match its own prefill (rel < 0.08, the
bound of tests/test_models_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.checkpoint import CheckpointManager
from repro_torch import configs
from repro_torch.convert import params_from_jax_numpy, read_checkpoint
from repro_torch.models import build
from repro_torch.serve.engine import ServeEngine

ARCHS = ["llama2-7b", "gemma-2b", "gpt2-1.5b", "starcoder2-3b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """(cfg, jax model, jax params, torch model, torch params) per (arch, dtype)."""
    memo = {}

    def get(arch, dtype):
        if (arch, dtype) not in memo:
            cfg = jconfigs.get_reduced(arch).with_(dtype=dtype)
            jm = jbuild(cfg)
            jp = jm.init(jax.random.PRNGKey(0))
            tcfg = configs.get_reduced(arch).with_(dtype=dtype)
            tm = build(tcfg, device="cpu")
            tp = tm.load(params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg))
            memo[arch, dtype] = (cfg, jm, jp, tm, tp)
        return memo[arch, dtype]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_match_jax(arch, dtype, pair):
    cfg, jm, jp, tm, tp = pair(arch, dtype)
    toks = _tokens(cfg.vocab_size, 2, 24)
    jc, jl = jax.jit(jm.prefill)(jp, jm.init_cache(2, 48),
                                 {"tokens": jnp.asarray(toks)})
    tc, tl = tm.prefill(tp, tm.init_cache(2, 48), torch.from_numpy(toks).long())
    assert tl.shape == (2, cfg.vocab_size)
    assert _rel(tl.float(), _np(jl)) < TOL[dtype]
    nxt = np.argmax(_np(jl), -1).astype(np.int32)
    for _ in range(3):
        jc, jl = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        assert _rel(tl.float(), _np(jl)) < TOL[dtype]
        nxt = np.argmax(_np(jl), -1).astype(np.int32)
    assert tc["pos"] == int(jc["pos"]) == 27


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(arch, pair):
    cfg, jm, jp, tm, tp = pair(arch, "float32")
    toks = _tokens(cfg.vocab_size, 2, 16, seed=1)
    want = JServeEngine(jm, jp, max_len=24).generate({"tokens": jnp.asarray(toks)},
                                                      steps=5)
    got = ServeEngine(tm, tp, max_len=24).generate(torch.from_numpy(toks).long(),
                                                   steps=5)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, pair):
    """prefill(t[:k]) + decode(t[k]) equals prefill(t[:k+1]) in the port."""
    cfg, _, _, tm, tp = pair(arch, "bfloat16")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 16, seed=2)).long()
    k = toks.shape[1] - 1
    cache, _ = tm.prefill(tp, tm.init_cache(2, 32), toks[:, :k])
    _, dec = tm.decode_step(tp, cache, toks[:, k])
    _, par = tm.prefill(tp, tm.init_cache(2, 32), toks)
    assert _rel(dec.float(), par.float()) < 0.08


def test_sliding_window_ring_cache(pair):
    """starcoder2 (window 32): the cache stays window-sized, and decoding past
    the window matches JAX step by step."""
    cfg, jm, jp, tm, tp = pair("starcoder2-3b", "float32")
    assert cfg.sliding_window == 32
    S = 64
    tc = tm.init_cache(1, S)
    assert tc["layers"]["k"].shape[2] == cfg.sliding_window
    toks = _tokens(cfg.vocab_size, 1, S, seed=3)
    jc, jl = jax.jit(jm.prefill)(jp, jm.init_cache(1, S), {"tokens": jnp.asarray(toks)})
    tc, tl = tm.prefill(tp, tc, torch.from_numpy(toks).long())
    assert _rel(tl, _np(jl)) < 1e-4
    for _ in range(4):
        nxt = np.argmax(_np(jl), -1).astype(np.int32)
        jc, jl = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        assert torch.isfinite(tl).all()
        assert _rel(tl, _np(jl)) < 1e-4
    assert tc["layers"]["k"].shape[2] == cfg.sliding_window
    np.testing.assert_allclose(tc["layers"]["k"].numpy(), _np(jc["layers"]["k"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(dtype, pair, tmp_path):
    """A JAX CheckpointManager arrays.npz serves in torch on the same weights."""
    cfg, jm, jp, tm, tp = pair("gpt2-1.5b", dtype)
    CheckpointManager(tmp_path, async_save=False).save(
        7, jp, opt_state={"m": jp["ln_f"]})
    flat = read_checkpoint(tmp_path / "step_000000007")
    assert any(k.endswith("::bf16") for k in flat) == (dtype == "bfloat16")
    state = params_from_jax_numpy(flat, tm.cfg)
    for k, v in tp.state_dict().items():
        assert torch.equal(state[k], v), k
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 8)).long()
    _, a = tm.prefill(tm.load(state), tm.init_cache(2, 8), toks)
    _, b = tm.prefill(tp, tm.init_cache(2, 8), toks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("breakage", ["missing", "extra", "shape", "dtype"])
def test_converter_rejects_mismatch(breakage, pair):
    cfg, _, jp, tm, _ = pair("llama2-7b", "float32")
    tree = jax.tree.map(np.asarray, jp)
    if breakage == "missing":
        del tree["head"]
    elif breakage == "extra":
        tree["mtp"] = {"proj": np.zeros((2, 2), np.float32)}
    elif breakage == "shape":
        tree["layers"]["ln1"] = tree["layers"]["ln1"][:, :-1]
    else:
        tree["ln_f"] = tree["ln_f"].astype(np.float16)
    with pytest.raises((KeyError, ValueError)):
        params_from_jax_numpy(tree, tm.cfg)


@pytest.mark.gpu
def test_serve_on_card_matches_cpu(cuda_device):
    """The kernel path on the card and the plain path on the CPU serve the
    same logits (f32; head dim 128 so the kernel takes it)."""
    cfg = configs.get("llama2-7b").with_(n_layers=2, d_model=256, n_heads=2,
                                          n_kv_heads=2, d_ff=512, vocab_size=512,
                                          dtype="float32")
    cpu = build(cfg, device="cpu")
    gpu = build(cfg, device=cuda_device)
    pc = cpu.init()
    pg = gpu.load({k: v.to(cuda_device) for k, v in pc.state_dict().items()})
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 100)).long()
    _, lc = cpu.prefill(pc, cpu.init_cache(2, 104), toks)
    _, lg = gpu.prefill(pg, gpu.init_cache(2, 104), toks.to(cuda_device))
    assert _rel(lg.cpu(), lc) < 1e-4
