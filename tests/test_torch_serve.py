"""The port's serving path against the JAX package on the same weights.

Reduced llama2-7b, gemma-2b, gpt2-1.5b, starcoder2-3b, zamba2-7b (hybrid:
Mamba-2 and a shared attention block) and rwkv6-1.6b are initialised by
JAX, carried across with ``repro_torch.convert`` and served by both:
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

ARCHS = ["llama2-7b", "gemma-2b", "gpt2-1.5b", "starcoder2-3b", "zamba2-7b", "rwkv6-1.6b"]
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_checkpoint_round_trip_ssm_families(arch, dtype, pair, tmp_path):
    """A CheckpointManager arrays.npz of the stacked ssm_layers/ and shared/
    subtrees (hybrid) and of the f32 leaves beside the model dtype carries
    across exactly and serves."""
    cfg, jm, jp, tm, tp = pair(arch, dtype)
    CheckpointManager(tmp_path, async_save=False).save(3, jp)
    flat = read_checkpoint(tmp_path / "step_000000003")
    state = params_from_jax_numpy(flat, tm.cfg)
    want = tp.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        assert state[k].dtype == v.dtype and torch.equal(state[k], v), k
    f32 = {"zamba2-7b": "ssm_layers.0.mixer.A_log", "rwkv6-1.6b": "layers.0.tm.u"}[arch]
    assert state[f32].dtype == torch.float32
    if arch == "zamba2-7b":
        assert state["shared.attn.wq"].shape == (cfg.d_model, cfg.n_heads * cfg.head_dim)
        assert f"ssm_layers.{cfg.n_layers - 1}.ln" in state
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 8)).long()
    _, a = tm.prefill(tm.load(state), tm.init_cache(2, 8), toks)
    _, b = tm.prefill(tp, tm.init_cache(2, 8), toks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("breakage", ["missing", "extra", "shape", "f32_leaf_dtype",
                                      "shared_axis"])
def test_converter_rejects_mismatch_hybrid(breakage, pair):
    cfg, _, jp, tm, _ = pair("zamba2-7b", "bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    mixer = tree["ssm_layers"]["mixer"]
    if breakage == "missing":
        del mixer["dt_bias"]
    elif breakage == "extra":
        tree["shared"]["lora"] = np.zeros((1, 2), np.float32)
    elif breakage == "shape":
        mixer["conv_w"] = mixer["conv_w"][:, :-1]
    elif breakage == "f32_leaf_dtype":
        mixer["A_log"] = mixer["A_log"].astype(jnp.bfloat16)
    else:
        tree["shared"]["ln1"] = np.concatenate([tree["shared"]["ln1"]] * 2)
    with pytest.raises((KeyError, ValueError)):
        params_from_jax_numpy(tree, tm.cfg)


def test_load_checks_each_leaf_against_its_declared_dtype(pair):
    """bf16 weights beside f32 leaves load; an f32 leaf in bf16 is refused."""
    _, _, _, tm, tp = pair("rwkv6-1.6b", "bfloat16")
    state = tp.state_dict()
    assert state["layers.0.tm.wr"].dtype == torch.bfloat16
    assert state["layers.0.ln1_g"].dtype == torch.float32
    tm.load(state)
    bad = dict(state, **{"layers.0.tm.w0": state["layers.0.tm.w0"].bfloat16()})
    with pytest.raises(ValueError, match="w0"):
        tm.load(bad)


def test_hybrid_prompt_not_multiple_of_ssm_chunk(pair):
    """Reduced zamba2 with a 24-token prompt against ssm_chunk 16: the port
    masks its last chunk, the reference takes one chunk of 24; logits, the
    SSM states and conv windows it caches, and three decode steps agree."""
    cfg, jm, jp, tm, tp = pair("zamba2-7b", "float32")
    S = 24
    assert cfg.ssm_chunk == 16 and S % cfg.ssm_chunk
    toks = _tokens(cfg.vocab_size, 2, S, seed=4)
    jc, jl = jax.jit(jm.prefill)(jp, jm.init_cache(2, 32), {"tokens": jnp.asarray(toks)})
    tc, tl = tm.prefill(tp, tm.init_cache(2, 32), torch.from_numpy(toks).long())
    assert _rel(tl, _np(jl)) < 1e-4
    assert _rel(tc["ssm"]["ssm"], _np(jc["ssm"]["ssm"])) < 1e-4
    assert _rel(tc["ssm"]["conv"], _np(jc["ssm"]["conv"])) < 1e-5
    assert _rel(tc["attn"]["k"], _np(jc["attn"]["k"])) < 1e-4
    for _ in range(3):
        nxt = np.argmax(_np(jl), -1).astype(np.int32)
        jc, jl = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        assert _rel(tl, _np(jl)) < 1e-4
    assert _rel(tc["ssm"]["ssm"], _np(jc["ssm"]["ssm"])) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_on_card_matches_cpu(dtype, cuda_device):
    """The kernel path on the card and the plain path on the CPU serve the
    same logits (head dim 128 so the kernel takes it; f32 at 1e-4, bf16 at
    the CPU bf16 parity bound 3e-2)."""
    cfg = configs.get("llama2-7b").with_(n_layers=2, d_model=256, n_heads=2,
                                          n_kv_heads=2, d_ff=512, vocab_size=512,
                                          dtype=dtype)
    cpu = build(cfg, device="cpu")
    gpu = build(cfg, device=cuda_device)
    pc = cpu.init()
    pg = gpu.load({k: v.to(cuda_device) for k, v in pc.state_dict().items()})
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 100)).long()
    _, lc = cpu.prefill(pc, cpu.init_cache(2, 104), toks)
    _, lg = gpu.prefill(pg, gpu.init_cache(2, 104), toks.to(cuda_device))
    assert _rel(lg.float().cpu(), lc.float()) < TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_ssm_families_on_card_match_cpu(arch, dtype, cuda_device):
    """The kernel paths (SSD scan and flash attention at head dim 112, or
    WKV6) on the card and the plain paths on the CPU serve the same logits,
    prefill and decode (f32 at 1e-4, bf16 at 3e-2)."""
    cut = {"zamba2-7b": dict(n_layers=4, d_model=256, n_heads=2, n_kv_heads=2,
                             head_dim=112, d_ff=512, ssm_state=64, ssm_head_dim=64,
                             attn_every=2),
           "rwkv6-1.6b": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                              d_ff=512, rwkv_head_dim=64, rwkv_lora_decay=16,
                              rwkv_lora_mix=16)}[arch]
    cfg = configs.get(arch).with_(vocab_size=512, dtype=dtype, **cut)
    cpu = build(cfg, device="cpu")
    gpu = build(cfg, device=cuda_device)
    pc = cpu.init()
    pg = gpu.load({k: v.to(cuda_device) for k, v in pc.state_dict().items()})
    toks = torch.from_numpy(_tokens(cfg.vocab_size, 2, 100)).long()
    cc, lc = cpu.prefill(pc, cpu.init_cache(2, 104), toks)
    cg, lg = gpu.prefill(pg, gpu.init_cache(2, 104), toks.to(cuda_device))
    assert _rel(lg.float().cpu(), lc.float()) < TOL[dtype]
    nxt = lc.argmax(-1)
    for _ in range(3):
        cc, lc = cpu.decode_step(pc, cc, nxt)
        cg, lg = gpu.decode_step(pg, cg, nxt.to(cuda_device))
        assert _rel(lg.float().cpu(), lc.float()) < TOL[dtype]
        nxt = lc.argmax(-1)
