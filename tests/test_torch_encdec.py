"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX package
on the same weights.

Reduced seamless-m4t-large-v2 is initialised by JAX, carried across with
``repro_torch.convert`` and served by both on the same frames and tokens
(numpy draws): the encoder output, the prefill logits, the self and cross
K/V caches and 4 decode steps must match (f32 at 1e-4 relative, bf16 at
3e-2, the TOL of tests/test_torch_serve.py), greedy tokens must be equal in
f32, and the port's decode must match its own prefill (rel < 0.08, the
bound of tests/test_models_smoke.py).  Conversion is bit-exact both ways.
``Model.loss`` and every gradient match ``jax.value_and_grad`` of the
reference's ``encdec_loss`` (tests/test_torch_train.py's TOL_LOSS and
TOL_GRAD) in f32 and bf16, with and without ``remat="full"``, and with a
chunked CE.  The refusals: a frame count other than ``n_frames`` when
serving (the reference's cross decode would read unwritten cache slots:
ROADMAP Quirks) and a batch without frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import encdec as jencdec
from repro.models.transformer import ModelOpts as JModelOpts
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.checkpoint import CheckpointManager
from repro_torch import configs
from repro_torch.convert import params_from_jax_numpy, params_to_jax_numpy, read_checkpoint
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import prompt_batch
from repro_torch.models import build, encdec
from repro_torch.serve.engine import ServeEngine

ARCH = "seamless-m4t-large-v2"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(jnp.asarray(b, jnp.float32))
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def pair():
    """(cfg, jax model, jax params, torch model, torch params) per dtype."""
    memo = {}

    def get(dtype):
        if dtype not in memo:
            cfg = jconfigs.get_reduced(ARCH).with_(dtype=dtype)
            jm = jbuild(cfg)
            jp = jm.init(jax.random.PRNGKey(0))
            tcfg = configs.get_reduced(ARCH).with_(dtype=dtype)
            tm = build(tcfg, device="cpu")
            tp = tm.load(params_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg))
            memo[dtype] = (cfg, jm, jp, tm, tp)
        return memo[dtype]
    return get


def _batches(cfg, B, S, seed=0):
    """The same prompt for both frameworks: int32 tokens and f32 frames."""
    arrs = prompt_batch(cfg, B, S, seed)
    jb = {k: jnp.asarray(a.astype(np.int32) if k == "tokens" else a) for k, a in arrs.items()}
    return jb, {k: torch.from_numpy(a) for k, a in arrs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype, pair):
    """The encoder (frame projection, enc_pos, bidirectional blocks, final
    norm) on the same frames; its attention runs the flash function's plain
    version, non-causal."""
    cfg, _, jp, tm, tp = pair(dtype)
    jb, tb = _batches(tm.cfg, 2, 8)
    want = jencdec.encode(jp, jb["frames"], cfg, JModelOpts())
    calls = flash_attention_plain.calls
    with torch.no_grad():
        got = encdec.encode(tp, tb["frames"], tm.cfg)
    assert flash_attention_plain.calls == calls + cfg.enc_layers
    assert got.shape == (2, cfg.n_frames, cfg.d_model) and got.dtype == tm.dtype
    assert _rel(_np(got), want) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_caches_and_decode_match_jax(dtype, pair):
    """Prefill logits, both caches (self K/V of the prompt, cross K/V of the
    frames) and 4 decode steps."""
    cfg, jm, jp, tm, tp = pair(dtype)
    jb, tb = _batches(tm.cfg, 2, 12, seed=1)
    jc, jl = jax.jit(jm.prefill)(jp, jm.init_cache(2, 24), jb)
    tc, tl = tm.prefill(tp, tm.init_cache(2, 24), tb)
    assert tl.shape == (2, cfg.vocab_size)
    assert _rel(_np(tl), jl) < TOL[dtype]
    for key in ("self_k", "self_v", "cross_k", "cross_v"):
        assert tc[key].shape == jc[key].shape and tc[key].dtype == tm.dtype, key
        assert _rel(_np(tc[key]), jc[key]) < TOL[dtype], key
    nxt = np.argmax(np.asarray(jnp.asarray(jl, jnp.float32)), -1).astype(np.int32)
    step = jax.jit(jm.decode_step)
    for _ in range(4):
        jc, jl = step(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        assert _rel(_np(tl), jl) < TOL[dtype]
        nxt = np.argmax(np.asarray(jnp.asarray(jl, jnp.float32)), -1).astype(np.int32)
    assert tc["pos"] == int(jc["pos"]) == 16
    assert _rel(_np(tc["self_k"]), jc["self_k"]) < TOL[dtype]


def test_greedy_tokens_equal_jax(pair):
    cfg, jm, jp, tm, tp = pair("float32")
    jb, tb = _batches(tm.cfg, 2, 10, seed=2)
    want = JServeEngine(jm, jp, max_len=20).generate(jb, steps=5)
    got = ServeEngine(tm, tp, max_len=20).generate(tb, steps=5)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_prefill(pair):
    """prefill(t[:k]) + decode(t[k]) equals prefill(t[:k+1]) on the same frames."""
    _, _, _, tm, tp = pair("bfloat16")
    _, tb = _batches(tm.cfg, 2, 16, seed=3)
    toks = tb["tokens"]
    k = toks.shape[1] - 1
    _, par = tm.prefill(tp, tm.init_cache(2, 32), tb)
    cache, _ = tm.prefill(tp, tm.init_cache(2, 32), dict(tb, tokens=toks[:, :k]))
    _, dec = tm.decode_step(tp, cache, toks[:, k])
    assert _rel(_np(dec), _np(par)) < 0.08


def test_frames_change_logits(pair):
    """The decoder reads the encoder: other frames, other logits."""
    _, _, _, tm, tp = pair("float32")
    _, tb = _batches(tm.cfg, 2, 8, seed=4)
    _, a = tm.prefill(tp, tm.init_cache(2, 8), tb)
    _, b = tm.prefill(tp, tm.init_cache(2, 8), dict(tb, frames=tb["frames"] + 1.0))
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conversion_both_ways_bit_exact(dtype, pair):
    """JAX tree -> port -> JAX tree, and a JAX checkpoint's flat arrays ->
    port, leaf for leaf and bit for bit (enc_layers / dec_layers unstacked by
    their own counts, xattn inside dec_layers, frame_proj, enc_pos,
    enc_ln_f)."""
    cfg, _, jp, tm, tp = pair(dtype)
    state = tp.state_dict()
    assert state["enc_pos"].shape == (cfg.n_frames, cfg.d_model)
    assert f"enc_layers.{cfg.enc_layers - 1}.mlp.wi" in state
    assert f"dec_layers.{cfg.n_layers - 1}.xattn.wq" in state
    back = params_to_jax_numpy(state)
    want = jax.tree.map(np.asarray, jp)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        got = flat_back[path]
        w = w.view(np.uint16) if w.dtype == jnp.bfloat16 else w
        assert got.dtype == w.dtype and np.array_equal(got, w), path
    assert len(flat_back) == len(jax.tree.leaves(want))


def test_checkpoint_serves_in_torch(pair, tmp_path):
    """A JAX CheckpointManager arrays.npz of the encoder-decoder loads and
    serves exactly as the converted tree does."""
    cfg, _, jp, tm, tp = pair("bfloat16")
    CheckpointManager(tmp_path, async_save=False).save(5, jp)
    state = params_from_jax_numpy(read_checkpoint(tmp_path / "step_000000005"), tm.cfg)
    for k, v in tp.state_dict().items():
        assert state[k].dtype == v.dtype and torch.equal(state[k], v), k
    _, tb = _batches(tm.cfg, 2, 6, seed=5)
    _, a = tm.prefill(tm.load(state), tm.init_cache(2, 6), tb)
    _, b = tm.prefill(tp, tm.init_cache(2, 6), tb)
    assert torch.equal(a, b)


def test_input_specs_and_dummy_batch_match_reference(pair):
    from repro.configs.base import ShapeConfig as JShape
    from repro_torch.configs.base import ShapeConfig

    cfg, jm, _, tm, _ = pair("float32")
    for kind in ("prefill", "decode"):
        want = jm.input_specs(JShape("x", 12, 2, kind))
        got = tm.input_specs(ShapeConfig("x", 12, 2, kind))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    batch = tm.dummy_batch(ShapeConfig("x", 12, 2, "prefill"))
    assert batch["frames"].dtype == torch.float32
    assert 0.01 < float(batch["frames"].std()) < 0.03
    assert int(batch["tokens"].max()) < cfg.vocab_size


LOSS_OPTS = {"plain": {}, "remat": {"remat": "full"}}


@pytest.mark.parametrize("opts", list(LOSS_OPTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype, opts, pair):
    """Model.loss (ce) and every gradient against jax.value_and_grad of the
    reference's encdec_loss, on the frames the launcher draws, with and
    without remat="full" (each encoder and decoder block recomputed)."""
    from repro_torch.launch.train import train_batch
    from test_torch_train import check_loss_against_jax

    _, _, jp, tm, _ = pair(dtype)
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    calls = flash_attention_plain.calls
    check_loss_against_jax(ARCH, dtype, jp, train_batch(tm.cfg, toks, 1), LOSS_OPTS[opts])
    # the encoder, each decoder layer's self and cross: once each, twice under remat
    layers = tm.cfg.enc_layers + 2 * tm.cfg.n_layers
    assert flash_attention_plain.calls == calls + layers * (1 + (opts == "remat"))


def test_chunked_loss_matches_jax(pair):
    """The CE in sequence chunks (loss_chunk 4 of 12 tokens), f32."""
    from repro_torch.launch.train import train_batch
    from test_torch_train import check_loss_against_jax

    _, _, jp, tm, _ = pair("float32")
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    check_loss_against_jax(ARCH, "float32", jp, train_batch(tm.cfg, toks, 2), {"loss_chunk": 4})


def test_loss_refuses_a_batch_without_frames(pair):
    _, _, _, tm, tp = pair("float32")
    _, tb = _batches(tm.cfg, 2, 8)
    calls = flash_attention_plain.calls
    with pytest.raises(ValueError, match="it takes 'tokens' and 'frames'"):
        tm.loss(tp, {"tokens": tb["tokens"]})
    assert flash_attention_plain.calls == calls


@pytest.mark.parametrize("n_frames", [8, 24])
def test_other_frame_count_raises(n_frames, pair):
    """The port serves exactly n_frames frames (ROADMAP Quirks): fewer would
    leave cross-cache slots the reference's decode reads unwritten."""
    _, _, _, tm, tp = pair("float32")
    _, tb = _batches(tm.cfg, 2, 8)
    frames = torch.zeros((2, n_frames, tm.cfg.d_model))
    calls = flash_attention_plain.calls
    with pytest.raises(ValueError, match=f"{n_frames} frames.*n_frames = 16.*Quirks"):
        tm.prefill(tp, tm.init_cache(2, 8), dict(tb, frames=frames))
    assert flash_attention_plain.calls == calls


@pytest.mark.parametrize("batch", ["no_frames", "patches"])
def test_batch_keys_checked(batch, pair):
    _, _, _, tm, tp = pair("float32")
    _, tb = _batches(tm.cfg, 2, 8)
    bad = {"tokens": tb["tokens"]} if batch == "no_frames" else \
        dict(tb, patches=torch.zeros((2, 4, tm.cfg.d_model)))
    with pytest.raises(ValueError, match="it takes 'tokens' and 'frames'"):
        tm.prefill(tp, tm.init_cache(2, 8), bad)


def test_launcher_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--gen", "3"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} on cpu: batch=2 prompt=8 gen=3" in out
