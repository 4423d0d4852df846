"""The port's vision decoder (phi-3-vision-4.2b) against the JAX package on
the same weights.

Reduced phi-3-vision-4.2b is initialised by JAX, carried across with
``repro_torch.convert`` and served by both on the same patch embeddings and
tokens (numpy draws; the patches take the first positions of the prompt,
``patch_proj`` projects them): prefill logits, the KV cache (patches and
text) and 4 decode steps must match (f32 at 1e-4 relative, bf16 at 3e-2,
the TOL of tests/test_torch_serve.py), greedy tokens must be equal in f32,
the port's decode must match its own prefill (rel < 0.08, the bound of
tests/test_models_smoke.py), and ``patches + 1.0`` must change the logits
(tests/test_models_smoke.py:103).  Conversion is bit-exact both ways.  The
refusals: the loss (ROADMAP A18b) and a launcher prompt no longer than the
patches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_jax_numpy, params_to_jax_numpy
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import prompt_batch
from repro_torch.models import build
from repro_torch.serve.engine import ServeEngine

ARCH = "phi-3-vision-4.2b"
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
    """The same prompt of S positions (n_patches patches, then S - n_patches
    tokens) for both frameworks."""
    arrs = prompt_batch(cfg, B, S, seed)
    jb = {k: jnp.asarray(a.astype(np.int32) if k == "tokens" else a) for k, a in arrs.items()}
    return jb, {k: torch.from_numpy(a) for k, a in arrs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_and_decode_match_jax(dtype, pair):
    cfg, jm, jp, tm, tp = pair(dtype)
    jb, tb = _batches(tm.cfg, 2, 20, seed=1)
    assert tb["patches"].shape == (2, cfg.n_patches, cfg.d_model)
    jc, jl = jax.jit(jm.prefill)(jp, jm.init_cache(2, 32), jb)
    tc, tl = tm.prefill(tp, tm.init_cache(2, 32), tb)
    assert tc["pos"] == int(jc["pos"]) == 20          # patches and text
    assert _rel(_np(tl), jl) < TOL[dtype]
    for key in ("k", "v"):
        assert _rel(_np(tc["layers"][key]), jc["layers"][key]) < TOL[dtype], key
    nxt = np.argmax(np.asarray(jnp.asarray(jl, jnp.float32)), -1).astype(np.int32)
    step = jax.jit(jm.decode_step)
    for _ in range(4):
        jc, jl = step(jp, jc, jnp.asarray(nxt))
        tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
        assert _rel(_np(tl), jl) < TOL[dtype]
        nxt = np.argmax(np.asarray(jnp.asarray(jl, jnp.float32)), -1).astype(np.int32)
    assert tc["pos"] == int(jc["pos"]) == 24


def test_text_only_prompt_matches_jax(pair):
    """Without patches the reference embeds the text alone; so does the port."""
    cfg, jm, jp, tm, tp = pair("float32")
    jb, tb = _batches(tm.cfg, 2, 20, seed=2)
    jc, jl = jax.jit(jm.prefill)(jp, jm.init_cache(2, 16), {"tokens": jb["tokens"]})
    tc, tl = tm.prefill(tp, tm.init_cache(2, 16), tb["tokens"])
    assert tc["pos"] == int(jc["pos"]) == 20 - cfg.n_patches
    assert _rel(_np(tl), jl) < TOL["float32"]


def test_greedy_tokens_equal_jax(pair):
    cfg, jm, jp, tm, tp = pair("float32")
    jb, tb = _batches(tm.cfg, 2, 16, seed=3)
    want = JServeEngine(jm, jp, max_len=24).generate(jb, steps=5)
    got = ServeEngine(tm, tp, max_len=24).generate(tb, steps=5)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_prefill(pair):
    """prefill(t[:k]) + decode(t[k]) equals prefill(t[:k+1]) behind the same patches."""
    _, _, _, tm, tp = pair("bfloat16")
    _, tb = _batches(tm.cfg, 2, 24, seed=4)
    toks = tb["tokens"]
    k = toks.shape[1] - 1
    _, par = tm.prefill(tp, tm.init_cache(2, 32), tb)
    cache, _ = tm.prefill(tp, tm.init_cache(2, 32), dict(tb, tokens=toks[:, :k]))
    _, dec = tm.decode_step(tp, cache, toks[:, k])
    assert _rel(_np(dec), _np(par)) < 0.08


def test_patches_change_logits(pair):
    """tests/test_models_smoke.py:103 in the port: patches + 1.0 moves the logits."""
    _, _, _, tm, tp = pair("float32")
    _, tb = _batches(tm.cfg, 2, 16, seed=5)
    _, a = tm.prefill(tp, tm.init_cache(2, 16), tb)
    _, b = tm.prefill(tp, tm.init_cache(2, 16), dict(tb, patches=tb["patches"] + 1.0))
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conversion_both_ways_bit_exact(dtype, pair):
    cfg, _, jp, tm, tp = pair(dtype)
    state = tp.state_dict()
    assert state["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    back = params_to_jax_numpy(state)
    want = jax.tree.map(np.asarray, jp)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        got = flat_back[path]
        w = w.view(np.uint16) if w.dtype == jnp.bfloat16 else w
        assert got.dtype == w.dtype and np.array_equal(got, w), path
    assert len(flat_back) == len(jax.tree.leaves(want))


def test_input_specs_and_dummy_batch_match_reference(pair):
    """S counts the patches: S - n_patches tokens, as the reference's
    input_specs; the stub is f32 normals x 0.02."""
    from repro.configs.base import ShapeConfig as JShape
    from repro_torch.configs.base import ShapeConfig

    cfg, jm, _, tm, _ = pair("float32")
    for kind in ("prefill", "decode"):
        want = jm.input_specs(JShape("x", 20, 2, kind))
        got = tm.input_specs(ShapeConfig("x", 20, 2, kind))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    batch = tm.dummy_batch(ShapeConfig("x", 20, 2, "prefill"))
    assert batch["tokens"].shape == (2, 20 - cfg.n_patches)
    assert batch["patches"].dtype == torch.float32
    assert 0.01 < float(batch["patches"].std()) < 0.03


def test_loss_raises_naming_a18b(pair):
    """The loss raises before any forward: it must not quietly drop the patches."""
    _, _, _, tm, tp = pair("float32")
    _, tb = _batches(tm.cfg, 2, 16)
    calls = flash_attention_plain.calls
    with pytest.raises(NotImplementedError, match="ROADMAP A18b"):
        tm.loss(tp, tb)
    with pytest.raises(NotImplementedError, match="ROADMAP A18b"):
        tp(tb, tm.opts)
    assert flash_attention_plain.calls == calls


def test_launcher_on_cpu(capsys):
    serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "12",
                "--gen", "3"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} on cpu: batch=2 prompt=12 gen=3" in out


@pytest.mark.parametrize("prompt_len", [4, 8])
def test_launcher_refuses_prompt_within_the_patches(prompt_len, monkeypatch):
    """--prompt-len counts the 8 patches and the text: at most 8 leaves no
    text, refused before anything is built."""
    import repro_torch.models as models

    monkeypatch.setattr(models, "build", lambda *a, **k: pytest.fail("built a model"))
    with pytest.raises(ValueError, match=f"--prompt-len {prompt_len} counts its 8 patches"):
        serve_main(["--arch", ARCH, "--device", "cpu", "--prompt-len", str(prompt_len)])
