"""The port's MoE / MLA serving family against the JAX package.

``repro_torch.models.moe.moe_apply`` against ``repro.models.moe.moe_apply``
and ``repro_torch.models.mla`` against ``repro.models.mla`` on the same
seeded numpy inputs and weights (f32 at 1e-4 relative, bf16 at 3e-2, the
bounds of tests/test_torch_serve.py): without drops (capacity factor 8),
with the config's 1.25 under a skewed load, where the same tokens must come
back zero, with dispatch chunks smaller than the batch (the mean aux loss),
with and without shared experts, gated and plain activations; the experts
picked must be the same on the same input.  Then reduced moonshot-v1-16b-a3b
and deepseek-v3-671b, prefill and 4 decode steps with their caches, against
the JAX model on converted weights; the port's decode against its own
prefill; the group-aware weight conversion bit for bit; the flash
forward's plain version at d 192 / dv 128 against the reference's
``attention``; and the head-dim pairs the backward refuses.

A pick is a discontinuous function of the router's input, and bf16 rounding
differs between the frameworks (the reference's tiled attention rounds its
probabilities to bf16; the port's does not), so a token whose top-k margin
is below that noise can pick another expert in each and then differ by
O(1).  On the reduced configs three tokens of 48 do (logit gaps of 3e-4 to
7e-4).  The bf16 whole-model checks therefore run the port under the JAX
model's picks (recorded from ``jax.lax.top_k``, replayed through
``moe.ROUTE_LOG``) and hold everything else at 3e-2; the routers themselves
are held to each other on the same inputs in ``test_moe_apply_matches_jax``,
in both dtypes, where they must pick the same experts.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.train.checkpoint import CheckpointManager
from repro_torch import configs
from repro_torch.convert import params_from_jax_numpy, params_to_jax_numpy, read_checkpoint
from repro_torch.kernels.flash_attention import _check, flash_attention_plain
from repro_torch.models import build, mla, moe
from repro_torch.models.attention import attention
from repro_torch.models.transformer import ModelOpts

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# elementwise, as tests/test_torch_attention.py (the bounds of tests/test_kernels.py)
ATTN_TOL = {"float32": dict(atol=2e-4, rtol=2e-4), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MOE_ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]


def _rel(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arr: np.ndarray, dtype: str):
    """The same f32 numpy draw as a JAX array and a torch tensor of dtype."""
    return jnp.asarray(arr, JDT[dtype]), torch.from_numpy(arr).to(TDT[dtype])


@contextlib.contextmanager
def jax_picks(monkeypatch):
    """Record the experts every ``jax.lax.top_k`` of the reference's MoE
    picks, in call order (functions traced inside the context only)."""
    picks: list[np.ndarray] = []
    top_k = jax.lax.top_k

    def recording(x, k):
        gates, eidx = top_k(x, k)
        jax.debug.callback(lambda e: picks.append(np.array(e)), eidx, ordered=True)
        return gates, eidx

    monkeypatch.setattr(jax.lax, "top_k", recording)
    yield picks
    jax.effects_barrier()
    monkeypatch.setattr(jax.lax, "top_k", top_k)


@contextlib.contextmanager
def route_log(replay=None):
    """``moe.ROUTE_LOG`` for the duration: the port's picks, or a replay."""
    moe.ROUTE_LOG = moe.RouteLog([torch.from_numpy(p).long() for p in replay or []])
    try:
        yield moe.ROUTE_LOG
    finally:
        moe.ROUTE_LOG = None


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _moe_weights(cfg, rng, skew: bool) -> dict:
    """One layer's MoE weights as f32 numpy: router (D,E), we_in (E,D,fin),
    we_out (E,F,D), shared {wi, wo}; with ``skew`` experts 0 and 1 draw most
    tokens, so their slots overflow at capacity factor 1.25."""
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    fin = 2 * F if cfg.act in ("swiglu", "geglu") else F
    router = rng.normal(0, 0.02, (D, E))
    if skew:
        router[:, :2] += 0.05
    w = {"router": router,
         "we_in": rng.normal(0, D ** -0.5, (E, D, fin)),
         "we_out": rng.normal(0, F ** -0.5, (E, F, D))}
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        w["shared"] = {"wi": rng.normal(0, D ** -0.5, (D, fin // F * Fs)),
                       "wo": rng.normal(0, Fs ** -0.5, (Fs, D))}
    return jax.tree.map(lambda a: a.astype(np.float32), w)


MOE_CASES = {
    # name: (capacity_factor, token_chunk, n_shared_experts, act, skew)
    "dropless": (8.0, 65536, 1, "swiglu", False),
    "drops": (1.25, 65536, 0, "swiglu", True),
    "drops_shared_gelu": (1.25, 65536, 1, "gelu", True),
    "chunked": (1.25, 16, 1, "swiglu", True),
    "chunk_not_dividing": (1.25, 24, 0, "gelu", False),
    "plain_act_dropless": (8.0, 65536, 0, "gelu", False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case, dtype):
    cf, chunk, shared, act, skew = MOE_CASES[case]
    cfg = configs.get_reduced("moonshot-v1-16b-a3b").with_(
        capacity_factor=cf, n_shared_experts=shared, act=act, dtype=dtype)
    jcfg = jconfigs.get_reduced("moonshot-v1-16b-a3b").with_(
        capacity_factor=cf, n_shared_experts=shared, act=act, dtype=dtype)
    rng = np.random.default_rng(sorted(MOE_CASES).index(case))
    w = _moe_weights(cfg, rng, skew)
    x = rng.normal(0.5 if skew else 0.0, 1.0, (2, 32, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jp = {k: (jnp.asarray(v) if k == "router" else jax.tree.map(
        lambda a: jnp.asarray(a, JDT[dtype]), v)) for k, v in w.items()}
    want, want_aux = jmoe.moe_apply(jp, jx, jcfg, token_chunk=chunk)

    layer = moe.MoE(cfg, "cpu", TDT[dtype])
    state = {k: torch.from_numpy(v) for k, v in w.items() if k != "shared"}
    state.update({f"shared.{k}": torch.from_numpy(v) for k, v in w.get("shared", {}).items()})
    layer.load_state_dict({k: v.to(layer.state_dict()[k].dtype) for k, v in state.items()})
    with torch.no_grad(), route_log() as log:
        got, aux = moe.moe_apply(layer, tx, cfg, token_chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    assert _rel(got, want) < TOL[dtype]
    assert abs(float(aux) - float(want_aux)) <= 1e-4 * abs(float(want_aux))

    # Same input, same picks: each chunk's router against jax.lax.top_k.
    n_chunks = 64 // chunk if 64 % chunk == 0 else 1
    assert len(log.seen) == n_chunks
    for xc, probs, eidx in log.seen:
        jprobs = jax.nn.softmax(jnp.asarray(_f32(xc)) @ jnp.asarray(w["router"]), axis=-1)
        _, jeidx = jax.lax.top_k(jprobs, cfg.top_k)
        np.testing.assert_array_equal(eidx.numpy(), np.asarray(jeidx))

    # Tokens whose every pick was dropped come back zero in both, and only those.
    if skew and not shared:
        zero_want = np.all(_f32(want).reshape(-1, cfg.d_model) == 0, axis=-1)
        zero_got = np.all(_f32(got).reshape(-1, cfg.d_model) == 0, axis=-1)
        assert zero_want.any(), "the skewed load dropped no token"
        np.testing.assert_array_equal(zero_got, zero_want)


def test_capacity_matches_reference_expression():
    cfg = configs.get("deepseek-v3-671b")
    for chunk in (4, 300, 2048, 65536):
        want = max(8, int(cfg.capacity_factor * chunk * cfg.top_k / cfg.n_experts))
        assert moe.capacity_of(cfg, chunk) == -(-want // 8) * 8
    assert moe.capacity_of(cfg, 2048) == 80 and moe.capacity_of(cfg, 4) == 8


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_pair(cfg, dtype, seed=0):
    """One MLA layer with the same weights in both: (jax params, port module)."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in mla.MLA(cfg, "meta", torch.float32)
              .state_dict().items()}
    w = {k: (rng.normal(0, 0.1, s) if len(s) == 1 else rng.normal(0, s[0] ** -0.5, s))
         .astype(np.float32) for k, s in shapes.items()}
    layer = mla.MLA(cfg, "cpu", TDT[dtype])
    layer.load_state_dict({k: torch.from_numpy(v).to(TDT[dtype]) for k, v in w.items()})
    return {k: jnp.asarray(v, JDT[dtype]) for k, v in w.items()}, layer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_matches_jax(dtype):
    cfg = configs.get_reduced("deepseek-v3-671b").with_(dtype=dtype)
    jcfg = jconfigs.get_reduced("deepseek-v3-671b").with_(dtype=dtype)
    jp, layer = _mla_pair(cfg, dtype)
    x = np.random.default_rng(1).normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jmla.mla_attention(jp, jx, jcfg, jnp.arange(24)[None, :])
    with torch.no_grad():
        got, c_kv, k_pe = mla.mla_prefill(layer, tx, cfg, torch.arange(24)[None, :])
        assert torch.equal(mla.mla_attention(layer, tx, cfg, torch.arange(24)[None, :]), got)
    assert got.shape == (2, 24, cfg.d_model)
    assert _rel(got, want) < TOL[dtype]
    jc, jpe = jmla._compress_kv(jp, jx, jcfg, jnp.arange(24)[None, :])
    assert _rel(c_kv, jc) < TOL[dtype] and _rel(k_pe, jpe) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(dtype):
    """Caches of a 20-token prefix, then 3 absorbed decode steps: outputs and
    the latent caches written in place against the reference's."""
    cfg = configs.get_reduced("deepseek-v3-671b").with_(dtype=dtype)
    jcfg = jconfigs.get_reduced("deepseek-v3-671b").with_(dtype=dtype)
    jp, layer = _mla_pair(cfg, dtype, seed=2)
    B, P, Smax = 2, 20, 32
    x = np.random.default_rng(3).normal(0, 1, (B, P + 3, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jc0, jpe0 = jmla._compress_kv(jp, jx[:, :P], jcfg, jnp.arange(P)[None, :])
    jc = jnp.zeros((B, Smax, cfg.kv_lora_rank), JDT[dtype]).at[:, :P].set(jc0)
    jpe = jnp.zeros((B, Smax, cfg.qk_rope_dim), JDT[dtype]).at[:, :P].set(jpe0)
    tc = torch.zeros((B, Smax, cfg.kv_lora_rank), dtype=TDT[dtype])
    tpe = torch.zeros((B, Smax, cfg.qk_rope_dim), dtype=TDT[dtype])
    with torch.no_grad():
        c0, pe0 = mla.compress_kv(layer, tx[:, :P], cfg, torch.arange(P)[None, :])
        tc[:, :P], tpe[:, :P] = c0, pe0
        for t in range(P, P + 3):
            want, jc, jpe = jmla.mla_decode(jp, jx[:, t:t + 1], jcfg, jc, jpe, t)
            got = mla.mla_decode(layer, tx[:, t:t + 1], cfg, tc, tpe, t)
            assert got.shape == (B, 1, cfg.d_model)
            assert _rel(got, want) < TOL[dtype]
        assert _rel(tc, jc) < TOL[dtype] and _rel(tpe, jpe) < TOL[dtype]
        with pytest.raises(ValueError, match="cache full"):
            mla.mla_decode(layer, tx[:, :1], cfg, tc, tpe, Smax)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

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
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_whole_model_prefill_decode_and_caches_match_jax(arch, dtype, pair, monkeypatch):
    """Prefill 2 x 24 and 4 greedy decode steps: logits at every step and the
    caches of both layer groups after the last.  bf16 runs under the JAX
    model's picks (see the module docstring); f32 routes on its own."""
    cfg, jm, jp, tm, tp = pair(arch, dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jsteps, picks = [], []
    with contextlib.ExitStack() as stack:
        if dtype == "bfloat16":
            picks = stack.enter_context(jax_picks(monkeypatch))
        # fresh functions: traced here, so the recording top_k is in them
        jc, jl = jax.jit(lambda *a: jm.prefill(*a))(jp, jm.init_cache(2, 48),
                                                    {"tokens": jnp.asarray(toks)})
        jsteps.append(jl)
        step = jax.jit(lambda *a: jm.decode_step(*a))
        for _ in range(4):
            nxt = np.argmax(_f32(jsteps[-1]), -1).astype(np.int32)
            jc, jl = step(jp, jc, jnp.asarray(nxt))
            jsteps.append(jl)
    n_moe_calls = 5 * cfg.n_moe_layers
    assert len(picks) == (n_moe_calls if dtype == "bfloat16" else 0)

    with route_log(picks) as log:
        tc, tl = tm.prefill(tp, tm.init_cache(2, 48), torch.from_numpy(toks).long())
        rel = [_rel(tl, jsteps[0])]
        for i in range(4):
            nxt = np.argmax(_f32(jsteps[i]), -1)
            tc, tl = tm.decode_step(tp, tc, torch.from_numpy(nxt).long())
            rel.append(_rel(tl, jsteps[i + 1]))
    assert len(log.seen) == n_moe_calls and not log.replay
    assert max(rel) < TOL[dtype], rel
    assert tc["pos"] == int(jc["pos"]) == 28
    groups = ("dense_layers", "moe_layers")
    names = ("c", "pe") if cfg.mla else ("k", "v")
    assert set(tc) == {"pos", *groups} and all(set(tc[g]) == set(names) for g in groups)
    for g in groups:
        for name in names:
            assert tc[g][name].shape == jc[g][name].shape
            assert _rel(tc[g][name], jc[g][name]) < TOL[dtype], (g, name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_prefill(arch):
    """prefill(t[:k]) + decode(t[k]) equals prefill(t[:k+1]) in the port: the
    reference's check (tests/test_models_smoke.py), at its capacity factor 8
    (token dropping depends on the sequence length by design), on bf16
    weights drawn by the port, with the cache path under the picks of the
    parallel one (see the module docstring; on the JAX package's weights,
    reduced deepseek-v3's decode flips one of its last token's picks under
    its own routing, a margin of 4e-4 in probability, and misses the bound).
    The routers are held to each other in test_moe_apply_matches_jax."""
    cfg = configs.get_reduced(arch).with_(capacity_factor=8.0)
    m = build(cfg, device="cpu", seed=0)
    params = m.init()
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16)))
    k = toks.shape[1] - 1
    with route_log() as par_log:
        _, par = m.prefill(params, m.init_cache(2, 32), toks)
    picks = [e.view(2, k + 1, -1) for _, _, e in par_log.seen]
    replay = [e[:, :k].reshape(2 * k, -1) for e in picks] + [e[:, k] for e in picks]
    with route_log([e.numpy() for e in replay]) as log:
        cache, _ = m.prefill(params, m.init_cache(2, 32), toks[:, :k])
        _, dec = m.decode_step(params, cache, toks[:, k])
    assert not log.replay and all(torch.equal(a[2], b) for a, b in zip(log.seen, replay))
    assert torch.isfinite(dec.float()).all()
    assert _rel(dec, par) < 0.08


def test_token_chunk_is_a_serving_knob(pair):
    """ModelOpts.moe_token_chunk reaches the MoE layers of prefill: a chunk
    of 8 tokens splits a 2 x 24 prompt's dispatch in six."""
    cfg, _, _, tm, tp = pair("moonshot-v1-16b-a3b", "float32")
    chunked = build(tm.cfg, device="cpu", opts=ModelOpts(moe_token_chunk=8))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 24)))
    with route_log() as log:
        chunked.prefill(tp, chunked.init_cache(2, 32), toks)
    assert [xc.shape[0] for xc, _, _ in log.seen] == [8] * 6 * cfg.n_moe_layers


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_group_aware_conversion_round_trip(arch, dtype, pair, tmp_path):
    """JAX tree -> port state -> JAX tree, and a checkpoint's flat arrays ->
    port state, bit for bit: each group unstacked by its own count, the MTP
    block's axis of 1 dropped, the f32 router kept f32."""
    cfg, _, jp, tm, tp = pair(arch, dtype)
    tree = jax.tree.map(np.asarray, jp)
    state = params_from_jax_numpy(tree, tm.cfg)
    assert f"dense_layers.{cfg.n_dense_layers - 1}.ln1" in state
    assert f"moe_layers.{cfg.n_moe_layers - 1}.moe.we_in" in state
    assert f"moe_layers.{cfg.n_moe_layers}.ln1" not in state
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert state["moe_layers.0.moe.we_in"].shape == (E, D, 2 * F)
    assert state["moe_layers.0.moe.we_out"].shape == (E, F, D)
    assert state["moe_layers.0.moe.router"].dtype == torch.float32
    assert state["moe_layers.0.moe.we_in"].dtype == TDT[dtype]
    assert ("mtp.layer.ln1" in state) == bool(cfg.mtp_depth)
    if cfg.mtp_depth:
        assert state["mtp.layer.ln1"].shape == (D,) and state["mtp.proj"].shape == (2 * D, D)
    back = params_to_jax_numpy(state)
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(str, got)) == set(map(str, want))
    for path, a in want.items():
        np.testing.assert_array_equal(_bits(got[path]), _bits(a), err_msg=str(path))
    CheckpointManager(tmp_path, async_save=False).save(1, jp)
    flat = params_from_jax_numpy(read_checkpoint(tmp_path / "step_000000001"), tm.cfg)
    for k, v in tp.state_dict().items():
        assert flat[k].dtype == v.dtype and torch.equal(flat[k], v), k


@pytest.mark.parametrize("breakage", ["group_count", "mtp_axis"])
def test_converter_rejects_wrong_group_axis(breakage, pair):
    cfg, _, jp, tm, _ = pair("deepseek-v3-671b", "float32")
    tree = jax.tree.map(np.asarray, jp)
    if breakage == "group_count":     # a dense group stacked as long as the MoE one
        tree["dense_layers"]["ln1"] = np.concatenate([tree["dense_layers"]["ln1"]] * 3)
    else:
        tree["mtp"]["layer"]["ln1"] = np.concatenate([tree["mtp"]["layer"]["ln1"]] * 2)
    with pytest.raises(ValueError, match="leading axis"):
        params_from_jax_numpy(tree, tm.cfg)


# ---------------------------------------------------------------------------
# The flash forward at d 192 / dv 128, and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk", [(40, 40), (24, 72)])
def test_plain_at_192_128_matches_reference_attention(Sq, Sk, dtype):
    rng = np.random.default_rng(7)
    q, k = (rng.normal(0, 1, (2, s, 2, 192)).astype(np.float32) for s in (Sq, Sk))
    v = rng.normal(0, 1, (2, Sk, 2, 128)).astype(np.float32)
    (jq, q), (jk, k), (jv, v) = (_pair(a, dtype) for a in (q, k, v))
    scale = 1.0 / math.sqrt(192)
    want = jattn.attention(jq, jk, jv, causal=True, chunk_q=8, chunk_k=24, scale=scale)
    _check(q, k, v)
    o, lse = flash_attention_plain(q, k, v, causal=True, scale=scale, block_q=16, block_k=32)
    assert o.shape == (2, Sq, 2, 128) and o.dtype == TDT[dtype]
    np.testing.assert_allclose(_f32(o), _f32(want), **ATTN_TOL[dtype])
    with torch.no_grad():
        np.testing.assert_allclose(_f32(attention(q, k, v, scale=scale)), _f32(want),
                                   **ATTN_TOL[dtype])


@pytest.mark.parametrize("d,dv", [(192, 64), (128, 64), (80, 80), (192, 192), (128, 192)])
def test_kernel_refuses_other_head_dim_pairs(d, dv):
    q, k = torch.zeros(1, 8, 2, d), torch.zeros(1, 8, 2, d)
    v = torch.zeros(1, 8, 2, dv)
    with pytest.raises(ValueError, match=f"head dims \\(d {d}, dv {dv}\\) not supported"):
        _check(q, k, v)


@pytest.mark.parametrize("d,dv", [(192, 64), (128, 64), (80, 80), (192, 192), (128, 192)])
def test_backward_refuses_other_head_dim_pairs(d, dv):
    """The backward takes the forward's pairs, (192, 128) and (96, 96)
    among them; any other raises before launch."""
    from repro_torch.kernels.flash_attention import _check_bwd

    q, k = torch.zeros(1, 8, 2, d), torch.zeros(1, 8, 2, d)
    v, o = torch.zeros(1, 8, 2, dv), torch.zeros(1, 8, 2, dv)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match=f"head dims \\(d {d}, dv {dv}\\) not supported by "
                                         f"the backward"):
        _check_bwd(q, k, v, o, lse, o)
    qk, vo = torch.zeros(1, 8, 2, 192), torch.zeros(1, 8, 2, 128)
    _check_bwd(qk, qk, vo, vo, lse, vo)                 # MLA's pair passes
    qkv = torch.zeros(1, 8, 2, 96)
    _check_bwd(qkv, qkv, qkv, qkv, lse, qkv)            # and phi-3-vision's


@pytest.mark.parametrize("arch,extra", [("moonshot-v1-16b-a3b", []),
                                        ("deepseek-v3-671b", ["--layers", "3"])])
def test_serve_launcher_serves_moe_on_cpu(arch, extra, capsys):
    """launch.serve on the reduced configs (``--layers`` cuts the depth,
    keeping the dense layer and the widths)."""
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--arch", arch, "--gen", "2", "--prompt-len", "6", *extra])
    assert f"[serve] {arch} on cpu: batch=4 prompt=6 gen=2" in capsys.readouterr().out
