"""The port's training launcher against the JAX package's, on the CPU.

* From the same weights (a JAX checkpoint at step 0) and the same data, the
  port's ``launch.train.train`` follows ``repro.launch.train.train``'s loss
  trajectory: f32 rel 1e-4 over 3 steps.
* Twins of tests/test_train_loop.py on ``device="cpu"``, at its bounds:
  the loss decreases, crash-resume matches the uninterrupted run (rel 1e-4),
  a GA 1 -> 2 switch across a restart keeps the trajectory (2e-2), GA = 4
  matches the full batch (2e-2), remat matches no remat (1e-3).
* Checkpoints cross frameworks both ways: a JAX checkpoint resumed by the
  port and a port checkpoint restored by ``repro.train.checkpoint.
  CheckpointManager.restore`` hold exactly the same leaves, and each resumed
  run ends within rel 1e-3 of the uninterrupted one.
* The encoder-decoder and the vision decoder (seamless-m4t-large-v2,
  phi-3-vision-4.2b): the launcher draws the modality stub as the
  reference's does (``launch.train.train_batch``), and checkpoints cross
  both ways as above, each resumed run ending on the other framework's
  loss; a vision ``--seq`` within the patches is refused.
* The MoE family (moonshot-v1-16b-a3b, deepseek-v3-671b): the launcher's
  3-step f32 trajectory against the reference's at 1e-4 (deepseek also
  under GA 2 and GC); params and optimizer state (the dense and MoE layer
  groups, the MTP block, the f32 router beside bf16 experts) through each
  framework's checkpoint into the other's, leaf for leaf.

The f32 runs swap each package's ``configs.get_reduced`` for one that
returns the reduced config in float32 (neither launcher takes a dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch.train import train as jtrain
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import opt_init as jopt_init
from repro_torch import configs
from repro_torch.convert import opt_state_to_jax_numpy, params_to_jax_numpy, read_checkpoint
from repro_torch.launch.train import train


def _cpu_train(**kw):
    return train(device="cpu", log_every=1000, **kw)


@pytest.fixture
def float32_configs(monkeypatch):
    for mod in (jconfigs, configs):
        get = mod.get_reduced
        monkeypatch.setattr(mod, "get_reduced",
                            lambda arch, get=get: get(arch).with_(dtype="float32"))


def test_trajectory_matches_jax_launcher(tmp_path, float32_configs):
    """Step 0 written by JAX, 3 steps by each framework on the same batches."""
    kw = dict(arch="llama2-7b", reduced=True, batch=4, seq=32)
    jtrain(steps=0, ckpt_dir=str(tmp_path / "jax"), log_every=1000, **kw)
    want = jtrain(steps=3, log_every=1000, **kw)["losses"]
    got = _cpu_train(steps=3, ckpt_dir=str(tmp_path / "jax"), **kw)["losses"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)


STUB_ARCHS = ["seamless-m4t-large-v2", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("arch", [*STUB_ARCHS, "llama2-7b"])
def test_train_batch_draws_the_stub_as_the_reference(arch, step):
    """The reference's launcher (src/repro/launch/train.py:67-79): for step
    n, np.random.default_rng(n).normal(0, 0.02, (B, n, D)) as f32 frames or
    patches, a vision decoder's tokens cut to seq - n_patches; no stub
    otherwise."""
    from repro_torch.launch.train import train_batch

    cfg = configs.get_reduced(arch)
    tokens = np.arange(4 * 32, dtype=np.int32).reshape(4, 32)
    got = train_batch(cfg, tokens, step)
    if arch == "llama2-7b":
        assert list(got) == ["tokens"] and got["tokens"] is tokens
        return
    key, n = (("patches", cfg.n_patches) if cfg.frontend == "vision"
              else ("frames", cfg.n_frames))
    want = np.asarray(jnp.asarray(np.random.default_rng(step).normal(
        0, 0.02, (4, n, cfg.d_model)), jnp.float32))
    assert sorted(got) == sorted(["tokens", key])
    assert got[key].dtype == np.float32 and np.array_equal(got[key], want)
    cut = 32 - n if key == "patches" else 32
    np.testing.assert_array_equal(got["tokens"], tokens[:, :cut])


@pytest.mark.parametrize("seq", [4, 8])
def test_launcher_refuses_seq_within_the_patches(seq, tmp_path, monkeypatch):
    """--seq counts the 8 patches and the text: at most 8 leaves no text
    (the reference slices its tokens with a negative end there: ROADMAP
    Quirks), refused before anything is built or written."""
    import repro_torch.models as models
    from repro_torch.launch.train import main

    monkeypatch.setattr(models, "build", lambda *a, **k: pytest.fail("built a model"))
    with pytest.raises(ValueError, match=f"--seq {seq} counts its 8 patches"):
        main(["--arch", "phi-3-vision-4.2b", "--device", "cpu", "--seq", str(seq),
              "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())


MOE_TRAJECTORIES = [("moonshot-v1-16b-a3b", {}), ("deepseek-v3-671b", {}),
                    ("deepseek-v3-671b", {"ga_steps": 2}), ("deepseek-v3-671b", {"gc": True})]


@pytest.mark.parametrize("arch,plan_kw", MOE_TRAJECTORIES,
                         ids=["moonshot", "deepseek", "deepseek-ga2", "deepseek-gc"])
def test_moe_trajectory_matches_jax_launcher(arch, plan_kw, tmp_path, float32_configs):
    """As test_trajectory_matches_jax_launcher for the MoE family: the aux
    and MTP losses in the step, GA 2 splitting each batch's dispatch, GC
    recomputing each MoE block under its forward's picks."""
    kw = dict(arch=arch, reduced=True, batch=4, seq=16, plan_kw=plan_kw)
    jtrain(steps=0, ckpt_dir=str(tmp_path / "jax"), log_every=1000, **kw)
    want = jtrain(steps=3, log_every=1000, **kw)["losses"]
    got = _cpu_train(steps=3, ckpt_dir=str(tmp_path / "jax"), **kw)["losses"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_moe_checkpoint_crosses_frameworks(arch, dtype, tmp_path):
    """A port checkpoint (moments drawn from a seed, count 3) restored by
    the reference's CheckpointManager, then saved by it and restored by the
    port: every param and moment leaf the same bits both ways."""
    import torch

    from repro.models import build as jbuild
    from repro_torch.models import build
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, opt_init

    cfg = configs.get_reduced(arch).with_(dtype=dtype)
    params = build(cfg, device="cpu").init()
    opt_state = opt_init(params, OptConfig())
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for k in ("m", "v"):
            for t in opt_state[k].values():
                t.copy_(torch.from_numpy(rng.normal(0, 1, tuple(t.shape))))
    opt_state["count"] = 3
    assert params.moe_layers[0].moe.router.dtype == torch.float32
    CheckpointManager(tmp_path / "port", async_save=False).save(3, params, opt_state)

    jm = jbuild(jconfigs.get_reduced(arch).with_(dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(1))
    jp, jst, meta = JCheckpointManager(tmp_path / "port").restore(jp, jopt_init(jp, JOptConfig()))
    assert meta["step"] == 3 and int(jst["count"]) == 3
    want = _port_arrays(params, opt_state)
    got = {**_flat_jax_arrays(jp, "params"), **_flat_jax_arrays(jst, "opt")}
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and np.array_equal(got[key], arr), key

    JCheckpointManager(tmp_path / "jax", async_save=False).save(3, jp, jst)
    fresh = build(cfg, device="cpu", seed=1).init()
    fresh, fresh_opt, _ = CheckpointManager(tmp_path / "jax").restore(
        fresh, opt_init(fresh, OptConfig()))
    back = _port_arrays(fresh, fresh_opt)
    for key, arr in want.items():
        assert back[key].dtype == arr.dtype and np.array_equal(back[key], arr), key


def _flat_jax_arrays(tree, prefix: str) -> dict:
    """A JAX tree's leaves under the flat ``prefix/...`` keys of a
    checkpoint (bf16 as its uint16 bits under ``<key>::bf16``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join([prefix, *(p.key for p in path)])
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            out[key + "::bf16"] = a.view(np.uint16)
        else:
            out[key] = a
    return out


def test_loss_decreases():
    out = _cpu_train(arch="gemma-2b", reduced=True, steps=30, batch=8, seq=64, lr=3e-3)
    losses = out["losses"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert len(out["step_seconds"]) == 30 and min(out["step_seconds"]) > 0


def test_checkpoint_resume_identical(tmp_path):
    d = tmp_path / "ckpt"
    kw = dict(arch="gemma-2b", reduced=True, batch=4, seq=32, ckpt_every=10)
    full = _cpu_train(steps=20, ckpt_dir=str(d / "a"), **kw)
    _cpu_train(steps=10, ckpt_dir=str(d / "b"), **kw)
    resumed = _cpu_train(steps=20, ckpt_dir=str(d / "b"), **kw)
    assert resumed["final_loss"] == pytest.approx(full["final_loss"], rel=1e-4)


def test_reconfiguration_preserves_trajectory(tmp_path):
    """GA=1 -> GA=2 through a checkpoint, global batch kept."""
    d = tmp_path / "ckpt"
    kw = dict(arch="llama2-7b", reduced=True, batch=8, seq=32, ckpt_every=8)
    base = _cpu_train(steps=16, ckpt_dir=str(d / "base"), **kw)
    _cpu_train(steps=8, ckpt_dir=str(d / "rcfg"), **kw)
    rcfg = _cpu_train(steps=16, plan_kw={"ga_steps": 2}, ckpt_dir=str(d / "rcfg"), **kw)
    assert rcfg["final_loss"] == pytest.approx(base["final_loss"], rel=2e-2)


def test_ga_equals_full_batch_gradients():
    kw = dict(arch="gpt2-1.5b", reduced=True, steps=10, batch=8, seq=32)
    a = _cpu_train(**kw)
    b = _cpu_train(plan_kw={"ga_steps": 4}, **kw)
    assert b["final_loss"] == pytest.approx(a["final_loss"], rel=2e-2)


def test_remat_matches_no_remat():
    kw = dict(arch="gemma-2b", reduced=True, steps=6, batch=4, seq=32)
    a = _cpu_train(**kw)
    b = _cpu_train(remat=True, **kw)
    assert b["final_loss"] == pytest.approx(a["final_loss"], rel=1e-3)


def _port_arrays(params, opt_state) -> dict:
    return {**params_to_jax_numpy(params.state_dict(), flat=True),
            **opt_state_to_jax_numpy(opt_state, flat=True)}


def _jax_checkpoint_resumes_in_port(arch, tmp_path):
    from repro_torch.models import build
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, opt_init

    kw = dict(arch=arch, reduced=True, batch=4, seq=32)
    full = jtrain(steps=6, log_every=1000, **kw)
    jtrain(steps=3, ckpt_dir=str(tmp_path / "ck"), ckpt_every=3, log_every=1000, **kw)
    saved = read_checkpoint(tmp_path / "ck" / "step_000000003")

    cfg = configs.get_reduced(arch)
    params = build(cfg, device="cpu").init()
    opt_state = opt_init(params, OptConfig())
    params, opt_state, meta = CheckpointManager(tmp_path / "ck").restore(params, opt_state)
    assert meta["step"] == 3 and opt_state["count"] == 3
    got = _port_arrays(params, opt_state)
    assert sorted(got) == sorted(saved)
    for key, arr in saved.items():
        assert got[key].dtype == arr.dtype and np.array_equal(got[key], arr), key

    resumed = _cpu_train(steps=6, ckpt_dir=str(tmp_path / "ck"), **kw)
    assert len(resumed["losses"]) == 3
    assert resumed["final_loss"] == pytest.approx(full["final_loss"], rel=1e-3)


def test_jax_checkpoint_resumes_in_port(tmp_path, float32_configs):
    _jax_checkpoint_resumes_in_port("llama2-7b", tmp_path)


# The SSM families' leaves that stay f32 beside the model dtype, and the
# hybrid's shared block (restacked on a leading axis of 1 in the checkpoint).
SSM_LEAVES = {"zamba2-7b": ("params/ssm_layers/mixer/A_log", "params/ssm_layers/mixer/D_skip",
                            "params/ssm_layers/mixer/dt_bias", "opt/m/ssm_layers/mixer/A_log"),
              "rwkv6-1.6b": ("params/layers/tm/w0", "params/layers/tm/u",
                             "opt/v/layers/tm/u")}


@pytest.mark.parametrize("arch", list(SSM_LEAVES))
def test_jax_checkpoint_resumes_in_port_ssm(arch, tmp_path, float32_configs):
    """As test_jax_checkpoint_resumes_in_port, for the hybrid and RWKV-6."""
    _jax_checkpoint_resumes_in_port(arch, tmp_path)


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_jax_checkpoint_resumes_in_port_stub(arch, tmp_path, float32_configs):
    """As test_jax_checkpoint_resumes_in_port, for the encoder-decoder and
    the vision decoder: the resumed port run ends on the reference's loss."""
    _jax_checkpoint_resumes_in_port(arch, tmp_path)


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_port_checkpoint_restores_in_jax_stub(arch, tmp_path, monkeypatch):
    """As test_port_checkpoint_restores_in_jax, for the encoder-decoder and
    the vision decoder, in bf16: the reference resumes the port's run and
    ends on the port's loss."""
    _port_checkpoint_restores_in_jax(arch, "bfloat16", tmp_path, monkeypatch)


def _port_checkpoint_restores_in_jax(arch, dtype, tmp_path, monkeypatch):
    for mod in (jconfigs, configs):
        get = mod.get_reduced
        monkeypatch.setattr(mod, "get_reduced",
                            lambda arch, get=get: get(arch).with_(dtype=dtype))
    kw = dict(arch=arch, reduced=True, batch=4, seq=32)
    full = _cpu_train(steps=6, **kw)
    part = _cpu_train(steps=3, ckpt_dir=str(tmp_path / "ck"), ckpt_every=3, **kw)

    from repro.models import build as jbuild
    jm = jbuild(jconfigs.get_reduced(arch))
    jp = jm.init(jax.random.PRNGKey(1))
    jst = jopt_init(jp, JOptConfig(lr=1e-3))
    jp, jst, meta = JCheckpointManager(tmp_path / "ck").restore(jp, jst)
    assert meta["step"] == 3 and int(jst["count"]) == 3
    want = params_to_jax_numpy(part["params"].state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = want
        for k in path:
            node = node[k.key]
        got = np.asarray(leaf)
        if got.dtype == jnp.bfloat16:
            got = got.view(np.uint16)
        assert got.dtype == node.dtype and np.array_equal(got, node), path

    # JAX resumes the port's run and ends where the port's uninterrupted run does
    resumed = jtrain(steps=6, ckpt_dir=str(tmp_path / "ck"), log_every=1000, **kw)
    assert len(resumed["losses"]) == 3
    assert resumed["final_loss"] == pytest.approx(full["final_loss"], rel=1e-3)
    return read_checkpoint(tmp_path / "ck" / "step_000000003")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, monkeypatch, dtype):
    _port_checkpoint_restores_in_jax("llama2-7b", dtype, tmp_path, monkeypatch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(SSM_LEAVES))
def test_port_checkpoint_restores_in_jax_ssm(arch, dtype, tmp_path, monkeypatch):
    """As test_port_checkpoint_restores_in_jax, for the hybrid and RWKV-6;
    their f32 leaves (and moments) stay f32 in a bf16 run, and the hybrid's
    shared block is stacked on a leading axis of 1."""
    saved = _port_checkpoint_restores_in_jax(arch, dtype, tmp_path, monkeypatch)
    for key in SSM_LEAVES[arch]:
        assert saved[key].dtype == np.float32, key
    if arch == "zamba2-7b":
        assert saved["params/shared/attn/wq" + ("::bf16" if dtype == "bfloat16" else "")
                     ].shape[0] == 1


def test_checkpoint_manager_housekeeping(tmp_path):
    """keep_last, async saves joined by wait, the recorder's spans, and the
    restore price, which equals the JAX manager's on the same state."""
    from repro_torch.models import build
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, opt_init

    class Recorder:
        def __init__(self):
            self.spans = []

        def span(self, name, t0, t1, step, **attrs):
            assert t1 >= t0
            self.spans.append((name, step, attrs))

    params = build(configs.get_reduced("llama2-7b"), device="cpu").init()
    opt_state = opt_init(params, OptConfig(moment_dtype="bfloat16"))
    rec = Recorder()
    mgr = CheckpointManager(tmp_path, keep_last=2, recorder=rec)
    for step in range(1, 6):
        mgr.save(step, params, opt_state, meta={"plan": "DP"})
    mgr.wait()
    assert mgr.list_steps() == [4, 5] and mgr.latest_step() == 5
    assert [s[:2] for s in rec.spans] == [("checkpoint-save", float(s)) for s in range(1, 6)]
    assert all(s[2]["bytes"] > 0 for s in rec.spans)
    _, _, meta = mgr.restore(params, opt_state, step=4)
    assert meta == {"plan": "DP", "step": 4} and rec.spans[-1][:2] == ("checkpoint-restore", 4.0)

    jparams = jax.tree.map(lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                                                 else a), params_to_jax_numpy(params.state_dict()))
    jopt = jax.tree.map(lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                                              else a), opt_state_to_jax_numpy(opt_state))
    want = JCheckpointManager.restore_cost_estimate(jparams, jopt)
    assert CheckpointManager.restore_cost_estimate(params, opt_state) == pytest.approx(want,
                                                                                       rel=1e-12)


def test_async_save_holds_the_values_at_save_time(tmp_path, monkeypatch):
    """The training loop updates params and moments in place right after an
    async ``save`` returns; the step written must still be the one saved.
    The write thread is held until every leaf has been overwritten."""
    import threading

    import torch

    from repro_torch.models import build
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import OptConfig, opt_init

    params = build(configs.get_reduced("llama2-7b"), device="cpu").init()
    opt_state = opt_init(params, OptConfig())
    for t in opt_state["m"].values():
        t.fill_(0.25)
    want = {k: np.array(a, copy=True)
            for k, a in {**params_to_jax_numpy(params.state_dict(), flat=True),
                         **opt_state_to_jax_numpy(opt_state, flat=True)}.items()}

    updated = threading.Event()
    savez = np.savez

    def held_savez(*args, **kw):
        assert updated.wait(timeout=60)
        savez(*args, **kw)

    monkeypatch.setattr(checkpoint.np, "savez", held_savez)
    mgr = checkpoint.CheckpointManager(tmp_path, async_save=True)
    target = mgr.save(1, params, opt_state)
    with torch.no_grad():
        for t in [*params.state_dict().values(), *opt_state["m"].values(),
                  *opt_state["v"].values()]:
            t.add_(1.0)
    updated.set()
    mgr.wait()

    got = read_checkpoint(target)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


PLANS = [{}, {"ga_steps": 2}, {"gc": True}, {"ga_steps": 4, "gc": True},
         {"zero_stage": 1}, {"zero_stage": 3}, {"zero_stage": 1, "offload": True},
         {"dp": 2, "tp": 2}, {"pp": 4}]
BAD_PLANS = [{"zero_stage": 2}, {"offload": True}, {"dp": 0}, {"tp": 0, "pp": 2}]


@pytest.mark.parametrize("plan_kw", PLANS + BAD_PLANS, ids=[
    ",".join(f"{k}={v}" for k, v in kw.items()) or "default" for kw in PLANS + BAD_PLANS])
def test_plan_copy_matches_reference(plan_kw):
    """The port's ExecutionPlan names a plan as the reference's does, and
    refuses what the reference refuses (as ValueError, where it asserts)."""
    from repro.parallel.plan import ExecutionPlan as JPlan
    from repro_torch.parallel.plan import ExecutionPlan

    plan, ref = ExecutionPlan(**plan_kw), JPlan(**plan_kw)
    assert plan.strategy == ref.strategy
    if plan_kw in BAD_PLANS:
        with pytest.raises(AssertionError):
            ref.validate()
        with pytest.raises(ValueError):
            plan.validate()
    else:
        ref.validate()
        plan.validate()


def test_launcher_refuses_an_invalid_plan(tmp_path):
    with pytest.raises(ValueError, match="offload implies ZeRO"):
        _cpu_train(arch="llama2-7b", steps=1, batch=2, seq=16, plan_kw={"offload": True},
                   ckpt_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("seed", [0, 7])
def test_data_pipeline_matches_reference(seed):
    """Both frameworks train on the same batches."""
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import make_source as jmake_source
    from repro_torch.data.pipeline import DataConfig, make_source

    kw = dict(vocab_size=1000, seq_len=64, global_batch=4, seed=seed)
    ours, ref = make_source(DataConfig(**kw)), jmake_source(JDataConfig(**kw))
    for step in (0, 1, 17, 1000):
        got, want = ours.batch(step), ref.batch(step)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
