"""The port's copy of Rubick's performance model against the JAX package's
host-side modules, on fixed inputs.

``repro_torch.core`` and ``repro_torch.parallel.plan{,_table}`` are copies
of ``repro.core.{costs,perfmodel,fitting,memory,paper_models,oracle}`` and
``repro.parallel.plan{,_table}`` (the port imports nothing of ``repro``).
Each is held to the reference on the same inputs: parameter counts of every
config the port has; T_iter, scalar and batched, and the memory model's
feasibility over every plan of up to 8 GPUs × allocations of 1–16 GPUs for
each of the paper's Table 2 profiles (relative 1e-12); the analytic
oracle's profiling samples (identical); both fit engines (parameters
relative 1e-9) and the Table 2 error metric on those samples.
"""

import dataclasses

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import costs as jcosts
from repro.core import memory as jmemory
from repro.core import oracle as joracle
from repro.core import paper_models as jpaper
from repro.core import perfmodel as jpm
from repro.core.fitting import fit_batch as jfit_batch
from repro.parallel import plan as jplan
from repro.parallel import plan_table as jplan_table
from repro_torch import configs
from repro_torch.core import costs, memory, oracle, paper_models
from repro_torch.core import perfmodel as pm
from repro_torch.core.fitting import FitStats, fit_batch
from repro_torch.parallel import plan as tplan
from repro_torch.parallel import plan_table

PROFILES = sorted(paper_models.TABLE2)
GPUS = np.arange(1, 17)
RTOL = 1e-12
# Fewer Nelder-Mead iterations than the default 3000 keep the scalar
# engine's 3 restarts × 7 profiles inside this file's time; both packages
# run the same inputs, so they must still agree.
SCALAR_MAXITER = 400


def _jplan(p: tplan.ExecutionPlan) -> jplan.ExecutionPlan:
    return jplan.ExecutionPlan(**dataclasses.asdict(p))


def _jprofile(name: str) -> jpm.ModelProfile:
    return jpaper.TABLE2[name]


def _plans(b: int) -> list[tplan.ExecutionPlan]:
    return [p for g in range(1, 9) for p in tplan.enumerate_plans(g, b)]


def _samples_as_dicts(samples) -> list:
    return [(dataclasses.asdict(p), dataclasses.asdict(a), t) for p, a, t in samples]


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_counts_match_reference(arch):
    for get in ("get", "get_reduced"):
        cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert costs.param_count(cfg) == jcosts.param_count(jcfg)
        assert costs.active_param_count(cfg) == jcosts.active_param_count(jcfg)
        assert costs.flops_param_count(cfg) == jcosts.flops_param_count(jcfg)
        prof = pm.ModelProfile.from_config(cfg, seq=1024, batch=16)
        assert dataclasses.asdict(prof) == dataclasses.asdict(
            jpm.ModelProfile.from_config(jcfg, seq=1024, batch=16))


@pytest.mark.parametrize("b", [1, 16, 32, 64])
def test_plan_enumeration_and_table_match_reference(b):
    for g in range(1, 17):
        got = [dataclasses.asdict(p) for p in tplan.enumerate_plans(g, b, max_ga=8)]
        want = [dataclasses.asdict(p) for p in jplan.enumerate_plans(g, b, max_ga=8)]
        assert got == want
    for p in _plans(b):
        assert p.n_gpus == _jplan(p).n_gpus and p.strategy == _jplan(p).strategy
    tbl, jtbl = plan_table.build(b, 16), jplan_table.build(b, 16)
    assert tbl.strategies == jtbl.strategies
    for f in dataclasses.fields(tbl.cols):
        np.testing.assert_array_equal(getattr(tbl.cols, f.name), getattr(jtbl.cols, f.name))


def test_env_for_gpu_matches_reference():
    for gpu in jpm.GPU_TYPES:
        assert dataclasses.asdict(pm.env_for_gpu(gpu)) == dataclasses.asdict(jpm.env_for_gpu(gpu))
    assert set(pm.GPU_TYPES) == set(jpm.GPU_TYPES) | {"h100"}
    h100 = pm.env_for_gpu("h100")
    assert h100.gpu_flops == 989e12 and h100.gpu_mem > 80e9 and h100.B_pcie > 0
    with pytest.raises(KeyError):
        pm.env_for_gpu("tpu-v5e")


@pytest.mark.parametrize("name", PROFILES)
def test_titer_and_feasibility_grid_match_reference(name):
    """predict_titer, predict_titer_batch, memory.feasible_mask and
    estimate_batch over every plan of up to 8 GPUs × 1-16 GPUs."""
    prof, jprof = paper_models.TABLE2[name], _jprofile(name)
    assert dataclasses.asdict(prof) == dataclasses.asdict(jprof)
    env, jenv = pm.Env(), jpm.Env()
    k, jk = oracle.true_params(name), joracle.true_params(name)
    assert k.as_vector().tolist() == jk.as_vector().tolist()
    plans = _plans(prof.b)
    jplans = [_jplan(p) for p in plans]
    got = np.array([[pm.predict_titer(prof, p, pm.Alloc(int(g), 12 * int(g)), env, k)
                     for g in GPUS] for p in plans])
    want = np.array([[jpm.predict_titer(jprof, p, jpm.Alloc(int(g), 12 * int(g)), jenv, jk)
                      for g in GPUS] for p in jplans])
    assert np.isfinite(want).any()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    cols = plan_table.PlanColumns.from_plans(plans).expand()
    jcols = jplan_table.PlanColumns.from_plans(jplans).expand()
    cpus = 12.0 * GPUS
    np.testing.assert_allclose(pm.predict_titer_batch(prof, cols, GPUS, cpus, env, k),
                               jpm.predict_titer_batch(jprof, jcols, GPUS, cpus, jenv, jk),
                               rtol=RTOL)
    mask = memory.feasible_mask(prof, cols, GPUS, cpus, env)
    np.testing.assert_array_equal(mask, jmemory.feasible_mask(jprof, jcols, GPUS, cpus, jenv))
    assert mask.any() and not mask.all()
    for a, b in zip(memory.estimate_batch(prof, cols, GPUS, cpus, env),
                    jmemory.estimate_batch(jprof, jcols, GPUS, cpus, jenv)):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    for p, jp in zip(plans[::7], jplans[::7]):
        for g in (1, 8):
            a, ja = pm.Alloc(g, 12 * g), jpm.Alloc(g, 12 * g)
            assert memory.feasible(prof, p, a, env) == jmemory.feasible(jprof, jp, ja, jenv)
            assert dataclasses.asdict(memory.estimate(prof, p, a, env)) == \
                dataclasses.asdict(jmemory.estimate(jprof, jp, ja, jenv))
    assert memory.restore_cost(profile=prof) == jmemory.restore_cost(profile=jprof)
    assert memory.restore_cost(nbytes=3e9) == jmemory.restore_cost(nbytes=3e9)


@pytest.fixture(scope="module")
def samples():
    """The analytic oracle's profiling samples of each Table 2 profile, from
    each package."""
    an, jan = oracle.AnalyticOracle(), joracle.AnalyticOracle()
    return {name: (oracle.profiling_samples(paper_models.TABLE2[name], an),
                   joracle.profiling_samples(_jprofile(name), jan)) for name in PROFILES}


@pytest.mark.parametrize("name", PROFILES)
def test_profiling_samples_match_reference(name, samples):
    got, want = samples[name]
    assert got and _samples_as_dicts(got) == _samples_as_dicts(want)


@pytest.mark.parametrize("engine", ["batched", "scalar"])
@pytest.mark.parametrize("name", PROFILES)
def test_fit_and_prediction_error_match_reference(name, engine, samples):
    got, want = samples[name]
    prof, jprof = paper_models.TABLE2[name], _jprofile(name)
    kw = {"maxiter": SCALAR_MAXITER} if engine == "scalar" else {}
    k = pm.fit(prof, got, engine=engine, **kw)
    jk = jpm.fit(jprof, want, engine=engine, **kw)
    np.testing.assert_allclose(k.as_vector(), jk.as_vector(), rtol=1e-9)
    err = pm.prediction_error(prof, k, got)
    np.testing.assert_allclose(err, jpm.prediction_error(jprof, jk, want), rtol=1e-9)
    assert all(np.isfinite(err))
    cols, g, c, node, true = pm.sample_arrays(got, pm.Env())
    pred = pm.predict_titer_batch(prof, cols, g, c, pm.Env(), k, per_node=node)
    assert pm.rmsle(pred, true) < 0.2


def test_profiling_requests_fit_batch_match_reference():
    """All seven profiles' fits in one batched call, through
    profiling_requests, with the engine's stats."""
    profs = [paper_models.TABLE2[n] for n in PROFILES]
    reqs, skipped = oracle.profiling_requests(profs, oracle.AnalyticOracle())
    jreqs, jskipped = joracle.profiling_requests([_jprofile(n) for n in PROFILES],
                                                 joracle.AnalyticOracle())
    # fewer than 4 feasible profiling points (the fit floor) leave a profile
    # out of the requests, in both packages alike
    assert [r.profile.name for r in reqs] == [r.profile.name for r in jreqs]
    assert [(p.name, _samples_as_dicts(s)) for p, s in skipped] == \
        [(p.name, _samples_as_dicts(s)) for p, s in jskipped]
    assert len(reqs) >= 5
    stats = FitStats()
    got = fit_batch(reqs, stats=stats)
    want = jfit_batch(jreqs)
    for k, jk in zip(got, want):
        np.testing.assert_allclose(k.as_vector(), jk.as_vector(), rtol=1e-9)
    assert stats.n_fits == len(reqs) and stats.n_calls == 1 and stats.evals > 0


@pytest.mark.parametrize("name", PROFILES)
def test_analytic_oracle_measure_matches_reference(name):
    """AnalyticOracle.measure over a sample of the plan grid, at 1, 4 and 8
    GPUs, two seeds and two environments (its default and the H100's,
    given per call), equal to the reference's to the bit (inf where both
    call the plan infeasible)."""
    prof, jprof = paper_models.TABLE2[name], _jprofile(name)
    an, jan = oracle.AnalyticOracle(), joracle.AnalyticOracle()
    h100 = pm.env_for_gpu("h100")
    envs = ((None, None), (h100, jpm.Env(**dataclasses.asdict(h100))))
    got, want = [], []
    for p in _plans(prof.b)[::5]:
        for g in (1, 4, 8):
            a, ja = pm.Alloc(g, 12 * g), jpm.Alloc(g, 12 * g)
            for seed in (0, 3):
                for env, jenv in envs:
                    got.append(an.measure(prof, p, a, seed=seed, env=env))
                    want.append(jan.measure(jprof, _jplan(p), ja, seed=seed, env=jenv))
    assert got == want
    assert any(np.isfinite(got)) and not all(np.isfinite(got))
