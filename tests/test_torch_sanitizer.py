"""The port's runtime sanitizer (``repro_torch.analysis.sanitizer``) against
the reference's, on the CPU.

The reference's reintroduce-the-bug suite (``tests/test_sanitizer.py``)
plants one reverted bugfix at a time in a scheduler or simulator subclass
and drives its regression scenario with sanitizing on.  Here every planted
corruption is built on each package's own classes, and the port must raise
a ``SanitizerViolation`` of the same rule as the reference, with candidate
mutation sites that name the port's files and lines
(``analysis/tables.py``).  The clean scenarios run clean on both sides and
give the same states.  Sanitized simulations (the config flag, or
``REPRO_SANITIZE=1`` for the scheduler, the baselines, the simulator and the
calibration manager) give the same results as unsanitized ones, and as the
reference's.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro.analysis import sanitizer as jsanitizer
from repro.analysis import tables as jtables
from repro.core import baselines as jbaselines
from repro.core import cluster as jcluster
from repro.core import memory as jmemory
from repro.core import paper_models as jpaper
from repro.core import perfmodel as jpm
from repro.core import scheduler as jscheduler
from repro.core import sensitivity as jsens
from repro.core import simulator as jsimulator
from repro.core import trace as jtrace
from repro.parallel import plan as jplan
from repro_torch.analysis import sanitizer as tsanitizer
from repro_torch.analysis import tables as ttables
from repro_torch.core import baselines as tbaselines
from repro_torch.core import cluster as tcluster
from repro_torch.core import memory as tmemory
from repro_torch.core import paper_models as tpaper
from repro_torch.core import perfmodel as tpm
from repro_torch.core import scheduler as tscheduler
from repro_torch.core import sensitivity as tsens
from repro_torch.core import simulator as tsimulator
from repro_torch.core import trace as ttrace
from repro_torch.parallel import plan as tplan

PORT_ROOT = Path(tsanitizer.__file__).resolve().parents[1]
REF = SimpleNamespace(san=jsanitizer, baselines=jbaselines, cluster=jcluster, memory=jmemory,
                      paper=jpaper, pm=jpm, scheduler=jscheduler, sens=jsens, sim=jsimulator,
                      trace=jtrace, plan=jplan)
PORT = SimpleNamespace(san=tsanitizer, baselines=tbaselines, cluster=tcluster, memory=tmemory,
                       paper=tpaper, pm=tpm, scheduler=tscheduler, sens=tsens, sim=tsimulator,
                       trace=ttrace, plan=tplan)
SIDES = (("ref", REF), ("port", PORT))
_FITS: dict = {}


def _fit_cache(ns) -> dict:
    """The reference's fit of every Table 2 model type and of the quota
    trace's (as ``_prefit`` makes it), as ``ns``'s ``FitParams`` keyed by
    ``fit_key``: both packages simulate under the same params."""
    if not _FITS:
        from repro.core import oracle as joracle
        from repro.core.fitting import fit_batch

        profiles = {jpm.fit_key(p): p for p in jpaper.TABLE2.values()}
        profiles.update((jpm.fit_key(j.profile), j.profile) for j in _mt_jobs(REF))
        reqs, skipped = joracle.profiling_requests(list(profiles.values()),
                                                   joracle.AnalyticOracle())
        _FITS.update((jpm.fit_key(r.profile), k) for r, k in zip(reqs, fit_batch(reqs)))
        _FITS.update((jpm.fit_key(p), jpm.FitParams()) for p, _ in skipped)
    return {key: k if ns is REF else tpm.FitParams(**dataclasses.asdict(k))
            for key, k in _FITS.items()}


def _plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "telemetry"}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _job(ns, name, profile, req_gpus, submit=0.0, guaranteed=True, tenant="A"):
    return ns.cluster.Job(name=name, profile=profile, submit=submit, target_iters=1e6,
                          req_gpus=req_gpus, req_cpus=12 * req_gpus,
                          orig_plan=ns.plan.ExecutionPlan(dp=1), guaranteed=guaranteed,
                          tenant=tenant)


def _state(ns, *args, **kw):
    return ns.cluster.JobState(job=_job(ns, *args, **kw), fitted=ns.pm.FitParams())


def _sanitized(sched, ns):
    sched.cfg.sanitize = True
    sched._san = ns.san.SchedSanitizer()
    return sched


def _states(states) -> list:
    return [(s.job.name, s.status, _plain(s.plan), _plain(s.alloc), sorted(s.placement.items()),
             s.n_reconfig) for s in states]


# --- the planted bugs, on either package's classes ------------------------------------

def no_host_check_scheduler(ns):
    """_commit without the per-node host-memory check."""
    class NoHostCheck(ns.scheduler.RubickScheduler):
        def _commit(self, js, curve, env, cluster, wu, placement, got_g, got_c, now):
            pernode = tuple(sorted((g for g, _, _ in placement.values()), reverse=True))
            if self.cfg.reconfigure_plans:
                plan = curve.best_plan_at_most(got_g, got_c, gpus_per_node=pernode).plan
            else:
                plan = self._fixed_plan(js, got_g, env)
            if plan is None:
                return False
            alloc = ns.pm.Alloc(got_g, got_c, gpus_per_node=pernode)
            est = ns.memory.estimate(js.job.profile, plan, alloc, env)
            if est.gpu_bytes > env.gpu_mem:
                return False
            host_share = est.host_bytes / max(len(placement), 1)
            if js.status == "running" and not self._reconfig_ok(js, plan, alloc, now):
                return False
            for nid in placement:
                g, c, _ = placement[nid]
                placement[nid] = (g, c, host_share)
            changed = (plan != js.plan or alloc != js.alloc)
            js.placement, js.alloc, js.plan = placement, alloc, plan
            if js.status == "queued":
                js.status = "running"
                js.start_time = now if js.start_time is None else js.start_time
            elif changed:
                js.n_reconfig += 1
            return True
    return NoHostCheck


def no_undo_scheduler(ns):
    """_undo as a no-op: a failed walk's shrinks persist."""
    class NoUndo(ns.scheduler.RubickScheduler):
        def _undo(self, shrunk, ctx=None):
            return
    return NoUndo


def copy_undo_scheduler(ns):
    """_undo restoring every field into a NEW placement dict."""
    class CopyUndo(ns.scheduler.RubickScheduler):
        def _undo(self, shrunk, ctx=None):
            for victim, _obj, content, plan, alloc, status, n_rcfg in shrunk.values():
                if ctx is not None:
                    ctx.mark_dirty(victim)
                    ctx.bump_nodes(set(victim.placement) | set(content))
                    if victim.job.guaranteed:
                        restored = sum(g for g, _, _ in content.values())
                        ctx.ledger_add_live(victim.job.tenant, restored - victim.total_gpus)
                victim.placement = dict(content)
                victim.plan, victim.alloc = plan, alloc
                victim.status, victim.n_reconfig = status, n_rcfg
    return CopyUndo


def no_rollback_antman(ns):
    """_try_preempt whose failure path forgets to fold the victims back
    into the pass-wide usage map."""
    class NoRollbackAntMan(ns.baselines.AntManLike):
        def _try_preempt(self, js, active, cluster, now, used):
            be = [j for j in active if j.status == "running" and not j.job.guaranteed]
            preempted = []
            for victim in be:
                preempted.append((victim, dict(victim.placement), victim.plan, victim.alloc,
                                  victim.n_reconfig))
                self._fold(victim.placement, used, sign=-1)
                victim.status, victim.placement = "queued", {}
                victim.plan, victim.alloc = None, None
                victim.n_reconfig += 1
                if self._gang_place(js, active, cluster, now, used):
                    return True
            for victim, placement, plan, alloc, n_rcfg in preempted:
                victim.status, victim.placement = "running", placement
                victim.plan, victim.alloc, victim.n_reconfig = plan, alloc, n_rcfg
            return False
    return NoRollbackAntMan


def minres_quota_scheduler(ns):
    """Quota charged at each job's minRes, growth ignoring the room left."""
    class MinResQuota(ns.scheduler.RubickScheduler):
        def _quota_ok(self, js, jobs, ctx=None):
            quota = self.quotas.get(js.job.tenant)
            if quota is None:
                return True
            used = sum((j.min_res[0] if j.min_res else j.job.req_gpus) for j in jobs
                       if j.status == "running" and j.job.guaranteed
                       and j.job.tenant == js.job.tenant)
            return used + (js.min_res[0] if js.min_res else js.job.req_gpus) <= quota

        def _quota_room(self, js, active, ctx=None):
            return None
    return MinResQuota


def forget_eviction_sim(ns):
    class ForgetEviction(ns.sim.Simulator):
        def _evict_resident(self, s, active, down_set, graceful, now):
            return s, dict(s.placement), "skipped"
    return ForgetEviction


def leak_usage_sim(ns):
    class LeakUsage(ns.sim.Simulator):
        def _evict_resident(self, s, active, down_set, graceful, now):
            s, _before, outcome = super()._evict_resident(s, active, down_set, graceful, now)
            return s, {}, outcome
    return LeakUsage


# --- the reference's regression scenarios ----------------------------------------------

def host_mem_scenario(ns, sched):
    prof = ns.paper.profile("llama2-7b")
    states = [_state(ns, f"j{i}", prof, 1) for i in range(2)]
    sched.schedule(states, ns.cluster.Cluster(n_nodes=1, mem_per_node=150e9), 0.0)
    return states


def failed_walk_scenario(ns, sched):
    cluster = ns.cluster.Cluster(n_nodes=1)
    a = _state(ns, "a", ns.paper.profile("roberta-355m"), 4, guaranteed=False, tenant="B")
    b = _state(ns, "b", ns.paper.profile("llama-30b"), 4)
    states = [a, b]
    sched.schedule(states, cluster, 0.0, events=ns.cluster.SchedEvents(arrived=[a, b]))
    big = _state(ns, "big", ns.paper.profile("llama-30b"), 16)
    states.append(big)
    sched.schedule(states, cluster, 60.0, events=ns.cluster.SchedEvents(arrived=[big]))
    return states


def antman_scenario(ns, sched):
    prof = ns.paper.profile("roberta-355m")
    cluster = ns.cluster.Cluster(n_nodes=1)
    states = [_state(ns, f"be{i}", prof, 4, guaranteed=False, tenant="B") for i in range(2)]
    sched.schedule(states, cluster, 0.0)
    states.append(_state(ns, "g", prof, 16))
    states.append(_state(ns, "be2", prof, 4, submit=10.0, guaranteed=False, tenant="B"))
    sched.schedule(states, cluster, 10.0)
    return states


def quota_scenario(ns, sched):
    prof = ns.paper.profile("llama2-7b")
    cluster = ns.cluster.Cluster(n_nodes=2)
    states = [_state(ns, "j1", prof, 4)]
    sched.schedule(states, cluster, 0.0)
    states.append(_state(ns, "j2", prof, 4, submit=100.0))
    sched.schedule(states, cluster, 100.0)
    return states


def node_failure_scenario(ns, sim_cls):
    sched = _sanitized(ns.baselines.ALL["rubick-e"](pass_engine="incremental"), ns)
    jobs = [_job(ns, "span", ns.paper.profile("llama-30b"), 16)]
    cap = [ns.trace.CapacityEvent(1000.0, 1, down=True)]
    return sim_cls(ns.cluster.Cluster(n_nodes=2), sched, fit_cache=_fit_cache(ns),
                   capacity=cap).run(jobs, max_time=5000.0)


def spot_revoke_scenario(ns, sim_cls):
    prof = ns.paper.profile("roberta-355m")
    cluster = ns.cluster.Cluster(n_nodes=1)
    spot = cluster.add_spot_nodes(1)
    sched = _sanitized(ns.baselines.ALL["rubick-e"](pass_engine="incremental"), ns)
    cap = [ns.trace.CapacityEvent(600.0, spot[0], down=False, kind="spot-arrive"),
           ns.trace.CapacityEvent(5000.0, spot[0], down=True, warning_s=120.0,
                                  kind="spot-revoke")]
    jobs = [_job(ns, "a", prof, 8), _job(ns, "b", prof, 8)]
    return sim_cls(cluster, sched, fit_cache=_fit_cache(ns), capacity=cap).run(
        jobs, max_time=20000.0)


def _cfg(ns, **kw):
    return ns.scheduler.SchedulerConfig(sanitize=True, **kw)


# case: (the corrupted run, the clean run, the reference's rule(s))
CASES = {
    "unchecked-host-memory": (
        lambda ns: host_mem_scenario(ns, no_host_check_scheduler(ns)(
            cfg=_cfg(ns, reallocate_resources=False))),
        lambda ns: host_mem_scenario(ns, ns.scheduler.RubickScheduler(
            cfg=_cfg(ns, reallocate_resources=False))),
        {"capacity"}),
    "missing-rollback": (
        lambda ns: failed_walk_scenario(ns, no_undo_scheduler(ns)(
            cfg=_cfg(ns, reconfigure_plans=False))),
        lambda ns: failed_walk_scenario(ns, ns.scheduler.RubickScheduler(
            cfg=_cfg(ns, reconfigure_plans=False))),
        {"shrink-no-beneficiary", "usage-map"}),
    "rollback-into-new-dict": (
        lambda ns: failed_walk_scenario(ns, copy_undo_scheduler(ns)(
            cfg=_cfg(ns, reconfigure_plans=False))),
        lambda ns: failed_walk_scenario(ns, ns.scheduler.RubickScheduler(
            cfg=_cfg(ns, reconfigure_plans=False))),
        {"rollback-aliasing"}),
    "unrestored-preemption": (
        lambda ns: antman_scenario(ns, _sanitized(no_rollback_antman(ns)(), ns)),
        lambda ns: antman_scenario(ns, _sanitized(ns.baselines.AntManLike(), ns)),
        {"capacity"}),
    "minres-quota": (
        lambda ns: quota_scenario(ns, minres_quota_scheduler(ns)(cfg=_cfg(ns),
                                                                  quotas={"A": 6})),
        lambda ns: quota_scenario(ns, ns.scheduler.RubickScheduler(cfg=_cfg(ns),
                                                                   quotas={"A": 6})),
        {"quota"}),
    "forgotten-eviction": (
        lambda ns: node_failure_scenario(ns, forget_eviction_sim(ns)),
        lambda ns: node_failure_scenario(ns, ns.sim.Simulator),
        {"dead-node-placement"}),
    "leaked-spot-usage": (
        lambda ns: spot_revoke_scenario(ns, leak_usage_sim(ns)),
        lambda ns: spot_revoke_scenario(ns, ns.sim.Simulator),
        {"dead-node-usage"}),
}


def _port_site_ok(site) -> bool:
    """A candidate site names a port file, and its line stores the attr."""
    path = PORT_ROOT / site.file
    if not path.is_file():
        return False
    line = path.read_text().splitlines()[site.line - 1]
    return f".{site.attr}" in line or f"{site.attr}" in line


@pytest.mark.parametrize("case", sorted(CASES))
def test_planted_bug_raises_the_reference_rule(case):
    corrupt, _, rules = CASES[case]
    got = {}
    for side, ns in SIDES:
        ns.sens.CURVES.clear()
        with pytest.raises(ns.san.SanitizerViolation) as exc:
            corrupt(ns)
        got[side] = exc.value
    assert got["port"].rule == got["ref"].rule and got["port"].rule in rules
    assert isinstance(got["port"], AssertionError)
    sites, ref_sites = got["port"].sites, got["ref"].sites
    assert [(s.file, s.qualname, s.attr) for s in sites] == \
        [(s.file, s.qualname, s.attr) for s in ref_sites]
    assert all(_port_site_ok(s) for s in sites), [str(s) for s in sites if not _port_site_ok(s)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_clean_scenario_runs_clean_like_the_reference(case):
    _, clean, _ = CASES[case]
    out = []
    for _, ns in SIDES:
        ns.sens.CURVES.clear()
        res = clean(ns)
        out.append(_states(res) if isinstance(res, list) else _plain(res))
    assert out[0] == out[1]


def test_pause_crediting_caught_like_the_reference():
    """A job paused until mid-window earns progress over the post-pause
    seconds only; crediting the whole window trips ``check_window``."""
    rules = []
    for _, ns in SIDES:
        san = ns.san.SchedSanitizer()
        prof = ns.paper.profile("roberta-355m")
        s = ns.cluster.JobState(job=_job(ns, "p", prof, 4), fitted=ns.pm.FitParams(),
                                status="running")
        th, t, to, pu = 10.0, 100.0, 160.0, 130.0
        old = (s.run_time, s.progress)
        s.run_time += to - t
        s.progress += th * (to - t) / prof.b
        with pytest.raises(ns.san.SanitizerViolation) as exc:
            san.check_window(s, old, t, to, pu, th)
        rules.append(exc.value.rule)
        s.progress = old[1] + th * (to - pu) / prof.b
        san.check_window(s, old, t, to, pu, th)
    assert rules == ["window-accounting"] * 2


def test_mutation_table_names_the_port_files():
    assert ttables.CORE_MODULES == jtables.CORE_MODULES
    table = ttables.mutation_table()
    assert {"placement", "status", "alloc", "plan"} <= set(table)
    files = {s.file for sites in table.values() for s in sites}
    assert files == set(ttables.CORE_MODULES)
    assert all((PORT_ROOT / f).is_file() for f in files)
    assert all(_port_site_ok(s) for s in ttables.sites_for("placement", "status"))


# --- sanitized runs give the results of unsanitized ones --------------------------------

def _mt_jobs(ns):
    return ns.trace.philly(n_jobs=20, hours=4, seed=11, load_scale=3.0, variant="mt")


def _mt_run(ns, sched_name: str, mode: str, sanitize: bool):
    ns.sens.CURVES.clear()
    jobs = _mt_jobs(ns)
    sched = ns.baselines.ALL[sched_name](quotas={"A": 24})
    if sanitize:
        _sanitized(sched, ns)
    sim = ns.sim.Simulator(ns.cluster.Cluster(n_nodes=4), sched, fit_cache=_fit_cache(ns),
                           mode=mode)
    assert (sim._san is not None) is sanitize
    return _plain(sim.run(jobs))


@pytest.mark.parametrize("mode", ["event", "discrete"])
@pytest.mark.parametrize("sched_name", ["rubick", "sia", "antman"])
def test_sanitized_simulation_matches_unsanitized_and_reference(sched_name, mode):
    clean = _mt_run(PORT, sched_name, mode, sanitize=True)
    assert clean == _mt_run(PORT, sched_name, mode, sanitize=False)
    assert clean == _mt_run(REF, sched_name, mode, sanitize=True)
    assert clean["jcts"]


def test_sanitize_env_reaches_every_owner(monkeypatch):
    from repro_torch.calibration import CalibrationManager

    monkeypatch.setenv("REPRO_SANITIZE", "1")
    for sched in [tscheduler.RubickScheduler()] + [make() for make in tbaselines.ALL.values()]:
        assert isinstance(sched._san, tsanitizer.SchedSanitizer)
    assert isinstance(CalibrationManager()._san, tsanitizer.SchedSanitizer)
    sim = tsimulator.Simulator(tcluster.Cluster(n_nodes=1), tbaselines.make_rubick())
    assert isinstance(sim._san, tsanitizer.SchedSanitizer)
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert tscheduler.RubickScheduler()._san is None
    assert CalibrationManager()._san is None
