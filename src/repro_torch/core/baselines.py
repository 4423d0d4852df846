"""Baseline schedulers (paper Sec 7.3) + the Rubick-E/R/N ablations.

A copy of ``repro.core.baselines`` for the port, held to the
reference's results by ``tests/test_torch_sim.py``.

  Sia-like     — GPU elasticity along the DP dimension only; no plan
                 switching; model of goodput limited to DP jobs; 3D jobs
                 fall back to a feasible static plan with scaling disabled.
  Synergy-like — fixed GPU counts as requested; tunes CPU/mem allocation
                 per sensitivity; no execution-plan awareness.
  AntMan-like  — multi-tenant guaranteed/best-effort with EXACT resource
                 guarantees (vs Rubick's performance guarantees); no
                 reconfiguration.
  Rubick-E     — plans reconfigurable, resources fixed at request.
  Rubick-R     — resources reallocatable, plan family fixed (DP scaling).
  Rubick-N     — neither (policy skeleton only).

All share the Rubick scheduler machinery with switches off, plus small
policy overrides, so comparisons isolate the reconfigurability dimensions.

The gang placers (FIFO / Synergy / AntMan) run on the same incremental
machinery as Rubick where it applies: one pass-wide per-node usage map
folded in place on commit (instead of a rebuild per queued job), a
free-capacity skip over full nodes (gangs never shrink, so a node without
free GPUs can contribute nothing), and a failed-gang signature memo that
persists across passes under ``pass_engine="incremental"`` until cluster
state changes (a placement, an eviction, or a completion event).
"""

from __future__ import annotations

import weakref
from time import perf_counter

from repro_torch.core import memory
from repro_torch.core.cluster import (Cluster, JobState, SchedEvents,
                                      used_per_node)
from repro_torch.core.perfmodel import Alloc
from repro_torch.core.scheduler import RubickScheduler, SchedulerConfig


def _cfg(pass_engine: str | None = None, **kw) -> SchedulerConfig:
    if pass_engine is not None:
        kw["pass_engine"] = pass_engine
    return SchedulerConfig(**kw)


def make_rubick(env=None, quotas=None, pass_engine=None) -> RubickScheduler:
    s = RubickScheduler(env, _cfg(pass_engine), quotas)
    s.name = "rubick"
    return s


def make_rubick_e(env=None, quotas=None, pass_engine=None) -> RubickScheduler:
    s = RubickScheduler(env, _cfg(pass_engine, reallocate_resources=False),
                        quotas)
    s.name = "rubick-e"
    return s


def make_rubick_r(env=None, quotas=None, pass_engine=None) -> RubickScheduler:
    s = RubickScheduler(env, _cfg(pass_engine, reconfigure_plans=False),
                        quotas)
    s.name = "rubick-r"
    return s


def make_rubick_n(env=None, quotas=None, pass_engine=None) -> RubickScheduler:
    s = RubickScheduler(env, _cfg(pass_engine, reconfigure_plans=False,
                                  reallocate_resources=False),
                        quotas)
    s.name = "rubick-n"
    return s


class _FixedPlanScheduler(RubickScheduler):
    """FIFO gang scheduler: requested resources, original plan, no changes."""
    name = "fifo"

    def __init__(self, env=None, quotas=None, pass_engine=None):
        super().__init__(env, _cfg(pass_engine, reconfigure_plans=False,
                                   reallocate_resources=False),
                         quotas)
        self._gang_failed: set[tuple] = set()
        # gang signatures embed id(profile)/id(fitted): pin the referents
        # for as long as the signature is remembered, or a recycled
        # address could alias a different model onto a memoized failure
        self._gang_pins: dict[tuple, tuple] = {}
        self._gang_cluster: weakref.ref | None = None

    # -- incremental machinery -----------------------------------------
    def _gang_memo(self, cluster: Cluster,
                   events: SchedEvents | None) -> set:
        """Cross-pass failed-gang memo: a gang placement is a pure
        function of cluster state and the job's (model, fitted, request,
        gpu_type, plan) signature, so a failed signature stays failed
        until capacity is freed (completion) or some placement/eviction
        changes state (the pass clears the memo then)."""
        prev = self._gang_cluster() if self._gang_cluster is not None \
            else None
        if self.cfg.pass_engine != "incremental" or events is None \
                or prev is not cluster:
            self._gang_failed = set()
            self._gang_pins = {}
            self._gang_cluster = weakref.ref(cluster)
        elif events.completed or events.node_down or events.node_up \
                or events.evicted:
            # freed capacity (completion, node recovery / spot arrival)
            # can place a memoized failure; lost capacity changes the
            # cluster state the memo was computed against either way
            self._gang_failed.clear()
            self._gang_pins.clear()
        elif events.refit:
            # gang signatures embed id(fitted): refit jobs re-key (and
            # re-walk) automatically, but the retired ids must not linger
            # in the memo where a recycled address could alias them
            stale = {id(old) for _, old in events.refit}
            self._gang_failed = {s for s in self._gang_failed
                                 if s[1] not in stale}
            self._gang_pins = {s: p for s, p in self._gang_pins.items()
                               if s in self._gang_failed}
        return self._gang_failed

    def _gang_fail(self, failed: set, sig: tuple, js: JobState) -> None:
        """Memoize a failed gang placement AND pin the signature's
        referents (the memo may outlive the job under the incremental
        engine)."""
        failed.add(sig)
        self._gang_pins[sig] = (js.job.profile, js.fitted)

    def _gang_wake(self, failed: set) -> None:
        """Cluster state changed: every memoized failure may now place."""
        failed.clear()
        self._gang_pins.clear()

    @staticmethod
    def _gang_sig(js: JobState) -> tuple:
        return (id(js.job.profile), id(js.fitted), js.job.req_gpus,
                js.job.gpu_type, js.job.orig_plan)

    @staticmethod
    def _fold(placement: dict, used: dict, sign: int = 1) -> None:
        for nid, (g, c, m) in placement.items():
            ug, uc, um = used.get(nid, (0, 0, 0.0))
            used[nid] = (ug + sign * g, uc + sign * c, um + sign * m)

    # ------------------------------------------------------------------
    def schedule(self, jobs, cluster, now=0.0, events=None):
        self._scope_memos(cluster)
        rec = self.recorder
        t_pass = perf_counter() if rec is not None else 0.0
        if events is not None and events.refit:
            self._purge_refit_memos(events.refit)
        active = [j for j in jobs if j.status != "done"]
        if self._san is not None:
            self._san.begin_pass(active, cluster)
        for js in active:
            self._ensure_min_res(js, cluster)
        used = used_per_node([j for j in active if j.status == "running"])
        failed = self._gang_memo(cluster, events)
        queued = sorted([j for j in active if j.status == "queued"],
                        key=lambda j: j.job.submit)
        for js in queued:
            if not self._quota_ok(js, jobs):
                continue
            sig = self._gang_sig(js)
            if sig in failed:
                continue
            if self._gang_place(js, active, cluster, now, used):
                self._fold(js.placement, used)
                self._gang_wake(failed)
                if rec is not None:
                    rec.decision("admit", now, job=js.job.name,
                                 data={"gpus": js.total_gpus,
                                       "queued_s": now - js.job.submit})
            else:
                self._gang_fail(failed, sig, js)
        if self._san is not None:
            self._san.end_pass(active, cluster, None, self)
        if rec is not None:
            # lint: nondeterminism — profiler span, wall clock by design
            rec.span_since("pass", t_pass, now, engine="gang")

    def _gang_place(self, js: JobState, active, cluster, now,
                    used=None) -> bool:
        """``used`` is the pass-wide per-node usage of every placed job
        EXCLUDING ``js``; the caller folds the new placement in on
        success (so one map serves the whole pass)."""
        need = js.job.req_gpus
        if used is None:
            used = used_per_node([j for j in active if j is not js])
        # one GPU-type group at a time (gangs never span GPU models);
        # homogeneous clusters see a single anonymous group, i.e. the
        # classic full-cluster walk
        for nodes, env in self._group_order(js, cluster):
            placement = {}
            got = 0
            for node in nodes:
                fg, fc, fm = node.free(used)
                if fg <= 0:            # free-capacity skip: gangs never shrink
                    continue
                take = min(fg, need - got)
                if take > 0:
                    placement[node.id] = (take, min(fc, self.cfg.cpus_per_gpu
                                                    * take), 0.0)
                    got += take
                if got >= need:
                    break
            if got < need:
                continue
            plan = self._job_plan(js, got, cluster, env)
            if plan is None:
                continue
            js.placement = placement
            js.alloc = Alloc(got, sum(c for _, c, _ in placement.values()),
                             gpus_per_node=js.gpus_per_node_tuple())
            js.plan = plan
            js.status = "running"
            js.start_time = now if js.start_time is None else js.start_time
            return True
        return False

    def _job_plan(self, js: JobState, gpus: int, cluster: Cluster,
                  env=None):
        env = env or self.env
        plan = js.job.orig_plan
        if plan.n_gpus > gpus:
            return None
        if not memory.feasible(js.job.profile, plan,
                               Alloc(gpus, self.cfg.cpus_per_gpu * gpus),
                               env):
            # fall back to any feasible plan (jobs must be runnable)
            pt = self.curve(js, cluster, env).best_plan_at_most(gpus)
            return pt.plan
        return plan


class SynergyLike(_FixedPlanScheduler):
    """Fixed GPUs (as requested) + sensitivity-aware CPU allocation [33]."""
    name = "synergy"

    def _gang_place(self, js, active, cluster, now, used=None):
        if used is None:
            used = used_per_node([j for j in active if j is not js])
        ok = super()._gang_place(js, active, cluster, now, used)
        if not ok:
            return False
        # CPU-sensitivity tuning: offload-style jobs get extra CPUs
        # (``used`` still excludes js — the caller folds the tuned
        # placement afterwards)
        curve = self.curve(js, cluster, self._placed_env(js, cluster))
        g = js.total_gpus
        if curve.slope_cpu(g, js.total_cpus) > 0:
            for nid in list(js.placement):
                node = cluster.nodes[nid]
                fg, fc, fm = node.free(used)
                gg, cc, mm = js.placement[nid]
                extra = min(fc - cc, 2 * self.cfg.cpus_per_gpu * gg)
                if extra > 0:
                    js.placement[nid] = (gg, cc + extra, mm)
            js.alloc = Alloc(js.total_gpus, js.total_cpus,
                             gpus_per_node=js.gpus_per_node_tuple())
        return True


class SiaLike(RubickScheduler):
    """DP-dimension GPU elasticity only (no plan switching) [18]."""
    name = "sia"

    def __init__(self, env=None, quotas=None, pass_engine=None):
        super().__init__(env, _cfg(pass_engine, reconfigure_plans=False),
                         quotas)


class AntManLike(_FixedPlanScheduler):
    """Exact resource guarantees for guaranteed jobs; best-effort jobs run
    opportunistically and are preempted on guaranteed arrivals [56]."""
    name = "antman"

    def schedule(self, jobs, cluster, now=0.0, events=None):
        self._scope_memos(cluster)
        rec = self.recorder
        t_pass = perf_counter() if rec is not None else 0.0
        if events is not None and events.refit:
            self._purge_refit_memos(events.refit)
        active = [j for j in jobs if j.status != "done"]
        if self._san is not None:
            self._san.begin_pass(active, cluster)
        for js in active:
            self._ensure_min_res(js, cluster)
        used = used_per_node([j for j in active if j.status == "running"])
        failed = self._gang_memo(cluster, events)
        queued_g = sorted([j for j in active if j.status == "queued"
                           and j.job.guaranteed], key=lambda j: j.job.submit)
        for js in queued_g:
            if not self._quota_ok(js, jobs):
                continue
            sig = self._gang_sig(js)
            if sig in failed:
                continue
            if self._gang_place(js, active, cluster, now, used):
                self._fold(js.placement, used)
                self._gang_wake(failed)
                if rec is not None:
                    rec.decision("admit", now, job=js.job.name,
                                 data={"gpus": js.total_gpus,
                                       "queued_s": now - js.job.submit})
                continue
            if self._try_preempt(js, active, cluster, now, used):
                self._fold(js.placement, used)
                self._gang_wake(failed)
                if rec is not None:
                    rec.decision("admit", now, job=js.job.name,
                                 data={"gpus": js.total_gpus,
                                       "queued_s": now - js.job.submit})
            else:
                self._gang_fail(failed, sig, js)
        queued_be = sorted([j for j in active if j.status == "queued"
                            and not j.job.guaranteed],
                           key=lambda j: j.job.submit)
        for js in queued_be:
            sig = self._gang_sig(js)
            if sig in failed:
                continue
            if self._gang_place(js, active, cluster, now, used):
                self._fold(js.placement, used)
                self._gang_wake(failed)
                if rec is not None:
                    rec.decision("admit", now, job=js.job.name,
                                 data={"gpus": js.total_gpus,
                                       "queued_s": now - js.job.submit})
            else:
                self._gang_fail(failed, sig, js)
        if self._san is not None:
            self._san.end_pass(active, cluster, None, self)
        if rec is not None:
            # lint: nondeterminism — profiler span, wall clock by design
            rec.span_since("pass", t_pass, now, engine="gang")

    def _try_preempt(self, js, active, cluster, now, used) -> bool:
        """Preempt best-effort jobs one at a time until the guaranteed
        job places (honoring its exact resource guarantee).  Returns
        True when placed; on failure every eviction is rolled back —
        bugfix: evicting every best-effort job and STILL not placing the
        guaranteed one left all victims evicted for zero gain."""
        be = [j for j in active if j.status == "running"
              and not j.job.guaranteed]
        preempted: list[tuple] = []
        rec = self.recorder
        for victim in be:
            preempted.append((victim, dict(victim.placement),
                              victim.plan, victim.alloc,
                              victim.n_reconfig))
            self._fold(victim.placement, used, sign=-1)
            victim.status = "queued"
            victim.placement = {}
            victim.plan = None
            victim.alloc = None
            victim.n_reconfig += 1
            if self._gang_place(js, active, cluster, now, used):
                if rec is not None:
                    # emit only on success: failed walks roll back below
                    for v, placement, _p, _a, _n in preempted:
                        rec.decision(
                            "preempt", now, job=v.job.name,
                            cause=js.job.name,
                            data={"from_gpus": sum(
                                g for g, _, _ in placement.values())})
                return True
        for victim, placement, plan, alloc, n_rcfg in preempted:
            victim.status = "running"
            victim.placement = placement
            victim.plan = plan
            victim.alloc = alloc
            victim.n_reconfig = n_rcfg
            self._fold(placement, used)
        return False


ALL = {
    "rubick": make_rubick,
    "rubick-e": make_rubick_e,
    "rubick-r": make_rubick_r,
    "rubick-n": make_rubick_n,
    "sia": lambda env=None, quotas=None, pass_engine=None:
        SiaLike(env, quotas, pass_engine),
    "synergy": lambda env=None, quotas=None, pass_engine=None:
        SynergyLike(env, quotas, pass_engine),
    "antman": lambda env=None, quotas=None, pass_engine=None:
        AntManLike(env, quotas, pass_engine),
}
