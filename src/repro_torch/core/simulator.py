"""Cluster simulator (paper Sec 7.4): event-driven engine + discrete loop.

A copy of ``repro.core.simulator`` for the port, held to the
reference's ``SimResult`` field by field by ``tests/test_torch_sim.py``.
Its oracle may be ``TorchMicroOracle``, whose ``measure`` times one-card
plans on the device; the profiling fallback (``_prefit`` / ``_fitted``)
then needs multi-card samples it cannot time, so give such a run a
``fit_cache``.

Jobs progress at the ORACLE's throughput (the stand-in for real cluster
measurements — the scheduler only ever sees its own fitted model), the
scheduler runs on cluster-state changes, and each plan/allocation change
pauses the job for the checkpoint-resume cost δ.

Two engines share the same semantics:

  * ``mode="event"`` (default) keeps a priority queue of arrival /
    completion / pause-expiry events and advances time EXACTLY to the next
    event.  The scheduler runs only when cluster state actually changes
    (arrival or completion); oracle throughput is re-measured only when a
    job's (plan, alloc, placement) changes, since the oracle is a pure
    function of those.  Completion events are invalidated by a per-job
    epoch counter whenever the job's assignment (and hence its finish
    estimate) changes.  Each pass hands the scheduler the event-scoped
    dirty set (``cluster.SchedEvents``: arrivals + completions with the
    placement they freed) so an incremental pass engine can update its
    persistent indices instead of rebuilding them from every job.
  * ``mode="discrete"`` is the original fixed-step reference loop
    (``dt = max(dt, 1.0)``), kept for parity pinning — the event engine
    must reproduce its JCT/makespan within 1% on seed traces.

Shared accounting fixes (previously hidden by the coarse fixed step):
``run_time`` counts ALL wall-clock seconds in the running state including
reconfiguration pauses (it is the T of the reconfig-penalty guard), and a
pause expiring mid-window contributes the post-resume fraction of the
window at the job's real throughput instead of the 0 sampled at the paused
instant.

Heterogeneous clusters: a job's true throughput is measured with the Env
of the GPU type it is placed on (``cluster.envs``); placements never span
GPU types (the scheduler walks one type group at a time).

Online calibration (``repro_torch.calibration``): pass a ``CalibrationManager``
and the simulator emits runtime telemetry — measured T_iter at completion
events, reschedule points, and a periodic ``EV_TELEMETRY`` event — then
applies drift-triggered refits mid-simulation: every live job of the
refit model type gets the new params (``min_res``/``baseline_perf`` reset
for recomputation), and the scheduler pass at that event receives the
refit in ``SchedEvents.refit`` so BOTH pass engines invalidate their
identity-keyed state (incremental ≡ full stays bit-exact across refits).
With a ``drifting=True`` oracle, telemetry events also re-measure running
jobs (the truth moves between assignments) and re-arm their completions.

Failure & elasticity engine: pass ``capacity`` (a list of
``trace.CapacityEvent``) and both engines kill/restore nodes mid-run via
EV_NODE_FAIL / EV_NODE_RECOVER / EV_SPOT_ARRIVE / EV_SPOT_REVOKE heap
events.  A node loss evicts every resident job through the scheduler's
recovery policy (``RubickScheduler.recover``: shrink onto the surviving
placement via ``best_plan_at_most``, kill-and-requeue when nothing
feasible survives — or always, under ``cfg.recovery="kill"``), rolls its
progress back to the last checkpoint (periodic every ``ckpt_interval``
seconds; revoke-with-warning drains to a clean checkpoint first and
loses nothing), and charges a restore pause from the checkpoint-state
size (``memory.restore_cost`` — the same pricing
``checkpoint.restore_cost_estimate`` applies to real pytrees).  The
scheduler pass at a capacity event receives the deltas in
``SchedEvents`` (node_down / node_up / evicted) so the incremental pass
engine folds lost capacity out of its persistent indices.

Gray-failure resilience: pass ``degradation`` (a list of
``trace.DegradationEvent``) and both engines multiply measured T_iter
of every job touching a degraded node by the node's slowdown factor
(the gang runs at its slowest worker) — nothing is freed, the
scheduler stays oblivious until telemetry reveals the gap.  Pass
``health`` (a ``repro_torch.health.HealthMonitor``) and telemetry
observations also feed node-blame attribution: quarantine decisions at
telemetry ticks flow into the scheduler (walks skip quarantined nodes)
and resident victims are migrated away via the recovery policy, while
the calibration manager masks degraded-node observations so a
throttled GPU never triggers a bogus refit.  Pass ``flaky`` (a
``repro_torch.health.FlakyOps``) and reconfiguration / checkpoint / restore
operations can fail: each failed attempt burns timeout + exponential
backoff as pause time, and budget exhaustion rolls an elective
reconfiguration back to the prior committed plan (kill-and-requeue if
the old slots were taken), re-queues a failed restore, and debits the
target nodes' health scores.
"""

from __future__ import annotations

import heapq
import itertools
import math
import warnings
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.cluster import (Cluster, Job, JobState, SchedEvents,
                                      check_capacity, state_digest,
                                      used_per_node)
from repro_torch.core.fitting import fit_batch
from repro_torch.core.memory import restore_cost
from repro_torch.core.oracle import (AnalyticOracle, profiling_requests,
                                     profiling_samples)
from repro_torch.core.perfmodel import (Env, FitParams, fit, fit_key,
                                        predict_titer)
from repro_torch.core.sensitivity import get_curve

# A guaranteed job "violates" when its measured throughput drops below its
# baseline (requested resources + original plan) by more than this margin;
# the slack absorbs the oracle's plan-family wiggle (±6%) and measurement
# noise so only genuine under-allocation counts.
GUARANTEE_TOL = 0.1

# event kinds, in tie-break order at one instant: arrivals, completions
# and capacity changes (the state changes) are folded into a single
# scheduler pass, then pause expiries resume jobs, then telemetry samples
# the settled state
EV_ARRIVAL, EV_COMPLETION = 0, 1
EV_NODE_FAIL, EV_NODE_RECOVER, EV_SPOT_ARRIVE, EV_SPOT_REVOKE = 2, 3, 4, 5
EV_PAUSE_END, EV_TELEMETRY = 6, 7
# gray failures: appended after the existing kinds so same-instant
# tie-break order is unchanged; within one batch the engine applies
# capacity first, then degradation, then telemetry reads the settled
# state (the manual ordering below, not the heap, decides)
EV_DEGRADE = 8

# CapacityEvent.kind label -> heap event kind (unknown labels dispatch on
# the event's ``down`` flag — the semantics live there, kinds are labels)
_CAP_EV = {"fail": EV_NODE_FAIL, "recover": EV_NODE_RECOVER,
           "spot-arrive": EV_SPOT_ARRIVE, "spot-revoke": EV_SPOT_REVOKE}


@dataclass
class SimResult:
    scheduler: str
    jcts: dict[str, float]
    makespan: float
    n_reconfig: int
    guarantee_violations: int
    jct_by_class: dict[str, list[float]] = field(default_factory=dict)
    n_events: int = 0                 # event-engine: events processed
    n_sched_calls: int = 0            # full scheduler passes
    # model types whose initial fit fell back to default FitParams (too
    # few feasible profiling samples) — uncalibrated until a refit
    unfitted: list[str] = field(default_factory=list)
    n_refits: int = 0                 # online calibration refits applied
    # failure & elasticity counters
    n_cap_events: int = 0             # capacity events applied
    n_shrink_recover: int = 0         # evictions survived by shrinking
    n_kill_requeue: int = 0           # evictions that killed-and-requeued
    # gray-failure counters
    n_degrade_events: int = 0         # degradation transitions applied
    n_quarantined: int = 0            # quarantine decisions (nodes)
    n_migrate: int = 0                # residents migrated off quarantine
    n_op_retries: int = 0             # flaky-op attempts that retried
    n_op_rollbacks: int = 0           # flaky-op budgets exhausted
    # observability (repro_torch.obs): the run's FlightRecorder when tracing was
    # on, plus downtime accounting DERIVED from its pause events — the
    # recorder is the single source of truth, not ad-hoc counters
    telemetry: object | None = None
    total_paused_s: float = 0.0       # reconfig + restore pauses, all jobs
    restore_paused_s: float = 0.0     # checkpoint-restore share of the above
    downtime_by_job: dict[str, float] = field(default_factory=dict)

    @property
    def avg_jct(self) -> float:
        return float(np.mean(list(self.jcts.values()))) if self.jcts else 0.0

    @property
    def p99_jct(self) -> float:
        if not self.jcts:
            return 0.0
        return float(np.percentile(list(self.jcts.values()), 99))

    def summary(self) -> dict:
        out = {"scheduler": self.scheduler,
               "avg_jct_h": self.avg_jct / 3600,
               "p99_jct_h": self.p99_jct / 3600,
               "makespan_h": self.makespan / 3600,
               "n_reconfig": self.n_reconfig,
               "guarantee_violations": self.guarantee_violations}
        if self.unfitted:
            out["unfitted_models"] = list(self.unfitted)
        if self.n_refits:
            out["n_refits"] = self.n_refits
        if self.n_cap_events:
            out["n_cap_events"] = self.n_cap_events
            out["n_shrink_recover"] = self.n_shrink_recover
            out["n_kill_requeue"] = self.n_kill_requeue
        if self.n_degrade_events:
            out["n_degrade_events"] = self.n_degrade_events
        if self.n_quarantined:
            out["n_quarantined"] = self.n_quarantined
            out["n_migrate"] = self.n_migrate
        if self.n_op_retries or self.n_op_rollbacks:
            out["n_op_retries"] = self.n_op_retries
            out["n_op_rollbacks"] = self.n_op_rollbacks
        if self.total_paused_s:
            out["total_paused_h"] = self.total_paused_s / 3600
            out["restore_paused_h"] = self.restore_paused_s / 3600
        for cls, vals in self.jct_by_class.items():
            out[f"avg_jct_{cls}_h"] = float(np.mean(vals)) / 3600 if vals else 0
        return out


class Simulator:
    def __init__(self, cluster: Cluster, scheduler, oracle=None,
                 env: Env | None = None, reconfig_cost: float = 78.0,
                 fit_cache: dict | None = None, mode: str = "event",
                 calibration=None, telemetry_interval: float = 300.0,
                 capacity: list | None = None,
                 ckpt_interval: float = 1800.0,
                 recorder=None, degradation: list | None = None,
                 health=None, flaky=None):
        self.cluster = cluster
        self.scheduler = scheduler
        self.env = env or Env()
        self.oracle = oracle or AnalyticOracle(env=self.env)
        self.reconfig_cost = reconfig_cost
        self.fit_cache = fit_cache if fit_cache is not None else {}
        self.mode = mode
        # capacity dynamics (trace.CapacityEvent list) + periodic-
        # checkpoint cadence bounding the work a hard failure loses
        self.capacity = capacity
        self.ckpt_interval = ckpt_interval
        # gray failures: degradation event stream
        # (trace.DegradationEvent), optional HealthMonitor, optional
        # FlakyOps; the live per-node slowdown multiplier map is the
        # injection's only planted state — the oracle stays pure
        self.degradation = degradation
        self.health = health
        self.flaky = flaky
        self._slowdown: dict[int, float] = {}
        # online calibration (repro_torch.calibration.CalibrationManager or any
        # object with ensure/observe/poll); None = telemetry disabled
        self.calibration = calibration
        self.telemetry_interval = telemetry_interval
        self._unfitted: set[tuple] = set()   # fit_keys that fell back to
                                             # default FitParams
        # drifting oracles take the measurement time (the hidden truth
        # moves); static oracles keep their plain signature
        self._drifting = bool(getattr(self.oracle, "drifting", False))
        # flight recorder (repro_torch.obs.FlightRecorder); None = tracing off.
        # Every emit site below is a single guarded branch, so a run with
        # no recorder executes byte-identical decision code.  The one
        # recorder is threaded into the scheduler (decision/profiler
        # emits) and the calibration manager (refit emits).
        self.recorder = recorder
        if recorder is not None:
            if getattr(scheduler, "recorder", None) is None:
                scheduler.recorder = recorder
            if calibration is not None \
                    and getattr(calibration, "recorder", None) is None:
                calibration.recorder = recorder
        self._san = None
        from repro_torch.analysis import sanitize_enabled
        if sanitize_enabled(getattr(scheduler, "cfg", None)):
            from repro_torch.analysis.sanitizer import SchedSanitizer
            self._san = SchedSanitizer()

    # ------------------------------------------------------------------
    def _prefit(self, jobs: list[Job]) -> None:
        """Fit every cache-missed model type of a trace in ONE
        ``fit_batch`` call before the run starts — all profiles' restarts
        step as a single batched simplex tensor instead of one serial
        scipy run per type (``_fitted`` then always cache-hits)."""
        missing: dict[tuple, object] = {}
        for job in jobs:
            key = fit_key(job.profile)
            if key not in self.fit_cache and key not in missing:
                missing[key] = job.profile
        if not missing:
            return
        requests, skipped = profiling_requests(missing.values(),
                                               self.oracle, self.env)
        for req, params in zip(requests, fit_batch(requests)):
            self.fit_cache[fit_key(req.profile)] = params
        for profile, skipped_samples in skipped:
            key = fit_key(profile)
            self.fit_cache[key] = FitParams()
            self._unfitted.add(key)
            warnings.warn(
                f"{profile.name}: only {len(skipped_samples)} feasible "
                "profiling samples (<4); falling back to default "
                "FitParams — predictions are uncalibrated until an "
                "online refit", stacklevel=2)

    def _fitted(self, job: Job) -> FitParams:
        """Per-model-type fitted params (paper: model reused across jobs of
        the same model-type flag; profiling takes ~210 s once).  Keyed on
        the FULL profile identity (``perfmodel.fit_key``): two jobs
        sharing a name and batch size but differing in sequence length or
        depth must not share fitted params."""
        key = fit_key(job.profile)
        params = self.fit_cache.get(key)
        if params is None:
            samples = profiling_samples(job.profile, self.oracle)
            if len(samples) >= 4:
                params = fit(job.profile, samples, self.env)
            else:
                params = FitParams()
                self._unfitted.add(key)
                warnings.warn(
                    f"{job.profile.name}: only {len(samples)} feasible "
                    "profiling samples (<4); falling back to default "
                    "FitParams — predictions are uncalibrated until an "
                    "online refit", stacklevel=2)
            self.fit_cache[key] = params
        if self.calibration is not None:
            self.calibration.ensure(job.profile, params,
                                    fallback=key in self._unfitted)
        return params

    def _env_of(self, js: JobState) -> Env:
        """Env of the GPU type hosting the job (placements are single-type
        by construction); the simulator default when unplaced/homogeneous."""
        if self.cluster.is_hetero and js.placement:
            nid = next(iter(js.placement))
            return self.cluster.env_for(nid, self.env) or self.env
        return self.env

    def _true_throughput(self, js: JobState, now: float = 0.0) -> float:
        if js.status != "running" or js.plan is None or js.alloc is None:
            return 0.0
        if self._drifting:
            t = self.oracle.measure(js.job.profile, js.plan, js.alloc,
                                    env=self._env_of(js), now=now)
        else:
            t = self.oracle.measure(js.job.profile, js.plan, js.alloc,
                                    env=self._env_of(js))
        if self._slowdown:
            # gray failure: the gang is gated by its slowest worker, so
            # measured T_iter scales by the worst factor over placement
            f = max((self._slowdown.get(nid, 1.0)
                     for nid in js.placement), default=1.0)
            if f > 1.0:
                t *= f
        return js.job.profile.b / t if math.isfinite(t) and t > 0 else 0.0

    def _observe(self, js: JobState, thpt: float, now: float) -> None:
        """Emit one telemetry observation (measured T_iter) for a running
        job — the calibration manager and the health monitor consume the
        SAME stream (the prediction is computed once for both)."""
        cal, hm = self.calibration, self.health
        if (cal is None and hm is None) or thpt <= 0.0:
            return
        t_iter = js.job.profile.b / thpt
        nodes = frozenset(js.placement)
        pred = None
        if hm is not None and js.fitted is not None \
                and js.plan is not None and js.alloc is not None:
            pred = predict_titer(js.job.profile, js.plan, js.alloc,
                                 self._env_of(js), js.fitted)
            if math.isfinite(pred) and pred > 0.0:
                hm.observe(now, js.job.name, fit_key(js.job.profile),
                           nodes, t_iter, pred)
            else:
                pred = None
        if cal is not None:
            cal.observe(js.job.profile, js.fitted, js.plan,
                        js.alloc, self._env_of(js), t_iter, now,
                        nodes=nodes, predicted=pred)

    def _apply_refit(self, refit, states: list[JobState],
                     active_ids: set[int]) -> list[tuple[JobState,
                                                         FitParams]]:
        """Swap a refit's new params into every live job still carrying
        the retired ones, resetting the derived per-job state (minRes,
        guarantee baseline) so the next scheduler pass recomputes it
        under the new curve.  Returns the (job, old params) pairs for
        ``SchedEvents.refit`` — active jobs only; pending arrivals are
        swapped too but enter the scheduler's indices on arrival."""
        key = fit_key(refit.profile)
        self.fit_cache[key] = refit.new
        # the published params are a real telemetry fit now, not the
        # default fallback: stop treating the type as uncalibrated
        # (a later run() would otherwise re-register it as a priority
        # candidate that refits unconditionally forever)
        self._unfitted.discard(key)
        out = []
        for s in states:
            if s.fitted is not refit.old or s.status == "done":
                continue
            s.fitted = refit.new
            s.min_res = None
            s.baseline_perf = 0.0
            if id(s) in active_ids:
                out.append((s, refit.old))
        return out

    def _prewarm(self, states: list[JobState]) -> None:
        """Pre-warm the process-wide CurveCache: every job of the same
        model type + fitted params shares one materialized envelope with
        the scheduler, per GPU-type Env on heterogeneous clusters."""
        cfg = getattr(self.scheduler, "cfg", None)
        if cfg is None:
            return
        envs = [self.env] + list(self.cluster.envs.values())
        for s in {(s.job.profile, s.fitted): s for s in states}.values():
            for env in envs:
                get_curve(s.job.profile, s.fitted, env,
                          max_gpus=self.cluster.total_gpus,
                          cpus_per_gpu=cfg.cpus_per_gpu, max_ga=cfg.max_ga,
                          engine=getattr(cfg, "curve_engine", "batch"))

    # ------------------------------------------------------------------
    # capacity dynamics (failure & elasticity engine) — shared by both
    # simulation engines
    # ------------------------------------------------------------------
    def _restore_cost(self, profile) -> float:
        """Seconds a restart from the last checkpoint costs: reload
        weights + optimizer states from shared storage (the same pricing
        ``checkpoint.restore_cost_estimate`` applies to real pytrees)."""
        return restore_cost(profile=profile)

    def _sample_metrics(self, fr, t: float, active: list[JobState],
                        violations: int, thpt_map: dict) -> None:
        """One time-series sample at an event boundary: utilization,
        queue depth, per-class goodput (samples/s, paused jobs count 0),
        cumulative guarantee violations, live capacity — plus the
        cluster-state digest stamped onto subsequent decision events.
        ``thpt_map`` is the engine's id(js)-keyed throughput map (keys
        pinned by the run's states list)."""
        used_g = used_c = 0
        used_m = 0.0
        n_run = n_q = 0
        good_g = good_b = 0.0
        for s in active:
            if s.status == "running":
                n_run += 1
                used_g += s.total_gpus
                used_c += s.total_cpus
                for _, _, m in s.placement.values():
                    used_m += m
                th = 0.0 if s.pause_until > t \
                    else thpt_map.get(id(s), 0.0)
                if s.job.guaranteed:
                    good_g += th
                else:
                    good_b += th
            elif s.status == "queued":
                n_q += 1
        live_g = live_c = 0
        live_m = 0.0
        for node in self.cluster.nodes:
            if node.up:
                live_g += node.gpus
                live_c += node.cpus
                live_m += node.mem
        fr.sample(t,
                  gpu_util=used_g / max(live_g, 1),
                  cpu_util=used_c / max(live_c, 1),
                  hostmem_util=used_m / max(live_m, 1e-9),
                  queue_depth=n_q,
                  n_running=n_run,
                  live_gpus=live_g,
                  goodput_guaranteed=good_g,
                  goodput_best_effort=good_b,
                  violations=violations)
        fr.set_digest(state_digest(self.cluster, active))

    def _apply_capacity(self, batch, active: list[JobState],
                        now: float) -> tuple[list[int], list[int], list]:
        """Apply one instant's capacity events: flip node availability,
        then run the recovery policy over every running resident of a
        lost node.  Returns ``(down_ids, up_ids, affected)`` where
        ``affected`` holds ``(job, pre-loss placement, outcome)`` — the
        engine-specific bookkeeping (completion re-arming, pause events,
        SchedEvents deltas) happens at the call sites."""
        cluster = self.cluster
        fr = self.recorder
        down: list[int] = []
        up: list[int] = []
        graceful: set[int] = set()
        for ce in batch:
            node = cluster.nodes[ce.node]
            if ce.down:
                if node.up:
                    node.up = False
                    down.append(ce.node)
                    if ce.warning_s > 0.0:
                        graceful.add(ce.node)
                    if fr is not None:
                        fr.decision("capacity", now, data={
                            "node": ce.node, "kind": ce.kind,
                            "down": True})
            elif not node.up:
                node.up = True
                up.append(ce.node)
                if fr is not None:
                    fr.decision("capacity", now, data={
                        "node": ce.node, "kind": ce.kind, "down": False})
        affected = []
        if down:
            down_set = set(down)
            for s in active:
                if s.status == "running" and down_set & s.placement.keys():
                    affected.append(self._evict_resident(
                        s, active, down_set, graceful, now))
        return down, up, affected

    def _evict_resident(self, s: JobState, active: list[JobState],
                        down_set: set[int], graceful: set[int],
                        now: float) -> tuple:
        """Recovery for ONE running job that lost nodes: roll progress
        back to the last checkpoint (a graceful revoke drained to a clean
        checkpoint during its warning — nothing lost; a hard failure
        loses up to ``ckpt_interval`` of work), delegate the placement
        decision to the scheduler's recovery policy, and charge the
        checkpoint-restore pause (shrunk jobs pause in place; killed jobs
        pay it on their next start via ``needs_restore``)."""
        before = dict(s.placement)
        fr = self.recorder
        prog0 = s.progress
        clean = down_set & before.keys() <= graceful
        if clean and self.flaky is not None:
            # flaky drain checkpoint: budget exhaustion degrades the
            # graceful revoke to a hard failure (the warning expired
            # before a checkpoint landed)
            o = self.flaky.attempt("checkpoint", s.job.name)
            if fr is not None and o.n_attempts > 1:
                fr.decision("retry", now, job=s.job.name,
                            cause="checkpoint",
                            data={"attempts": o.n_attempts, "ok": o.ok,
                                  "delay_s": round(o.delay_s, 1)})
            if not o.ok:
                clean = False
                if self.health is not None:
                    for nid in sorted(down_set & before.keys()):
                        self.health.debit(now, nid, reason="op-fail")
        if clean:
            s.ckpt_progress = s.progress     # drained during the warning
            if fr is not None:
                fr.decision("checkpoint", now, job=s.job.name,
                            cause="drain")
        else:
            th = self._true_throughput(s, now)
            lag = th * self.ckpt_interval / s.job.profile.b
            s.progress = max(s.ckpt_progress, s.progress - lag)
            s.ckpt_progress = s.progress
        rec = getattr(self.scheduler, "recover", None)
        if rec is not None:
            outcome = rec(s, active, self.cluster, down_set, now)
        else:
            s.status = "queued"
            s.placement = {}
            s.plan = None
            s.alloc = None
            outcome = "killed"
        if outcome == "shrunk":
            old_pu = s.pause_until
            s.pause_until = max(s.pause_until,
                                now + self._restore_cost(s.job.profile))
            s.needs_restore = False
            if fr is not None:
                fr.pause(s.job.name, "restore",
                         s.pause_until - max(old_pu, now), now)
        else:
            s.pause_until = 0.0
            s.needs_restore = True
        if fr is not None:
            # the provenance row: which node flips hit this job, what
            # the recovery chose, and what the rollback cost in work
            fr.decision("evict", now, job=s.job.name, cause=outcome,
                        data={"nodes": sorted(down_set & before.keys()),
                              "lost_iters": prog0 - s.progress,
                              "kept_gpus": s.total_gpus})
        return s, before, outcome

    # ------------------------------------------------------------------
    # gray-failure dynamics — shared by both engines
    # ------------------------------------------------------------------
    def _apply_degradation(self, batch, now: float) -> set[int]:
        """Apply one instant's degradation transitions to the per-node
        slowdown map.  Returns the touched node ids so the event engine
        can re-measure (and re-arm) affected running jobs.  The
        scheduler is NOT notified — a gray failure frees nothing, and
        only the health monitor's telemetry attribution may react."""
        fr = self.recorder
        changed: set[int] = set()
        for de in batch:
            if de.factor > 1.0:
                self._slowdown[de.node] = de.factor
            else:
                self._slowdown.pop(de.node, None)
            changed.add(de.node)
            if fr is not None:
                fr.decision("degrade", now, data={
                    "node": de.node, "factor": de.factor,
                    "kind": de.kind})
        return changed

    def _poll_health(self, active: list[JobState], now: float):
        """Run the health monitor at a telemetry tick: refresh the
        calibration exclusion, push quarantine/release decisions into
        the scheduler, and migrate running victims off newly
        quarantined nodes.  Returns ``(report, affected)`` with
        ``affected`` shaped like ``_apply_capacity``'s."""
        hm = self.health
        rep = hm.poll(now)
        if self.calibration is not None:
            self.calibration.set_excluded(hm.excluded_nodes)
        sq = getattr(self.scheduler, "set_quarantine", None)
        if sq is None:
            return rep, []
        sq(add=rep.quarantine, release=rep.release,
           scores=dict(hm.scores))
        fr = self.recorder
        if fr is not None:
            for nid in rep.quarantine:
                fr.decision("quarantine", now, data={
                    "node": nid, "score": hm.score(nid), "on": True})
            for nid in rep.release:
                fr.decision("quarantine", now, data={
                    "node": nid, "score": hm.score(nid), "on": False})
        affected = []
        if rep.quarantine:
            newq = set(rep.quarantine)
            for s in active:
                if s.status == "running" and newq & s.placement.keys():
                    affected.append(
                        self._migrate_victim(s, active, newq, now))
        if self._san is not None:
            self._san.check_health(hm, self.scheduler)
        return rep, affected

    def _migrate_victim(self, s: JobState, active: list[JobState],
                        newq: set[int], now: float) -> tuple:
        """Migrate-away for ONE running job touching a quarantined node.
        The node is slow, not dead, so the job drains to a clean
        checkpoint in place (nothing lost), then the scheduler's
        recovery policy re-plans over the healthy slice of its
        placement; a reconfiguration pause is charged instead of a
        restore (checkpoint-resume, no reload from storage)."""
        before = dict(s.placement)
        fr = self.recorder
        s.ckpt_progress = s.progress         # clean drain
        outcome = self.scheduler.recover(s, active, self.cluster, newq,
                                         now)
        if outcome == "shrunk":
            old_pu = s.pause_until
            s.pause_until = max(s.pause_until, now + self.reconfig_cost)
            s.needs_restore = False
            if fr is not None:
                fr.pause(s.job.name, "reconfig",
                         s.pause_until - max(old_pu, now), now)
        else:
            s.pause_until = 0.0
            s.needs_restore = True
        if fr is not None:
            fr.decision("mitigate", now, job=s.job.name, cause=outcome,
                        data={"nodes": sorted(newq & before.keys()),
                              "kept_gpus": s.total_gpus})
        return s, before, outcome

    def _flaky_op(self, op: str, s: JobState, now: float):
        """One flaky-operation attempt sequence (None = flaky off or op
        type not selected: zero-cost success)."""
        fl = self.flaky
        if fl is None:
            return None
        o = fl.attempt(op, s.job.name)
        if o.n_attempts <= 1 and o.ok:
            return o
        fr = self.recorder
        if fr is not None:
            fr.decision("retry", now, job=s.job.name, cause=op,
                        data={"attempts": o.n_attempts, "ok": o.ok,
                              "delay_s": round(o.delay_s, 1)})
        if not o.ok and self.health is not None:
            # exhaustion debits the op's target nodes — repeated op
            # failures against one node drive it toward quarantine
            for nid in sorted(s.placement):
                self.health.debit(now, nid, reason="op-fail")
        return o

    def _rollback_reconfig(self, s: JobState, plan0, alloc0,
                           content0: dict, placement0: dict,
                           active: list[JobState], now: float) -> str:
        """An elective reconfiguration exhausted its retry budget: put
        the job back on its prior committed plan IF those slots still
        exist (nodes up, unquarantined, capacity free next to the other
        running jobs — the same pass may have handed them out);
        otherwise kill-and-requeue through the restore path.  Either
        way the checkpoint taken before the attempt bounds the loss to
        time, never progress.  ``placement0`` is the pre-pass placement
        dict OBJECT — the rollback restores into it so external
        aliases (sanitizer snapshots) stay truthful."""
        quar = getattr(self.scheduler, "quarantined", set())
        others = used_per_node([j for j in active if j is not s
                                and j.status == "running"])
        ok = True
        for nid, (g, c, m) in content0.items():
            node = self.cluster.nodes[nid]
            if not node.up or nid in quar:
                ok = False
                break
            fg, fc, fm = node.free(others)
            if g > fg or c > fc or m > fm + 1e-3:
                ok = False
                break
        if not ok:
            s.status = "queued"
            s.placement = {}
            s.plan = None
            s.alloc = None
            s.needs_restore = True
            s.pause_until = 0.0
            return "requeued"
        placement0.clear()
        placement0.update(content0)
        s.placement = placement0
        s.plan = plan0
        s.alloc = alloc0
        # n_reconfig stays incremented: the failed attempt and the
        # rollback were real reconfiguration work
        if self._san is not None:
            self._san.check_op_rollback(s, plan0, alloc0, content0)
        return "restored"

    # ------------------------------------------------------------------
    def run(self, jobs: list[Job], max_time: float = 7 * 86400.0,
            mode: str | None = None) -> SimResult:
        mode = mode or self.mode
        if mode == "discrete":
            return self._run_discrete(jobs, max_time)
        if mode != "event":
            raise ValueError(f"unknown simulator mode {mode!r}")
        return self._run_event(jobs, max_time)

    # ------------------------------------------------------------------
    # event-driven engine
    # ------------------------------------------------------------------
    def _run_event(self, jobs: list[Job], max_time: float) -> SimResult:
        self._prefit(jobs)
        states = [JobState(job=j, fitted=self._fitted(j)) for j in jobs]
        self._prewarm(states)
        fr = self.recorder
        if fr is not None:
            fr.meta.setdefault("engine", "event")
            fr.meta.setdefault("scheduler",
                               getattr(self.scheduler, "name", "?"))
            fr.meta.setdefault("n_jobs", len(states))
            fr.meta.setdefault("total_gpus", self.cluster.total_gpus)
        cal = self.calibration
        seq = itertools.count()
        heap: list[tuple[float, int, int, object]] = []
        for s in states:
            heapq.heappush(heap, (s.job.submit, EV_ARRIVAL, next(seq), s))
        for ce in (self.capacity or []):
            kind = _CAP_EV.get(ce.kind,
                               EV_NODE_FAIL if ce.down else EV_NODE_RECOVER)
            heapq.heappush(heap, (ce.time, kind, next(seq), ce))
        for de in (self.degradation or []):
            heapq.heappush(heap, (de.time, EV_DEGRADE, next(seq), de))
        # telemetry ticks run when anything consumes the stream —
        # calibration, the health monitor, or both
        tick = cal is not None or self.health is not None
        if tick and states:
            heapq.heappush(heap, (self.telemetry_interval, EV_TELEMETRY,
                                  next(seq), None))

        active: list[JobState] = []        # arrived, not yet done
        done: list[JobState] = []
        n_pending = len(states)            # arrivals still in the heap
        # id(s)-keyed run-local maps: every key's referent is pinned by
        # ``states`` for the whole run
        epoch: dict[int, int] = {}         # completion-event invalidation
        thpt: dict[int, float] = {}        # oracle samples/s per assignment
        violations = n_events = n_sched = n_refits = 0
        n_cap = n_shrink = n_kill = 0
        n_deg = n_quar = n_migrate = 0
        t = 0.0
        san = self._san
        fl = self.flaky
        note_move = getattr(self.scheduler, "note_external_move", None)

        def advance(to: float) -> None:
            """Integrate progress/run_time over [t, to]: throughput is
            piecewise-constant between events, pauses contribute exactly
            their overlap with the window (the post-resume fraction runs
            at the job's real rate — the old fixed-step loop dropped it)."""
            dt = to - t
            if dt <= 0.0:
                return
            for s in active:
                if s.status != "running":
                    continue
                old = (s.run_time, s.progress)
                s.run_time += dt           # wall-clock incl. reconfig pause
                pu = s.pause_until
                eff = dt if pu <= t else to - pu
                if eff > 0.0:
                    s.progress += thpt.get(id(s), 0.0) * eff \
                        / s.job.profile.b
                if san is not None:
                    san.check_window(s, old, t, to, pu,
                                     thpt.get(id(s), 0.0))

        def resample(s: JobState, now: float) -> None:
            """Re-measure the oracle (assignment changed — a reschedule
            point, also a telemetry emission) and re-arm the completion
            event from the job's exact remaining work."""
            th = thpt[id(s)] = self._true_throughput(s, now)
            e = epoch[id(s)] = epoch.get(id(s), 0) + 1
            self._observe(s, th, now)
            if th <= 0.0:
                return
            remain = (s.job.target_iters - s.progress) \
                * s.job.profile.b / th
            start = max(now, s.pause_until)
            heapq.heappush(heap, (start + max(remain, 0.0),
                                  EV_COMPLETION, next(seq), (s, e)))

        def check_guarantee(s: JobState, now: float) -> int:
            if not s.job.guaranteed or s.baseline_perf <= 0.0:
                return 0
            if s.status == "running" and s.pause_until <= now:
                th = thpt.get(id(s), 0.0)
                return 1 if th < s.baseline_perf * (1.0 - GUARANTEE_TOL) \
                    else 0
            if s.status == "queued" and s.start_time is not None:
                # an admitted guaranteed job evicted by a capacity loss
                # runs at zero throughput until re-admitted — that counts
                # against its guarantee exactly like under-allocation
                # (no existing path requeues a started guaranteed job,
                # so this clause is inert on failure-free traces)
                return 1
            return 0

        while heap:
            if not active and n_pending == 0:
                break                      # drained: only capacity /
                                           # telemetry events remain
            t_ev = heap[0][0]
            if t_ev > max_time:
                break
            batch = []
            while heap and heap[0][0] <= t_ev + 1e-9:
                batch.append(heapq.heappop(heap))
            advance(t_ev)
            t = t_ev
            n_events += len(batch)
            state_changed = False
            tel_due = False
            resumed: list[JobState] = []
            cap_batch: list = []
            # event-scoped dirty sets: the incremental scheduler engine
            # updates its persistent indices from exactly what changed
            ev_arrived: list[JobState] = []
            ev_completed: list[tuple] = []
            ev_refit: list[tuple] = []
            ev_down: list[int] = []
            ev_up: list[int] = []
            ev_evicted: list[tuple] = []
            ev_quar: list[int] = []
            ev_rel: list[int] = []
            ev_migrated: list[tuple] = []
            deg_batch: list = []
            for _, kind, _, payload in batch:
                if kind == EV_ARRIVAL:
                    active.append(payload)
                    ev_arrived.append(payload)
                    n_pending -= 1
                    state_changed = True
                    if fr is not None:
                        fr.decision("arrival", t, job=payload.job.name)
                elif kind == EV_COMPLETION:
                    s, e = payload
                    if epoch.get(id(s)) != e or s.status != "running":
                        continue                       # stale event
                    s.progress = max(s.progress, s.job.target_iters)
                    s.status = "done"
                    s.finish_time = t
                    # telemetry: the job's last measured rate, at finish
                    self._observe(s, thpt.get(id(s), 0.0), t)
                    ev_completed.append((s, dict(s.placement)))
                    s.placement = {}
                    active.remove(s)
                    done.append(s)
                    state_changed = True
                    if fr is not None:
                        fr.decision("complete", t, job=s.job.name,
                                    data={"jct": t - s.job.submit,
                                          "n_reconfig": s.n_reconfig})
                elif EV_NODE_FAIL <= kind <= EV_SPOT_REVOKE:
                    cap_batch.append(payload)
                elif kind == EV_DEGRADE:
                    deg_batch.append(payload)
                elif kind == EV_PAUSE_END:
                    s = payload
                    if s.status == "running" \
                            and s.pause_until <= t + 1e-9:
                        resumed.append(s)
                else:                                  # EV_TELEMETRY
                    tel_due = True

            if cap_batch:
                ev_down, ev_up, affected = self._apply_capacity(
                    cap_batch, active, t)
                n_cap += len(ev_down) + len(ev_up)
                for s, before, outcome in affected:
                    ev_evicted.append((s, before))
                    if outcome == "shrunk":
                        n_shrink += 1
                        # restore pause charged in place; completion
                        # re-armed from the shrunk assignment
                        heapq.heappush(heap, (s.pause_until, EV_PAUSE_END,
                                              next(seq), s))
                        resample(s, t)
                    elif outcome == "killed":
                        n_kill += 1
                        epoch[id(s)] = epoch.get(id(s), 0) + 1
                        thpt.pop(id(s), None)
                if ev_down or ev_up or ev_evicted:
                    state_changed = True

            if deg_batch:
                # gray failures: re-measure (and re-arm completions of)
                # every running job touching a changed node.  NOT a
                # state change — the scheduler stays oblivious until the
                # health monitor attributes the telemetry gap.
                changed = self._apply_degradation(deg_batch, t)
                n_deg += len(deg_batch)
                for s in active:
                    if s.status == "running" \
                            and changed & s.placement.keys():
                        resample(s, t)

            if tel_due:
                # periodic telemetry: sample every running unpaused job.
                # Under a drifting oracle the truth moved since the last
                # assignment change, so re-measure and re-arm completions
                # (resample also records the observation); otherwise the
                # cached per-assignment sample is still exact — record it
                # without touching simulation dynamics.
                for s in active:
                    if s.status != "running" or s.pause_until > t:
                        continue
                    if self._drifting:
                        resample(s, t)
                    else:
                        self._observe(s, thpt.get(id(s), 0.0), t)
                if self.health is not None:
                    # health attribution runs AFTER this tick's
                    # observations and BEFORE the calibration poll, so
                    # a fresh exclusion masks this tick's drift check
                    rep, affected = self._poll_health(active, t)
                    ev_quar = list(rep.quarantine)
                    ev_rel = list(rep.release)
                    n_quar += len(ev_quar)
                    for s, before, outcome in affected:
                        ev_migrated.append((s, before))
                        n_migrate += 1
                        if outcome == "shrunk":
                            heapq.heappush(heap, (s.pause_until,
                                                  EV_PAUSE_END,
                                                  next(seq), s))
                            resample(s, t)
                        else:
                            epoch[id(s)] = epoch.get(id(s), 0) + 1
                            thpt.pop(id(s), None)
                    if ev_quar or ev_rel:
                        state_changed = True
                if cal is not None:
                    for refit in cal.poll(t):
                        ev_refit += self._apply_refit(
                            refit, states, {id(s) for s in active})
                        n_refits += 1
                if ev_refit:
                    state_changed = True
                if active or heap:     # quiesced + drained ⇒ stop ticking
                    heapq.heappush(heap, (t + self.telemetry_interval,
                                          EV_TELEMETRY, next(seq), None))

            if state_changed:
                prev = {id(s): (s.plan, s.alloc, s.status, s.placement,
                                dict(s.placement) if fl is not None
                                else None)
                        for s in active}
                if getattr(self.scheduler, "accepts_events", False):
                    self.scheduler.schedule(
                        active, self.cluster, t,
                        events=SchedEvents(arrived=ev_arrived,
                                           completed=ev_completed,
                                           refit=ev_refit,
                                           node_down=ev_down,
                                           node_up=ev_up,
                                           evicted=ev_evicted,
                                           quarantined=ev_quar,
                                           released=ev_rel,
                                           migrated=ev_migrated))
                else:
                    self.scheduler.schedule(active, self.cluster, t)
                n_sched += 1
                assert check_capacity(self.cluster, active), \
                    "over-allocation"
                for s in active:
                    was = prev[id(s)]
                    if s.status == "running":
                        if was[2] != "running":        # (re)started
                            if s.needs_restore:
                                # killed by a capacity loss: the restart
                                # reloads the checkpoint before training
                                s.needs_restore = False
                                o = self._flaky_op("restore", s, t)
                                if o is not None and not o.ok:
                                    # restore exhausted: back to the
                                    # queue, placement freed; the next
                                    # admission retries a fresh restore
                                    before_rb = dict(s.placement)
                                    s.status = "queued"
                                    s.placement = {}
                                    s.plan = None
                                    s.alloc = None
                                    s.needs_restore = True
                                    s.pause_until = 0.0
                                    if note_move is not None:
                                        note_move(s, before_rb)
                                    epoch[id(s)] = epoch.get(id(s),
                                                             0) + 1
                                    thpt.pop(id(s), None)
                                    continue
                                delay = o.delay_s if o is not None \
                                    else 0.0
                                old_pu = s.pause_until
                                s.pause_until = max(
                                    s.pause_until,
                                    t + self._restore_cost(s.job.profile)
                                    + delay)
                                heapq.heappush(heap, (s.pause_until,
                                                      EV_PAUSE_END,
                                                      next(seq), s))
                                if fr is not None:
                                    fr.pause(s.job.name, "restore",
                                             s.pause_until
                                             - max(old_pu, t), t)
                            resample(s, t)
                        elif (s.plan, s.alloc) != was[:2]:
                            # checkpoint-resume: the reconfiguration saves
                            # a checkpoint, so a later failure rolls back
                            # at most to here.  max() keeps a restore
                            # pause charged this instant from shrinking.
                            s.ckpt_progress = s.progress
                            o = self._flaky_op("reconfig", s, t)
                            if o is not None and not o.ok:
                                # retry budget exhausted: roll back to
                                # the prior committed plan (or requeue
                                # if its slots were given away); the
                                # burned attempts are charged as pause
                                before_rb = dict(s.placement)
                                outcome = self._rollback_reconfig(
                                    s, was[0], was[1], was[4], was[3],
                                    active, t)
                                if note_move is not None:
                                    note_move(s, before_rb)
                                if fr is not None:
                                    fr.decision(
                                        "mitigate", t, job=s.job.name,
                                        cause=f"rollback-{outcome}",
                                        data={"burned_s":
                                              round(o.delay_s, 1)})
                                if outcome == "restored":
                                    old_pu = s.pause_until
                                    s.pause_until = max(s.pause_until,
                                                        t + o.delay_s)
                                    heapq.heappush(
                                        heap, (s.pause_until,
                                               EV_PAUSE_END,
                                               next(seq), s))
                                    if fr is not None:
                                        fr.pause(s.job.name, "reconfig",
                                                 s.pause_until
                                                 - max(old_pu, t), t)
                                    resample(s, t)
                                else:
                                    epoch[id(s)] = epoch.get(id(s),
                                                             0) + 1
                                    thpt.pop(id(s), None)
                                continue
                            delay = o.delay_s if o is not None else 0.0
                            old_pu = s.pause_until
                            s.pause_until = max(s.pause_until,
                                                t + self.reconfig_cost
                                                + delay)
                            heapq.heappush(heap, (s.pause_until,
                                                  EV_PAUSE_END, next(seq),
                                                  s))
                            if fr is not None:
                                fr.decision("checkpoint", t,
                                            job=s.job.name,
                                            cause="reconfig")
                                fr.pause(s.job.name, "reconfig",
                                         s.pause_until - max(old_pu, t),
                                         t)
                            resample(s, t)
                        elif s.placement != was[3]:
                            # migrated with identical plan+alloc: the env
                            # (GPU type) may differ — re-measure, but no
                            # pause (the discrete reference pauses only on
                            # plan/alloc changes)
                            resample(s, t)
                    elif was[2] == "running":          # preempted
                        epoch[id(s)] = epoch.get(id(s), 0) + 1
                        thpt.pop(id(s), None)
                        s.pause_until = 0.0
                # performance-guarantee accounting (paper Sec 5.1), sampled
                # at every scheduling point for running unpaused jobs
                for s in active:
                    violations += check_guarantee(s, t)
            for s in resumed:
                violations += check_guarantee(s, t)
            if fr is not None:
                self._sample_metrics(fr, t, active, violations, thpt)

        self.last_states = states          # inspectable by tests/benchmarks
        return self._assemble(active + done, t, violations,
                              n_events=n_events, n_sched=n_sched,
                              n_refits=n_refits, n_cap=n_cap,
                              n_shrink=n_shrink, n_kill=n_kill,
                              n_deg=n_deg, n_quar=n_quar,
                              n_migrate=n_migrate)

    # ------------------------------------------------------------------
    # discrete-time reference loop (the original polling engine)
    # ------------------------------------------------------------------
    def _run_discrete(self, jobs: list[Job], max_time: float) -> SimResult:
        self._prefit(jobs)
        states = [JobState(job=j, fitted=self._fitted(j)) for j in jobs]
        self._prewarm(states)
        fr = self.recorder
        if fr is not None:
            fr.meta.setdefault("engine", "discrete")
            fr.meta.setdefault("scheduler",
                               getattr(self.scheduler, "name", "?"))
            fr.meta.setdefault("n_jobs", len(states))
            fr.meta.setdefault("total_gpus", self.cluster.total_gpus)
        cal = self.calibration
        arrivals = sorted(states, key=lambda s: s.job.submit)
        t = 0.0
        tick = cal is not None or self.health is not None
        next_tel = self.telemetry_interval if tick else math.inf
        pending: list[JobState] = list(arrivals)
        active: list[JobState] = []
        cap = sorted(self.capacity or [],
                     key=lambda e: (e.time, e.node, not e.down))
        ci = 0
        deg = sorted(self.degradation or [],
                     key=lambda e: (e.time, e.node, e.factor))
        di = 0
        fl = self.flaky
        violations = 0
        n_sched = 0
        n_refits = 0
        n_cap = n_shrink = n_kill = 0
        n_deg = n_quar = n_migrate = 0

        def next_arrival() -> float:
            return pending[0].job.submit if pending else math.inf

        while (pending or any(s.status != "done" for s in active)) \
                and t < max_time:
            # admit arrivals at time t
            while pending and pending[0].job.submit <= t + 1e-9:
                js = pending.pop(0)
                active.append(js)
                if fr is not None:
                    fr.decision("arrival", t, job=js.job.name)

            # apply due capacity events (the dt clamp below lands the loop
            # exactly on each event time, mirroring the event engine)
            cap_batch = []
            while ci < len(cap) and cap[ci].time <= t + 1e-9:
                cap_batch.append(cap[ci])
                ci += 1
            if cap_batch:
                down, up, affected = self._apply_capacity(cap_batch,
                                                          active, t)
                n_cap += len(down) + len(up)
                for _s, _before, outcome in affected:
                    if outcome == "shrunk":
                        n_shrink += 1
                    elif outcome == "killed":
                        n_kill += 1

            # apply due degradation transitions (dt clamps below land the
            # loop exactly on each edge; _true_throughput reads the live
            # slowdown map every step, so no re-arming is needed here)
            deg_batch = []
            while di < len(deg) and deg[di].time <= t + 1e-9:
                deg_batch.append(deg[di])
                di += 1
            if deg_batch:
                self._apply_degradation(deg_batch, t)
                n_deg += len(deg_batch)

            prev = {id(s): (s.plan, s.alloc, s.status, s.placement,
                            dict(s.placement) if fl is not None else None)
                    for s in active}
            self.scheduler.schedule(active, self.cluster, t)
            n_sched += 1
            assert check_capacity(self.cluster, active), "over-allocation"
            for s in active:
                if s.status != "running":
                    continue
                was = prev.get(id(s))
                if was and was[2] == "running" \
                        and (s.plan, s.alloc) != was[:2]:
                    # checkpoint-resume: saves a checkpoint (bounds a
                    # later failure's rollback), then pauses for δ
                    s.ckpt_progress = s.progress
                    o = self._flaky_op("reconfig", s, t)
                    if o is not None and not o.ok:
                        # retry budget exhausted: roll back (no ctx
                        # repair needed — this loop passes no events, so
                        # incremental engines rebuild from scratch)
                        outcome = self._rollback_reconfig(
                            s, was[0], was[1], was[4], was[3], active, t)
                        if fr is not None:
                            fr.decision("mitigate", t, job=s.job.name,
                                        cause=f"rollback-{outcome}",
                                        data={"burned_s":
                                              round(o.delay_s, 1)})
                        if outcome == "restored":
                            old_pu = s.pause_until
                            s.pause_until = max(s.pause_until,
                                                t + o.delay_s)
                            if fr is not None:
                                fr.pause(s.job.name, "reconfig",
                                         s.pause_until - max(old_pu, t),
                                         t)
                        continue
                    delay = o.delay_s if o is not None else 0.0
                    old_pu = s.pause_until
                    s.pause_until = max(s.pause_until,
                                        t + self.reconfig_cost + delay)
                    if fr is not None:
                        fr.decision("checkpoint", t, job=s.job.name,
                                    cause="reconfig")
                        fr.pause(s.job.name, "reconfig",
                                 s.pause_until - max(old_pu, t), t)
                elif s.needs_restore:
                    # killed by a capacity loss, restarted this pass: the
                    # restart reloads the checkpoint before training
                    s.needs_restore = False
                    o = self._flaky_op("restore", s, t)
                    if o is not None and not o.ok:
                        # restore exhausted: back to the queue
                        s.status = "queued"
                        s.placement = {}
                        s.plan = None
                        s.alloc = None
                        s.needs_restore = True
                        s.pause_until = 0.0
                        continue
                    delay = o.delay_s if o is not None else 0.0
                    old_pu = s.pause_until
                    s.pause_until = max(
                        s.pause_until,
                        t + self._restore_cost(s.job.profile) + delay)
                    if fr is not None:
                        fr.pause(s.job.name, "restore",
                                 s.pause_until - max(old_pu, t), t)

            # compute throughputs (paused jobs contribute 0 until resumed)
            thpts = {}
            for s in active:
                if s.status != "running":
                    # an admitted guaranteed job evicted by a capacity
                    # loss runs at zero throughput until re-admitted —
                    # that counts against its guarantee
                    if (s.status == "queued" and s.start_time is not None
                            and s.job.guaranteed and s.baseline_perf > 0.0):
                        violations += 1
                    continue
                if s.pause_until > t:
                    # lint: unscoped-id — run-local map; keys pinned by
                    # ``states`` for the whole run
                    thpts[id(s)] = 0.0
                    continue
                thpts[id(s)] = self._true_throughput(s, t)
                # performance-guarantee accounting (paper Sec 5.1):
                # reconfiguration pauses are excluded (they are governed
                # by the reconfig-penalty threshold instead)
                if (s.job.guaranteed and s.baseline_perf > 0.0
                        and thpts[id(s)]
                        < s.baseline_perf * (1.0 - GUARANTEE_TOL)):
                    violations += 1

            if fr is not None:
                self._sample_metrics(fr, t, active, violations, thpts)

            # periodic telemetry + drift-triggered refits (the refit takes
            # effect at the NEXT pass — this loop rebuilds scheduler state
            # from the live job states every step anyway)
            if tick and t + 1e-9 >= next_tel:
                for s in active:
                    if s.status == "running" and s.pause_until <= t:
                        self._observe(s, thpts.get(id(s), 0.0), t)
                if self.health is not None:
                    # detect → quarantine → migrate BEFORE cal.poll at
                    # the same tick: the refreshed exclusion mask keeps
                    # degraded-node evidence out of drift windows
                    rep, affected = self._poll_health(active, t)
                    n_quar += len(rep.quarantine)
                    n_migrate += len(affected)
                if cal is not None:
                    for refit in cal.poll(t):
                        self._apply_refit(refit, states,
                                          {id(s) for s in active})
                        n_refits += 1
                while next_tel <= t + 1e-9:
                    next_tel += self.telemetry_interval

            # time to next event
            dt = next_arrival() - t
            if tick:
                dt = min(dt, next_tel - t)     # land on telemetry ticks
            if ci < len(cap):
                dt = min(dt, cap[ci].time - t)  # land on capacity events
            if di < len(deg):
                dt = min(dt, deg[di].time - t)  # land on degradation edges
            for s in active:
                if s.status != "running":
                    continue
                pu = s.pause_until
                if pu > t:
                    dt = min(dt, pu - t)
                    continue
                th = thpts[id(s)]
                if th <= 0:
                    continue
                remain_iters = s.job.target_iters - s.progress
                remain_s = remain_iters * s.job.profile.b / th
                dt = min(dt, remain_s)
            if not math.isfinite(dt):
                break
            dt = max(dt, 1.0)

            # advance: pauses expiring mid-window contribute the
            # post-resume fraction at the job's real throughput (bugfix:
            # the old loop zeroed the whole window when the sample instant
            # was paused), and run_time counts the full running-state
            # window including the paused part (it is the T of the
            # reconfig-penalty guard)
            san = self._san
            for s in active:
                if s.status != "running":
                    continue
                old = (s.run_time, s.progress)
                s.run_time += dt
                pu = s.pause_until
                eff = dt if pu <= t else t + dt - pu
                th = 0.0
                if eff > 0.0:
                    th = thpts[id(s)]
                    if pu > t:   # resumed mid-window: sample AT the resume
                        th = self._true_throughput(s, pu)
                    s.progress += th * eff / s.job.profile.b
                if san is not None:
                    san.check_window(s, old, t, t + dt, pu, th)
                if eff > 0.0 and s.progress >= s.job.target_iters - 1e-6:
                    s.status = "done"
                    s.finish_time = t + dt
                    s.placement = {}
                    if fr is not None:
                        fr.decision("complete", t + dt, job=s.job.name,
                                    data={"jct": s.finish_time
                                          - s.job.submit,
                                          "n_reconfig": s.n_reconfig})
            t += dt

        self.last_states = states          # inspectable by tests/benchmarks
        return self._assemble(active, t, violations, n_sched=n_sched,
                              n_refits=n_refits, n_cap=n_cap,
                              n_shrink=n_shrink, n_kill=n_kill,
                              n_deg=n_deg, n_quar=n_quar,
                              n_migrate=n_migrate)

    # ------------------------------------------------------------------
    def _assemble(self, arrived: list[JobState], t: float, violations: int,
                  n_events: int = 0, n_sched: int = 0,
                  n_refits: int = 0, n_cap: int = 0, n_shrink: int = 0,
                  n_kill: int = 0, n_deg: int = 0, n_quar: int = 0,
                  n_migrate: int = 0) -> SimResult:
        jcts = {}
        by_class: dict[str, list[float]] = {"guaranteed": [],
                                            "best_effort": []}
        n_rcfg = 0
        for s in arrived:
            if s.finish_time is None:
                s.finish_time = t                    # censored
            jcts[s.job.name] = s.finish_time - s.job.submit
            cls = "guaranteed" if s.job.guaranteed else "best_effort"
            by_class[cls].append(jcts[s.job.name])
            n_rcfg += s.n_reconfig
        makespan = max((s.finish_time for s in arrived), default=0.0)
        keys = {fit_key(s.job.profile) for s in arrived}
        res = SimResult(getattr(self.scheduler, "name", "?"), jcts,
                        makespan, n_rcfg, violations, by_class,
                        n_events=n_events, n_sched_calls=n_sched,
                        unfitted=sorted({k[0] for k in
                                         self._unfitted & keys}),
                        n_refits=n_refits, n_cap_events=n_cap,
                        n_shrink_recover=n_shrink, n_kill_requeue=n_kill,
                        n_degrade_events=n_deg, n_quarantined=n_quar,
                        n_migrate=n_migrate)
        if self.flaky is not None:
            res.n_op_retries = self.flaky.n_retries
            res.n_op_rollbacks = self.flaky.n_rollbacks
        fr = self.recorder
        if fr is not None:
            # downtime surfaced on the result is DERIVED from the
            # recorder's pause events — one source of truth
            res.telemetry = fr
            res.total_paused_s = fr.total_paused_s
            res.restore_paused_s = fr.pause_s.get("restore", 0.0)
            res.downtime_by_job = fr.downtime_by_job()
        return res
