"""The Rubick scheduler — Algorithm 1 (paper Sec 5.2).

A copy of ``repro.core.scheduler`` for the port (both pass engines, both
curve engines, ``recover`` and the reconfiguration gate), held job for
job to the reference's decisions by ``tests/test_torch_sched.py``, and
driven over time by ``core/simulator.py`` (``tests/test_torch_sim.py``),
which threads in the flight recorder (``recorder``) and the health
monitor's quarantine (``set_quarantine``).  With sanitizing on, every
pass is cross-checked by ``analysis/sanitizer.py``.

Goals (Sec 5.1):
  1. Performance guarantee: every guaranteed job performs at least as well
     as it would with its REQUESTED resources and ORIGINAL plan (possibly
     using fewer resources via a better plan — minRes).
  2. Maximize cluster throughput: prefer jobs with the highest resource
     sensitivity slopes; shrink the least-sensitive jobs above their minRes
     to feed more sensitive ones.

Reconfiguration penalty (Sec 5.2): a job is reconfigured only while
(T − N·δ)/T stays above RECONFIG_THRESHOLD.

Two pass engines share Algorithm 1's semantics (mirroring the
batch ≡ scalar curve engines and the event ≡ discrete simulators):

  * ``pass_engine="incremental"`` (default) keeps index structures alive
    across scheduling passes in a per-cluster ``_PassCtx``: the per-node
    usage map and resident index, a slope-indexed job order repaired from
    dirty marks instead of re-sorted, per-node victim indices sorted by
    ``slope_gpu_down`` with version-based invalidation, a per-tenant
    quota ledger, and cross-pass failed-walk memos that are only cleared
    when cluster state actually changes (a commit, a surviving shrink, or
    a completion).  The event-driven simulator feeds it dirty sets
    (``cluster.SchedEvents``) saying exactly which jobs arrived/completed
    so a pass touches O(changed) state instead of O(jobs·nodes·ΔGPU).
  * ``pass_engine="full"`` is the original full-pass reference: rebuild
    per-node usage from every running job, re-sort every job by freshly
    computed slopes, rescan residents per ΔGPU of shrink.  Parity is
    pinned by tests/test_incremental_sched.py on seed, heterogeneous and
    quota traces.

Incremental-engine exactness contract: every persistent structure is
either (a) derived arithmetic over committed placements (``used``), (b) a
soft index whose stale entries are filtered at query time (``by_node``),
or (c) a lazily-repaired cache invalidated by explicit dirty marks /
version bumps at every mutation site (_commit, _shrink, _undo,
completion).  Failed walks are side-effect-free (shrinks are rolled
back), so a failed walk's outcome is a pure function of cluster state +
the job's signature — which is what makes the cross-pass failure memos
sound.
"""

from __future__ import annotations

import bisect
import math
import weakref
from dataclasses import dataclass
from time import perf_counter

from repro_torch.analysis import sanitize_enabled
from repro_torch.core import memory
from repro_torch.core.cluster import (Cluster, JobState, Placement, SchedEvents,
                                used_per_node)
from repro_torch.core.perfmodel import Alloc, Env, predict_throughput
from repro_torch.core.sensitivity import SensitivityCurve, get_curve
from repro_torch.parallel.plan import ExecutionPlan

RECONFIG_THRESHOLD = 0.97
DELTA_GPU = 1
CPUS_PER_GPU = 12


@dataclass
class SchedulerConfig:
    cpus_per_gpu: int = CPUS_PER_GPU
    max_ga: int = 8
    reconfig_cost_s: float = 78.0        # paper Sec 7.3: avg 78 s
    reconfig_threshold: float = RECONFIG_THRESHOLD
    starvation_s: float = 1800.0         # best-effort anti-starvation [12]
    # ablation switches (Rubick-E / -R / -N variants, Sec 7.3)
    reconfigure_plans: bool = True
    reallocate_resources: bool = True
    # capacity-loss recovery policy (failure & elasticity engine):
    # "shrink" re-plans the victim over its surviving resources via
    # best_plan_at_most and only kills when nothing feasible survives;
    # "kill" is the classic checkpoint-restart baseline (always requeue)
    recovery: str = "shrink"
    # plan-evaluation engine: "batch" (vectorized) or "scalar" (reference)
    curve_engine: str = "batch"
    # scheduling-pass engine: "incremental" (index-driven, default) or
    # "full" (the original full-pass reference)
    pass_engine: str = "incremental"
    # runtime cross-checking of the incremental indexes against recomputed
    # ground truth (repro_torch.analysis.sanitizer); also enabled by the
    # REPRO_SANITIZE environment variable
    sanitize: bool = False


def _walk_sig(js: JobState) -> tuple:
    """A queued job's walk signature: two queued jobs with the same
    signature walk identically under identical cluster state (the walk
    reads nothing else of the job).  Shared by the full engine's
    per-pass dedup and the incremental engine's cross-pass parking —
    the two memo schemes must key on exactly the same fields."""
    return (id(js.job.profile), id(js.fitted), js.job.gpu_type,
            js.min_res, js.job.req_gpus, js.job.tenant)


class _PassCtx:
    """Pass-persistent index state for one cluster (incremental engine).

    Tie-breaks use ``seq`` — the order a job was first seen, which equals
    the active-list (arrival) order the full engine's stable sorts and
    first-strict-minimum scans break ties by."""

    def __init__(self, cluster: Cluster):
        # (no Cluster reference is kept: _scope_memos owns the binding of
        # ctx lifetime to cluster identity via a weakref, and pinning the
        # cluster here would undo that)
        # per-node usage of all running jobs, kept live across passes
        self.used: dict[int, tuple[int, int, float]] = {}
        # soft per-node resident index (stale members filtered at query)
        self.by_node: dict[int, list[JobState]] = {}
        # cross-pass park/wake: a walk whose outcome is recorded (failure
        # or committed no-op) parks its job/signature; bumping any node,
        # group or quota it read wakes it.  Parked entries are skipped by
        # one set lookup in the pass loop.
        self.parked_running: set[int] = set()      # id(js)
        self.parked_sigs: set[tuple] = set()       # queued-job signatures
        # signature pin store: parked signatures embed id(profile) and
        # id(fitted); the referents must stay alive while the signature
        # is remembered, or a recycled address could alias a different
        # model's walk outcome onto a fresh job (the history-pinning bug,
        # generalized — also what makes the wake tokens safe to hold)
        self.parked_pins: dict[tuple, tuple] = {}  # sig -> (profile, fitted)
        self.gate_wake: dict[int, float] = {}      # id(js) -> sim time
        # token sets (not lists): re-parking after a partial wake
        # re-subscribes the same token, and sets keep that idempotent
        self.wake_node: dict[int, set] = {}        # nid -> {token}
        self.wake_group: dict[str, set] = {}       # gpu model -> {token}
        self.wake_quota: dict[str, set] = {}       # tenant -> {token}
        self.sig_cache: dict[int, tuple] = {}      # id(js) -> signature
        # stable order bookkeeping
        self.seq: dict[int, int] = {}
        self.members: dict[int, JobState] = {}
        self._next_seq = 0
        # slope-indexed order: ascending (-slope_gpu, -slope_cpu, seq)
        self.order: list[tuple] = []
        self.order_js: dict[int, JobState] = {}    # seq -> job
        self.order_key: dict[int, tuple] = {}      # id(js) -> entry
        self.dirty: set[int] = set()
        # versioned invalidation: any mutation of a node bumps its
        # version (lazily rebuilt victim index) and wakes parked walks
        # subscribed to the node or its GPU-type group
        self.node_ver: dict[int, int] = {}
        self.node_group: dict[int, str] = {n.id: n.gpu_model
                                           for n in cluster.nodes}
        self.victim_cache: dict[int, tuple] = {}
        # per-pass tenant quota ledger (None when scheduler has no quotas)
        self.quota_live: dict[str, int] | None = None
        self.quota_reserved: dict[str, int] | None = None
        # read-set of the walk in flight: node ids the walk visited
        self.cur_read: list[int] = []
        self._prune_tick = 0
        # flight recorder (repro.obs) + the pass's sim time, set by
        # schedule() each pass BEFORE any event application so wake
        # emissions carry the right clock; None/0.0 = tracing off
        self.rec = None
        self.now = 0.0

    # -- membership ----------------------------------------------------
    def register(self, js: JobState) -> None:
        jid = id(js)
        if jid in self.members:
            return
        seq = self._next_seq
        self._next_seq += 1
        self.members[jid] = js
        self.seq[jid] = seq
        self.order_js[seq] = js
        self.dirty.add(jid)

    def build(self, active: list[JobState]) -> None:
        running = [j for j in active if j.status == "running"]
        self.used = used_per_node(running)
        self.by_node = {}
        for j in running:
            for nid in j.placement:
                self.by_node.setdefault(nid, []).append(j)
        for js in active:
            self.register(js)

    def remove(self, js: JobState, freed: Placement, sched) -> None:
        """A job left the cluster (completion): release its capacity and
        drop it from every index.  ``freed`` is the placement it held
        when it finished (the engine clears ``js.placement`` itself)."""
        jid = id(js)
        for nid, (g, c, m) in freed.items():
            u = self.used.get(nid)
            if u is not None:
                self.used[nid] = (u[0] - g, u[1] - c, u[2] - m)
            res = self.by_node.get(nid)
            if res is not None:
                try:
                    res.remove(js)
                except ValueError:
                    pass
            self.bump_node(nid)
        if js.job.guaranteed and sched.quotas.get(js.job.tenant) is not None:
            self.bump_quota(js.job.tenant)
        seq = self.seq.pop(jid, None)
        if seq is not None:
            self.order_js.pop(seq, None)
        self.members.pop(jid, None)
        self.dirty.discard(jid)
        self.parked_running.discard(jid)
        self.gate_wake.pop(jid, None)
        self.sig_cache.pop(jid, None)
        old = self.order_key.pop(jid, None)
        if old is not None:
            i = bisect.bisect_left(self.order, old)
            if i < len(self.order) and self.order[i] == old:
                del self.order[i]

    def apply_events(self, events: SchedEvents, sched) -> None:
        for js, freed in events.completed:
            self.remove(js, freed, sched)
        if events.node_down or events.node_up or events.evicted \
                or events.quarantined or events.released \
                or events.migrated or events.rolled_back:
            self.apply_capacity(events, sched)
        if sched.quotas:
            for js in events.arrived:
                # a new same-tenant reservation changes quota room, which
                # can flip a memoized walk outcome
                if js.job.guaranteed \
                        and sched.quotas.get(js.job.tenant) is not None:
                    self.bump_quota(js.job.tenant)
        if events.refit:
            self.apply_refits(events.refit, sched)

    def apply_refits(self, refits, sched) -> None:
        """A calibration refit replaced a model type's fitted params:
        every persistent index derived from the retired curve family goes
        stale at once.  Re-key the job (walk signatures embed
        ``id(fitted)``), mark it dirty so the slope order re-sorts it
        under the new curve, un-park its recorded walk outcomes (they
        were computed against the old envelope), bump every node it
        resides on (victim indices hold its old ``slope_gpu_down``; the
        bump also wakes other walks that read those nodes), and bump its
        tenant's quota subscribers (a refit moves minRes, which moves
        reservations).  The time-based reconfiguration gate is fitted-
        independent, so ``gate_wake`` survives."""
        stale = {id(old) for _, old in refits}
        for js, _old in refits:
            jid = id(js)
            if jid not in self.members:
                continue           # arrived this very batch: registration
                                   # indexes it under the new params
            self.sig_cache.pop(jid, None)
            self.dirty.add(jid)
            self.parked_running.discard(jid)
            self.bump_nodes(set(js.placement))
            if js.job.guaranteed \
                    and sched.quotas.get(js.job.tenant) is not None:
                self.bump_quota(js.job.tenant)
        # parked queued-walk signatures embed the retired params' id —
        # every job of the refit model type must walk again
        self.parked_sigs = {s for s in self.parked_sigs
                            if s[1] not in stale}
        self.parked_pins = {s: pin for s, pin in self.parked_pins.items()
                            if s in self.parked_sigs}

    def apply_capacity(self, events: SchedEvents, sched) -> None:
        """Capacity changed between passes (node failure / recovery, spot
        arrive / revoke): fold every victim's lost share out of the usage
        map, drop it from the resident index of nodes it no longer
        occupies, and version-bump every touched node — which both
        invalidates its victim cache and wakes parked walks subscribed to
        the node or its GPU-type group.  The quota ledger is rebuilt each
        pass from live placements (build_ledger), so eviction needs no
        cross-pass ledger repair beyond waking quota subscribers."""
        for nid in events.node_down:
            self.bump_node(nid)
        for nid in events.node_up:
            self.bump_node(nid)
        # quarantine flips change walk feasibility exactly like capacity
        # flips: bump so parked walks subscribed to the node re-run
        for nid in events.quarantined:
            self.bump_node(nid)
        for nid in events.released:
            self.bump_node(nid)
        # migrate-away and retry-rollback victims changed placement
        # outside a pass — same delta folding as capacity eviction
        for js, before in (events.evicted + events.migrated
                           + events.rolled_back):
            jid = id(js)
            if jid not in self.members:
                continue
            after = js.placement
            for nid in sorted(set(before) | set(after)):
                b = before.get(nid, (0, 0, 0.0))
                a = after.get(nid, (0, 0, 0.0))
                if b != a:
                    u = self.used.get(nid, (0, 0, 0.0))
                    self.used[nid] = (u[0] - b[0] + a[0], u[1] - b[1] + a[1],
                                      u[2] - b[2] + a[2])
                if a[0] <= 0:
                    res = self.by_node.get(nid)
                    if res is not None:
                        try:
                            res.remove(js)
                        except ValueError:
                            pass
                self.bump_node(nid)
            # the victim's slope/assignment changed: re-sort it, forget
            # its parked walk outcome, let the reconfig gate re-evaluate
            self.dirty.add(jid)
            self.parked_running.discard(jid)
            self.gate_wake.pop(jid, None)
            if js.job.guaranteed \
                    and sched.quotas.get(js.job.tenant) is not None:
                self.bump_quota(js.job.tenant)

    def prune(self, cluster: Cluster) -> None:
        """Compact soft resident lists that accumulated stale entries
        (preempted / migrated jobs).  Only run between passes — a walk's
        rollback relies on shrunk-to-zero victims staying listed.  Purely
        a memory/scan-length bound (stale entries are filtered at query
        time), so it runs on a coarse tick, and dropping invalid entries
        never changes a victim query's result — no wake needed."""
        self._prune_tick += 1
        if self._prune_tick % 32:
            return
        for nid, res in self.by_node.items():
            if len(res) > cluster.nodes[nid].gpus:
                res[:] = [j for j in res if j.status == "running"
                          and j.placement.get(nid, (0, 0, 0.0))[0] > 0]
                self.victim_cache.pop(nid, None)

    # -- state-change notifications ------------------------------------
    def mark_dirty(self, js: JobState) -> None:
        jid = id(js)
        if jid in self.members:
            self.dirty.add(jid)

    def bump_node(self, nid: int) -> None:
        self.node_ver[nid] = self.node_ver.get(nid, 0) + 1
        toks = self.wake_node.pop(nid, None)
        if toks:
            self._wake(toks)
            if self.rec is not None:
                # aggregate wake (token count, never token identities —
                # ids are not stable across runs)
                self.rec.decision("wake", self.now, cause="node",
                                  data={"node": nid, "n": len(toks)})
        toks = self.wake_group.pop(self.node_group.get(nid, ""), None)
        if toks:
            self._wake(toks)
            if self.rec is not None:
                self.rec.decision("wake", self.now, cause="group",
                                  data={"node": nid, "n": len(toks)})

    def bump_nodes(self, nids) -> None:
        for nid in nids:
            self.bump_node(nid)

    def bump_quota(self, tenant: str) -> None:
        toks = self.wake_quota.pop(tenant, None)
        if toks:
            self._wake(toks)
            if self.rec is not None:
                self.rec.decision("wake", self.now, cause="quota",
                                  data={"tenant": tenant, "n": len(toks)})

    def sig_for(self, js: JobState) -> tuple:
        jid = id(js)
        s = self.sig_cache.get(jid)
        if s is None:
            s = self.sig_cache[jid] = _walk_sig(js)
        return s

    def _quota_token(self, js: JobState, sched, token) -> None:
        """Guaranteed jobs of quota'd tenants also observe quota state
        (via _quota_room): subscribe the parked walk to quota changes."""
        if js.job.guaranteed \
                and sched.quotas.get(js.job.tenant) is not None:
            self.wake_quota.setdefault(js.job.tenant, set()).add(token)

    def park_failed(self, js: JobState, sched, cluster: Cluster,
                    sig: tuple | None) -> None:
        """Record a FAILED walk (post-rollback, so cluster state equals
        what the walk read): a failed walk visits every node of every
        group the job may use, so it must be re-run only when some node
        in one of those groups (or the tenant's quota state) changes."""
        if js.status != "queued":
            token = ("r", id(js))
            self.parked_running.add(id(js))
        elif sig is not None:
            token = ("s", sig)
            self.parked_sigs.add(sig)
            self.parked_pins[sig] = (js.job.profile, js.fitted)
        else:
            return

        for nodes, _ in sched._group_order(js, cluster):
            self.wake_group.setdefault(nodes[0].gpu_model,
                                       set()).add(token)
        self._quota_token(js, sched, token)

    def park_noop(self, js: JobState, sched) -> None:
        """Record a committed NO-OP walk: it re-derived the job's
        existing assignment reading only the nodes it actually visited
        (``cur_read`` — nodes beyond its break point cannot influence
        it).  The job's own placement nodes are included so being shrunk
        by a later walk wakes it."""
        jid = id(js)
        token = ("r", jid)
        self.parked_running.add(jid)
        wn = self.wake_node
        for nid in self.cur_read:
            wn.setdefault(nid, set()).add(token)
        for nid in js.placement:
            wn.setdefault(nid, set()).add(token)
        self._quota_token(js, sched, token)

    def park_gate(self, js: JobState, sched, now: float) -> None:
        """A running job whose reconfiguration gate is closed cannot do
        anything; the gate opens at a deterministic run_time threshold
        (run_time advances 1:1 with sim time while running), so skip it
        until just before then.  The margin keeps the skip strictly
        inside the gate-closed region — the exact formula is re-evaluated
        once woken — so float rounding can never flip a decision."""
        frac = 1.0 - sched.cfg.reconfig_threshold
        if frac <= 0.0:
            self.gate_wake[id(js)] = math.inf
            return
        need = (js.n_reconfig + 1) * sched.cfg.reconfig_cost_s / frac
        wake = now + need * (1.0 - 1e-6) - max(js.run_time, 1.0)
        if wake > now:
            self.gate_wake[id(js)] = wake

    def _wake(self, tokens) -> None:
        for kind, key in tokens:
            if kind == "r":
                self.parked_running.discard(key)
            else:
                self.parked_sigs.discard(key)
                self.parked_pins.pop(key, None)

    # -- slope-indexed job order ---------------------------------------
    def refresh_order(self, sched, cluster: Cluster) -> None:
        if not self.dirty:
            return
        if 8 * len(self.dirty) >= len(self.members):
            entries = []
            self.order_key = {}
            # lint: nondeterminism — entries are sorted below; visit
            # order of the full rebuild cannot affect the result
            for jid, js in self.members.items():
                key = self._order_entry(js, sched, cluster)
                self.order_key[jid] = key
                entries.append(key)
            entries.sort()
            self.order = entries
        else:
            # lint: nondeterminism — each dirty key is removed/insorted
            # into a sorted list independently; repair order commutes
            for jid in self.dirty:
                old = self.order_key.get(jid)
                if old is not None:
                    i = bisect.bisect_left(self.order, old)
                    if i < len(self.order) and self.order[i] == old:
                        del self.order[i]
                js = self.members.get(jid)
                if js is None:
                    self.order_key.pop(jid, None)
                    continue
                key = self._order_entry(js, sched, cluster)
                self.order_key[jid] = key
                bisect.insort(self.order, key)
        self.dirty.clear()

    def _order_entry(self, js: JobState, sched, cluster: Cluster) -> tuple:
        sg, sc = sched._sort_slopes(js, cluster)
        return (-sg, -sc, self.seq[id(js)])

    # -- per-node victim index -----------------------------------------
    def victims(self, nid: int, env, sched, cluster: Cluster) -> list:
        """Residents of one node shrinkable below nothing (over minRes),
        as (slope_gpu_down, seq, job) sorted ascending.  Exact at the
        node's current version; any resident mutation bumps the version."""
        ver = self.node_ver.get(nid, 0)
        hit = self.victim_cache.get(nid)
        if hit is not None and hit[0] == ver and hit[1] is env:
            return hit[2]
        entries = []
        for j in self.by_node.get(nid, ()):
            if j.status != "running":
                continue
            p = j.placement.get(nid)
            if p is None or p[0] <= 0:
                continue
            tg = j.total_gpus
            min_g = j.min_res[0] if j.min_res else j.job.req_gpus
            if tg <= max(min_g, 0):
                continue
            slope = sched.curve(j, cluster, env).slope_gpu_down(tg)
            entries.append((slope, self.seq.get(id(j), 0), j))
        # tuple sort: the (slope, seq) prefix is unique (seq is), so the
        # job object is never compared
        entries.sort()
        self.victim_cache[nid] = (ver, env, entries)
        return entries

    def pick_victim(self, nid: int, env, sched, cluster: Cluster,
                    exclude: JobState) -> tuple[JobState | None, float]:
        for slope, _, j in self.victims(nid, env, sched, cluster):
            if j is not exclude:
                return j, slope
        return None, math.inf

    def has_victim(self, nid: int, env, sched, cluster: Cluster,
                   exclude: JobState) -> bool:
        for e in self.victims(nid, env, sched, cluster):
            if e[2] is not exclude:
                return True
        return False

    # -- per-tenant quota ledger ---------------------------------------
    def build_ledger(self, active: list[JobState], quotas: dict) -> None:
        if not quotas:
            self.quota_live = self.quota_reserved = None
            return
        live: dict[str, int] = {}
        reserved: dict[str, int] = {}
        for j in active:
            if not j.job.guaranteed:
                continue
            t = j.job.tenant
            if j.status == "running":
                live[t] = live.get(t, 0) + j.total_gpus
            elif j.status == "queued":
                need = j.min_res[0] if j.min_res else j.job.req_gpus
                reserved[t] = reserved.get(t, 0) + need
        self.quota_live, self.quota_reserved = live, reserved

    def ledger_add_live(self, tenant: str, delta: int) -> None:
        if self.quota_live is not None and delta:
            self.quota_live[tenant] = self.quota_live.get(tenant, 0) + delta
            self.bump_quota(tenant)

    def ledger_add_reserved(self, tenant: str, delta: int) -> None:
        if self.quota_reserved is not None and delta:
            self.quota_reserved[tenant] = \
                self.quota_reserved.get(tenant, 0) + delta
            self.bump_quota(tenant)


class RubickScheduler:
    name = "rubick"
    # the event-driven simulator passes SchedEvents dirty sets to
    # schedulers advertising this flag
    accepts_events = True

    def __init__(self, env: Env | None = None,
                 cfg: SchedulerConfig | None = None,
                 quotas: dict[str, int] | None = None):
        self.env = env or Env()
        self.cfg = cfg or SchedulerConfig()
        self.quotas = quotas or {}
        # identity-keyed hot caches: profiles / fitted params / envs are
        # interned (paper_models.TABLE2, the simulator's fit_cache, the
        # cluster's env dict), so id()-tuples avoid re-hashing dataclasses
        # on every curve lookup in the inner scheduling loops.  Both memos
        # (and the incremental pass context) are scoped to ONE cluster at
        # a time via a weak reference — see _scope_memos — so sweeps over
        # many simulations neither pin dead Cluster objects nor grow
        # memos without bound.
        self._curve_memo: dict[tuple, SensitivityCurve] = {}
        self._order_memo: dict[tuple, list] = {}
        self._memo_cluster: weakref.ref | None = None
        self._ctx: _PassCtx | None = None
        # gray-failure state (health monitor drives both): quarantined
        # nodes are skipped by every placement walk; node_health carries
        # the monitor's live scores for observability/sanitizer checks
        self.quarantined: set[int] = set()
        self.node_health: dict[int, float] = {}
        # flight recorder (repro_torch.obs.FlightRecorder); the simulator
        # attaches its own when tracing is on.  None = every emit site
        # collapses to one false branch
        self.recorder = None
        self._san = None
        if sanitize_enabled(self.cfg):
            # deferred import: the sanitizer recomputes ground truth with
            # this module's own helpers (import cycle otherwise)
            from repro_torch.analysis.sanitizer import SchedSanitizer
            self._san = SchedSanitizer()

    # ------------------------------------------------------------------
    def _scope_memos(self, cluster: Cluster) -> None:
        """Bind the identity-keyed memos (and the incremental pass
        context) to the cluster being scheduled.  Switching clusters
        clears them: entries keyed by a dead cluster's recycled id() can
        never be served, and a scheduler reused across a sweep of
        simulations no longer accumulates (or pins) per-cluster state."""
        prev = self._memo_cluster() if self._memo_cluster is not None \
            else None
        if prev is not cluster:
            self._curve_memo.clear()
            self._order_memo.clear()
            self._ctx = None
            self._memo_cluster = weakref.ref(cluster)

    def reset_indices(self) -> None:
        """Drop all persistent pass state (tests / external mutation)."""
        self._ctx = None
        self._curve_memo.clear()
        self._order_memo.clear()
        self._memo_cluster = None

    def set_quarantine(self, add=(), release=(),
                       scores: dict[int, float] | None = None) -> None:
        """Apply the health monitor's quarantine decisions.  The
        corresponding SchedEvents (``quarantined`` / ``released``) must
        carry the same node ids so the incremental pass context bumps
        them — callers that bypass events must reset_indices()."""
        for nid in add:
            self.quarantined.add(nid)
        for nid in release:
            self.quarantined.discard(nid)
        if scores is not None:
            self.node_health = dict(scores)

    def note_external_move(self, js: JobState, before: Placement) -> None:
        """Fold one out-of-band placement change (e.g. a reconfig
        rollback after retry exhaustion) into the persistent pass
        context IMMEDIATELY.  Deferring the delta to the next pass's
        SchedEvents would double-fold ``ctx.used`` if a capacity
        eviction hits the same job in between — the eviction folds from
        ``before`` while the context still holds the rolled-back
        placement.  No-op without a live context (full engine, or first
        pass not run yet)."""
        if self._ctx is not None:
            self._ctx.apply_capacity(
                SchedEvents(rolled_back=[(js, before)]), self)

    def _purge_refit_memos(self, refits) -> None:
        """Drop memo entries keyed by a retired FitParams identity.  The
        calibration manager pins retired params (its history), but the
        entries can never be served again through fresh keys — and if a
        caller ever dropped the old object, its recycled id() must not
        alias a brand-new params object into a stale curve."""
        stale = {id(old) for _, old in refits}
        for memo in (self._curve_memo, self._order_memo):
            for k in [k for k in memo if k is not None and k[1] in stale]:
                del memo[k]

    # ------------------------------------------------------------------
    def curve(self, js: JobState, cluster: Cluster,
              env: Env | None = None) -> SensitivityCurve:
        """Shared process-wide curve (see sensitivity.CurveCache): jobs of
        the same model type + fitted params reuse one materialized
        envelope across scheduler instances and the simulator.  ``env``
        selects the per-GPU-type curve on heterogeneous clusters."""
        env = env or self.env
        key = (id(js.job.profile), id(js.fitted), id(env),
               cluster.total_gpus)
        c = self._curve_memo.get(key)
        if c is None:
            c = self._curve_memo[key] = get_curve(
                js.job.profile, js.fitted, env,
                max_gpus=cluster.total_gpus,
                cpus_per_gpu=self.cfg.cpus_per_gpu,
                max_ga=self.cfg.max_ga,
                engine=self.cfg.curve_engine)
        return c

    def _placed_env(self, js: JobState, cluster: Cluster) -> Env:
        """The Env of the GPU type a job is currently placed on (single
        type by construction); the scheduler default when unplaced."""
        if cluster.is_hetero and js.placement:
            nid = next(iter(js.placement))
            return cluster.env_for(nid, self.env) or self.env
        return self.env

    def _ensure_min_res(self, js: JobState, cluster: Cluster) -> None:
        if js.min_res is not None:
            return
        # a job pinned to a GPU type gets its baseline (and hence minRes)
        # under THAT type's Env — an A800 baseline is unreachable on a
        # V100 pool and would count phantom guarantee violations
        env = cluster.envs.get(js.job.gpu_type, self.env) \
            if js.job.gpu_type else self.env
        curve = self.curve(js, cluster, env)
        # baseline + minRes are memoized on the (process-wide) curve:
        # jobs sharing (profile, fitted, env, request) pay once, not each
        base = curve.baseline_throughput(js.job.orig_plan, js.job.req_gpus,
                                         js.job.req_cpus)
        if not math.isfinite(base):
            base = 0.0
        js.baseline_perf = base
        if not js.job.guaranteed:
            js.min_res = (0, 0)          # best-effort: minRes = 0 (Sec 5.2)
        elif self.cfg.reconfigure_plans and self.cfg.reallocate_resources:
            js.min_res = curve.min_res_for(js.job.req_gpus, js.job.req_cpus,
                                           base)
        else:
            js.min_res = (js.job.req_gpus, js.job.req_cpus)

    # ------------------------------------------------------------------
    # Algorithm 1
    # ------------------------------------------------------------------
    def schedule(self, jobs: list[JobState], cluster: Cluster,
                 now: float = 0.0, events: SchedEvents | None = None) -> None:
        """Mutates job states: placement / alloc / plan / status.

        ``events`` (optional) is the dirty set since the previous pass;
        the incremental engine uses it to keep its indices instead of
        rebuilding, the full engine ignores it — except refits, whose
        identity-keyed memo entries BOTH engines must purge."""
        self._scope_memos(cluster)
        rec = self.recorder
        t_pass = perf_counter() if rec is not None else 0.0
        if events is not None and events.refit:
            self._purge_refit_memos(events.refit)
        active = [j for j in jobs if j.status != "done"]
        if self._san is not None:
            self._san.begin_pass(active, cluster)
        ctx: _PassCtx | None = None
        if self.cfg.pass_engine == "incremental":
            ctx = self._ctx
            if ctx is None or events is None:
                # unknown delta (direct call / discrete loop / first
                # pass): rebuild every index from the live job states
                t0 = perf_counter() if rec is not None else 0.0
                ctx = self._rebuild_ctx(active, cluster)
                if rec is not None:
                    # lint: nondeterminism — wall-clock profiler span;
                    # timing only, never a decision input
                    rec.span_since("rebuild", t0, now)
            else:
                ctx.rec, ctx.now = rec, now
                t0 = perf_counter() if rec is not None else 0.0
                ctx.apply_events(events, self)
                if rec is not None:
                    # lint: nondeterminism — wall-clock profiler span
                    rec.span_since("apply-events", t0, now)
                if self._members_consistent(ctx, active, events):
                    # only the arrivals are new: O(changed) bookkeeping
                    for js in events.arrived:
                        self._ensure_min_res(js, cluster)
                        ctx.register(js)
                    # refit jobs had min_res/baseline reset by the refit
                    # application; recompute under the new curve (the
                    # full engine's every-job ensure loop does the same)
                    for js, _old in events.refit:
                        self._ensure_min_res(js, cluster)
                    ctx.prune(cluster)
                else:
                    # job list changed outside the event stream (direct
                    # caller mutation): the persistent indices can no
                    # longer be trusted — rebuild from the live states
                    t0 = perf_counter() if rec is not None else 0.0
                    ctx = self._rebuild_ctx(active, cluster)
                    if rec is not None:
                        # lint: nondeterminism — wall-clock profiler span
                        rec.span_since("rebuild", t0, now)
            ctx.rec, ctx.now = rec, now
            ctx.build_ledger(active, self.quotas)
            used, by_node = ctx.used, ctx.by_node
        else:
            for js in active:
                self._ensure_min_res(js, cluster)
            # pass-wide incremental state: per-node usage of every RUNNING
            # job and a per-node resident index (soft — stale members are
            # filtered by the slope scans)
            running = [j for j in active if j.status == "running"]
            used = used_per_node(running)
            by_node = {}
            for j in running:
                for nid in j.placement:
                    by_node.setdefault(nid, []).append(j)
            # failed-walk dedup: a failed walk is side-effect-free (shrinks
            # are rolled back), so until some commit changes cluster state,
            # a queued job with the same (model type, fitted, gpu_type,
            # minRes, request) signature will fail identically — skip the
            # re-walk
            self._failed_sigs = set()
            # stable victim tie-break order (active == arrival order)
            self._victim_seq = {id(j): i for i, j in enumerate(active)}

        # --- lines 2-3: privileged queued guaranteed jobs within quota ----
        # Degraded running guaranteed jobs — shrunk below minRes by the
        # failure-recovery path — share this class: their guarantee is
        # violated right now, exactly like a capacity-evicted queued job
        # (which kill-and-requeue would put here), so regrowth must not
        # lose capacity races to later-submitted admissions.
        t0 = perf_counter() if rec is not None else 0.0
        queued_g = [j for j in active if j.status == "queued"
                    and j.job.guaranteed]
        for j in active:
            if j.status == "running" and j.job.guaranteed and j.min_res \
                    and j.total_gpus < j.min_res[0]:
                queued_g.append(j)
        queued_g.sort(key=lambda j: j.job.submit)
        for js in queued_g:
            if js.status == "running":
                # growth path enforces quota via the growth budget; the
                # parked-walk skip mirrors the slope-phase check below
                # (no gate_wake skip: degraded jobs bypass the gate)
                if ctx is not None and id(js) in ctx.parked_running:
                    continue
                self._schedule_job(js, active, cluster, now, used, by_node,
                                   ctx)
                continue
            sig = None
            if ctx is not None:
                sig = ctx.sig_for(js)
                if sig in ctx.parked_sigs:
                    continue
            if not self._quota_ok(js, jobs, ctx):
                continue
            self._schedule_job(js, active, cluster, now, used, by_node,
                               ctx, sig)
        if rec is not None:
            # lint: nondeterminism — wall-clock profiler span
            rec.span_since("admission", t0, now, n=len(queued_g))

        # --- lines 4-5: best-effort + running, by descending slope --------
        if self.cfg.reallocate_resources:
            if ctx is not None:
                t0 = perf_counter() if rec is not None else 0.0
                ctx.refresh_order(self, cluster)
                if rec is not None:
                    # lint: nondeterminism — wall-clock profiler span
                    rec.span_since("slope-order-repair", t0, now)
                # one fused traversal of the slope order materializes the
                # starved prefix + the rest (replacing three list
                # comprehensions); park/gate checks happen at each job's
                # TURN — a mid-pass commit can wake a parked signature,
                # exactly like the full engine's memo clear
                starvation_s = self.cfg.starvation_s
                parked_r = ctx.parked_running
                parked_s = ctx.parked_sigs
                gate_wake = ctx.gate_wake
                order_js = ctx.order_js
                starved: list[JobState] = []
                normal: list[JobState] = []
                for key in ctx.order:
                    js = order_js[key[2]]
                    st = js.status
                    if st == "running":
                        normal.append(js)
                    elif st == "queued" and not js.job.guaranteed:
                        if now - js.job.submit > starvation_s:
                            starved.append(js)
                        else:
                            normal.append(js)
                t0 = perf_counter() if rec is not None else 0.0
                for js in starved + normal:
                    if js.status == "running":
                        jid = id(js)
                        if jid in parked_r:
                            continue
                        w = gate_wake.get(jid)
                        if w is not None and now < w:
                            continue
                        self._schedule_job(js, active, cluster, now, used,
                                           by_node, ctx)
                    else:
                        sig = ctx.sig_for(js)
                        if sig in parked_s:
                            continue
                        self._schedule_job(js, active, cluster, now, used,
                                           by_node, ctx, sig)
                if rec is not None:
                    # lint: nondeterminism — wall-clock profiler span
                    rec.span_since("slope-walks", t0, now)
            else:
                rest = [j for j in active
                        if (j.status == "queued" and not j.job.guaranteed)
                        or j.status == "running"]
                rest.sort(key=lambda j: self._sort_slopes(j, cluster),
                          reverse=True)
                # anti-starvation: long-queued best-effort jobs first
                starved = [j for j in rest if j.status == "queued"
                           and now - j.job.submit > self.cfg.starvation_s]
                if starved:
                    starved_ids = {id(j) for j in starved}
                    rest = starved + [j for j in rest
                                      if id(j) not in starved_ids]
                t0 = perf_counter() if rec is not None else 0.0
                for js in rest:
                    self._schedule_job(js, active, cluster, now, used,
                                       by_node, ctx)
                if rec is not None:
                    # lint: nondeterminism — wall-clock profiler span
                    rec.span_since("slope-walks", t0, now)
        else:
            for js in active:
                if js.status == "queued" and not js.job.guaranteed:
                    sig = None
                    if ctx is not None:
                        sig = ctx.sig_for(js)
                        if sig in ctx.parked_sigs:
                            continue
                    self._schedule_job(js, active, cluster, now, used,
                                       by_node, ctx, sig)
        if self._san is not None:
            self._san.end_pass(active, cluster, ctx, self)
        if rec is not None:
            # lint: nondeterminism — wall-clock profiler span
            rec.span_since("pass", t_pass, now,
                           engine=self.cfg.pass_engine)

    def _rebuild_ctx(self, active: list[JobState],
                     cluster: Cluster) -> _PassCtx:
        ctx = self._ctx = _PassCtx(cluster)
        for js in active:
            self._ensure_min_res(js, cluster)
        ctx.build(active)
        return ctx

    @staticmethod
    def _members_consistent(ctx: _PassCtx, active: list[JobState],
                            events: SchedEvents) -> bool:
        """Can the persistent indices be trusted?  Cheap count checks
        catch the realistic contract violations (a job dropped without a
        completion event, an unannounced addition); the exact identity
        sweep runs whenever it is cheap (small active sets — every test)
        and on the coarse prune tick at scale, so even a pathological
        equal-count swap is caught within a bounded number of passes —
        a rebuild is decision-transparent, only ever late."""
        if len(ctx.members) != len(active) - len(events.arrived) \
                or any(id(js) in ctx.members for js in events.arrived):
            return False
        if len(active) <= 256 or ctx._prune_tick % 32 == 31:
            new_ids = {id(js) for js in events.arrived}
            members = ctx.members
            return all(id(js) in members or id(js) in new_ids
                       for js in active)
        return True

    def _sort_slopes(self, js: JobState, cluster: Cluster):
        c = self.curve(js, cluster, self._placed_env(js, cluster))
        g = js.total_gpus
        return (c.slope_gpu(g), c.slope_cpu(g or 1, js.total_cpus or 1))

    def _quota_ok(self, js: JobState, jobs: list[JobState],
                  ctx: _PassCtx | None = None) -> bool:
        quota = self.quotas.get(js.job.tenant)
        if quota is None:
            return True
        # live accounting (bugfix): grown allocations hold real GPUs far
        # beyond minRes, so charge tenants what their running guaranteed
        # jobs actually occupy, not the minRes floor
        if ctx is not None and ctx.quota_live is not None:
            used = ctx.quota_live.get(js.job.tenant, 0)
        else:
            used = sum(j.total_gpus
                       for j in jobs
                       if j.status == "running" and j.job.guaranteed
                       and j.job.tenant == js.job.tenant)
        need = js.min_res[0] if js.min_res else js.job.req_gpus
        return used + need <= quota

    def _quota_room(self, js: JobState, active: list[JobState],
                    ctx: _PassCtx | None = None) -> int | None:
        """GPUs this guaranteed job may hold without pushing its tenant
        over quota: quota − live usage of its other running guaranteed
        jobs − minRes reserved for its queued guaranteed jobs (so growth
        never starves same-tenant admissions)."""
        quota = self.quotas.get(js.job.tenant)
        if quota is None or not js.job.guaranteed:
            return None
        if ctx is not None and ctx.quota_live is not None:
            t = js.job.tenant
            held = ctx.quota_live.get(t, 0)
            reserved = ctx.quota_reserved.get(t, 0)
            if js.status == "running":
                held -= js.total_gpus
            elif js.status == "queued":
                reserved -= js.min_res[0] if js.min_res else js.job.req_gpus
            return max(quota - held - reserved, 0)
        held = reserved = 0
        for j in active:
            if j is js or not j.job.guaranteed \
                    or j.job.tenant != js.job.tenant:
                continue
            if j.status == "running":
                held += j.total_gpus
            elif j.status == "queued":
                reserved += j.min_res[0] if j.min_res else j.job.req_gpus
        return max(quota - held - reserved, 0)

    # ------------------------------------------------------------------
    def _schedule_job(self, js: JobState, active: list[JobState],
                      cluster: Cluster, now: float,
                      used: dict | None = None,
                      by_node: dict | None = None,
                      ctx: _PassCtx | None = None,
                      sig: tuple | None = None) -> None:
        """ScheduleJob (lines 6-24): greedy node walk with shrink, one GPU
        type group at a time (placements never span GPU types).  ``used``
        is the pass-wide per-node usage of all running jobs and ``by_node``
        the per-node resident index; both are updated in place when this
        job commits (so later jobs in the same pass see the new state) and
        left untouched on failure.  ``sig`` is the queued-job walk
        signature when the incremental caller already computed it."""
        if js.status == "running" and not self.cfg.reallocate_resources:
            return
        rec = self.recorder
        # reconfiguration-penalty time gate (Sec 5.2), evaluated BEFORE the
        # walk (bugfix): if a running job cannot pay another pause yet, no
        # new assignment can be committed, so never shrink victims for it
        # — and the gate's opening time is deterministic, so the job can
        # be parked until then (incremental engine)
        # A degraded guaranteed job (shrunk below minRes by failure
        # recovery) bypasses the gate: restoring a violated guarantee is
        # the same restart kill-and-requeue performs through the ungated
        # admission path, so gating it here would bias recovery-policy
        # comparisons against shrink.
        degraded = js.status == "running" and js.job.guaranteed \
            and js.min_res is not None and js.total_gpus < js.min_res[0]
        if js.status == "running" and not degraded \
                and not self._reconfig_gate(js):
            if ctx is not None:
                ctx.park_gate(js, self, now)
                if rec is not None:
                    rec.decision("park", now, job=js.job.name,
                                 cause="gate")
            return
        failed = None
        if ctx is not None:
            # parked walks were already skipped inline by the caller
            # (schedule()); arriving here means the walk must run
            ctx.cur_read = []
        else:
            # the memo is only valid inside one schedule() pass (which
            # resets it); direct calls with used=None bypass it
            failed = getattr(self, "_failed_sigs", None) \
                if used is not None else None
            if failed is not None and js.status == "queued":
                sig = _walk_sig(js)
                if sig in failed:
                    return
        if used is None:
            others = [j for j in active
                      if j is not js and j.status == "running"]
            base = used_per_node(others)
            by_node = {}
            for j in others:
                for nid in j.placement:
                    by_node.setdefault(nid, []).append(j)
            self._victim_seq = {id(j): i for i, j in enumerate(active)}
        else:
            base = dict(used)
            for nid, (g, c, m) in js.placement.items():
                ug, uc, um = base[nid]
                base[nid] = (ug - g, uc - c, um - m)
        for nodes, env in self._group_order(js, cluster):
            curve = self.curve(js, cluster, env)
            min_g = js.min_res[0] if js.min_res else js.job.req_gpus
            target_g = self._target_gpus(js, curve, cluster, active, ctx)
            if target_g <= 0:
                return
            # the greedy node-order walk can collect a ragged geometry
            # (e.g. 4+8+4) that best_plan_at_most cannot realize even
            # though whole free nodes exist; when it fails to commit,
            # retry once with nodes ordered most-free-first (attempted
            # ONLY on failure, so every walk that used to succeed is
            # byte-identical)
            was = (js.status, js.plan, js.alloc, js.placement)
            committed = False
            for try_nodes in self._walk_orders(nodes, base):
                wu = dict(base)          # walk-local copy, mutated by shrinks
                placement, got_g, got_c, shrunk = self._walk_group(
                    js, by_node, try_nodes, cluster, env, curve, target_g,
                    min_g, wu, ctx)
                # lines 19-24: commit if ≥ minRes
                if got_g >= max(min_g, 1) and self._commit(
                        js, curve, env, cluster, wu, placement,
                        got_g, got_c, now):
                    committed = True
                    break
                if rec is not None and shrunk:
                    t0 = perf_counter()
                    self._undo(shrunk, ctx)
                    # lint: nondeterminism — wall-clock profiler span
                    rec.span_since("rollback", t0, now,
                                   n_victims=len(shrunk))
                else:
                    self._undo(shrunk, ctx)
            if committed:
                if used is not None:
                    # fold the walk's surviving shrinks + the new placement
                    # back into the pass-wide usage map + resident index
                    used.clear()
                    used.update(wu)
                    for nid, (g, c, m) in js.placement.items():
                        ug, uc, um = used.get(nid, (0, 0, 0.0))
                        used[nid] = (ug + g, uc + c, um + m)
                        res = by_node.setdefault(nid, [])
                        if js not in res:
                            res.append(js)
                changed = shrunk or was != (js.status, js.plan, js.alloc,
                                            js.placement)
                if ctx is not None:
                    if changed:
                        ctx.mark_dirty(js)
                        ctx.bump_nodes(set(was[3]) | set(js.placement))
                        if ctx.quota_live is not None and js.job.guaranteed:
                            t = js.job.tenant
                            old_g = sum(g for g, _, _ in was[3].values())
                            ctx.ledger_add_live(t, js.total_gpus - old_g)
                            if was[0] == "queued":
                                ctx.ledger_add_reserved(
                                    t, -(js.min_res[0] if js.min_res
                                         else js.job.req_gpus))
                    else:
                        # committed no-op (identical assignment, nothing
                        # shrunk): park against the walk's read-set so it
                        # is skipped until a node it actually read (or
                        # its own placement) changes
                        ctx.park_noop(js, self)
                        if rec is not None:
                            rec.decision("park", now, job=js.job.name,
                                         cause="noop")
                elif failed is not None and changed:
                    failed.clear()       # cluster state changed
                if rec is not None and changed:
                    self._emit_commit(rec, js, was, shrunk, cluster, env,
                                      now)
                return
        if ctx is not None:
            # record the failure post-rollback (cluster state again equals
            # what the walk read): identical state → skip the re-walk
            ctx.park_failed(js, self, cluster,
                            None if js.status == "running" else sig)
            if rec is not None:
                rec.decision("park", now, job=js.job.name,
                             cause="walk-failed")
        elif sig is not None:
            # lint: unscoped-id — pass-local memo: schedule() resets it
            # every pass and the signature referents outlive the pass via
            # the caller's jobs list
            failed.add(sig)

    def _emit_commit(self, rec, js: JobState, was: tuple, shrunk: dict,
                     cluster: Cluster, env: Env, now: float) -> None:
        """Flight-recorder provenance for one committed walk: the
        beneficiary's admit/reconfig event, then one shrink/preempt
        event per surviving victim carrying the slope at its pre-shrink
        size — the quantity the victim ranking compared — so every
        reallocation in a trace is attributable."""
        status0, plan0, alloc0, placement0 = was
        old_g = sum(g for g, _, _ in placement0.values())
        if status0 == "queued":
            rec.decision("admit", now, job=js.job.name,
                         data={"gpus": js.total_gpus,
                               "plan": str(js.plan),
                               "queued_s": now - js.job.submit})
        elif (js.plan, js.alloc) != (plan0, alloc0):
            cause = "grow" if js.total_gpus > old_g else \
                ("shrink" if js.total_gpus < old_g else "replan")
            rec.decision("reconfig", now, job=js.job.name, cause=cause,
                         data={"gpus": [old_g, js.total_gpus],
                               "plan": [str(plan0), str(js.plan)]})
        elif js.placement != placement0:
            rec.decision("reconfig", now, job=js.job.name,
                         cause="migrate",
                         data={"gpus": [old_g, js.total_gpus],
                               "plan": [str(plan0), str(js.plan)]})
        # lint: nondeterminism — shrunk preserves the walk's first-shrink
        # insertion order (deterministic), never id() order
        for entry in shrunk.values():
            victim, _obj, content, _plan, _alloc, _status, _n = entry
            vg0 = sum(g for g, _, _ in content.values())
            if victim.status == "queued":
                rec.decision("preempt", now, job=victim.job.name,
                             cause=js.job.name, data={"from_gpus": vg0})
            else:
                slope = self.curve(victim, cluster, env) \
                    .slope_gpu_down(vg0)
                rec.decision("shrink", now, job=victim.job.name,
                             cause=js.job.name,
                             data={"from_gpus": vg0,
                                   "to_gpus": victim.total_gpus,
                                   "slope": slope})

    @staticmethod
    def _walk_orders(nodes: list, base: dict):
        """Walk orderings for one GPU-type group: the canonical node order
        first, then (only reached when that walk failed to commit) the
        same nodes most-free-first — whole free nodes before scraps, so a
        multi-node job gets a geometry ``best_plan_at_most`` can realize.
        Deterministic: free GPUs descending, node id ascending."""
        yield nodes
        alt = sorted(nodes, key=lambda n: (
            -(n.gpus - base.get(n.id, (0, 0, 0.0))[0]), n.id))
        if [n.id for n in alt] != [n.id for n in nodes]:
            yield alt

    def _group_order(self, js: JobState, cluster: Cluster,
                     ) -> list[tuple[list, Env]]:
        """GPU-type groups to try, best predicted throughput first; a job
        with a required ``gpu_type`` only sees matching nodes.  Homogeneous
        clusters yield one anonymous group — the classic full-node walk.
        Memoized per (model type, fitted, gpu_type, request): node
        geometry and curves are fixed, so the ranking never changes.  The
        memo is scoped to one cluster by _scope_memos, so no Cluster
        object is pinned and sweeps cannot grow it without bound."""
        groups = cluster.type_groups()
        if not cluster.is_hetero:
            order = self._order_memo.get(None)
            if order is None:
                order = self._order_memo[None] = \
                    [(nodes, self.env) for nodes in groups.values()]
            return order
        key = (id(js.job.profile), id(js.fitted), js.job.gpu_type,
               js.job.req_gpus)
        hit = self._order_memo.get(key)
        if hit is not None:
            return hit
        want = js.job.gpu_type
        ranked = []
        for model, nodes in groups.items():
            if want and model != want:
                continue
            env = cluster.envs.get(model, self.env)
            cap = sum(n.gpus for n in nodes)
            thpt = self.curve(js, cluster, env).throughput(
                min(js.job.req_gpus, cap))
            ranked.append((thpt, len(ranked), nodes, env))
        ranked.sort(key=lambda r: (-r[0], r[1]))
        order = [(nodes, env) for _, _, nodes, env in ranked]
        self._order_memo[key] = order
        return order

    def _walk_group(self, js: JobState, by_node: dict, nodes: list,
                    cluster: Cluster, env: Env, curve: SensitivityCurve,
                    target_g: int, min_g: int, wu: dict,
                    ctx: _PassCtx | None = None,
                    ) -> tuple[Placement, int, int, dict]:
        """Greedy walk over one type group (lines 7-18).  ``wu`` is the
        walk-local per-node usage of the OTHER running jobs and ``by_node``
        the (soft) per-node resident index; shrinks update ``wu`` in
        place.  Returns the tentative placement plus pre-shrink snapshots
        of every mutated victim so a failed walk can be rolled back."""
        placement: Placement = {}
        got_g = got_c = 0
        realloc = self.cfg.reallocate_resources
        my_slope = curve.slope_gpu(0 if js.status == "queued"
                                   else js.total_gpus)
        shrunk: dict[int, tuple] = {}
        # read-set capture feeds the no-op park, which only running
        # walkers can hit (queued walks either fail or change state)
        reads = ctx.cur_read if ctx is not None \
            and js.status == "running" else None
        for node in nodes:
            if got_g >= target_g:
                break
            if reads is not None:
                reads.append(node.id)
            # quarantined nodes are invisible to placement (gray-failure
            # mitigation).  The skip comes AFTER the read-set append so a
            # parked no-op walk subscribes to the node and the release
            # bump wakes it.
            if node.id in self.quarantined:
                continue
            fg, fc, fm = node.free(wu)
            if ctx is not None and fg <= 0:
                # free-capacity index: a full node with no shrinkable
                # resident (victim index empty, walker excluded) can
                # neither yield GPUs nor be mutated — skip it wholesale
                if not realloc or not ctx.has_victim(node.id, env, self,
                                                     cluster, js):
                    continue
            take_g = min(fg, target_g - got_g)
            take_c = min(fc, self.cfg.cpus_per_gpu * take_g)
            # lines 8-16: reclaim from the least-sensitive over-min job;
            # candidates come from the soft resident index (stale members
            # and the walking job itself are filtered in the slope scan)
            while take_g < min(node.gpus, target_g - got_g) and realloc:
                if ctx is not None:
                    victim, v_slope = ctx.pick_victim(node.id, env, self,
                                                      cluster, js)
                else:
                    victim = self._lowest_slope_over_min(
                        by_node.get(node.id, ()), node.id, cluster, env,
                        exclude=js)
                    if victim is not None:
                        v_slope = self.curve(victim, cluster, env) \
                            .slope_gpu_down(victim.total_gpus)
                if victim is None:
                    break
                need_min = got_g + take_g < min_g
                if not (my_slope > v_slope or need_min):
                    break
                if id(victim) not in shrunk:
                    # snapshot BOTH the placement content and the dict
                    # object: a rollback must restore into the original
                    # object, or observers holding a pre-pass reference
                    # (the simulator's migration detection) see a
                    # mutated-then-abandoned dict and phantom changes
                    shrunk[id(victim)] = (victim, victim.placement,
                                          dict(victim.placement),
                                          victim.plan, victim.alloc,
                                          victim.status, victim.n_reconfig)
                dg, dc, dm = self._shrink(victim, node.id, cluster, env,
                                          ctx)
                ug, uc, um = wu.get(node.id, (0, 0, 0.0))
                wu[node.id] = (ug - dg, uc - dc, um - dm)
                fg, fc, fm = node.free(wu)
                take_g = min(fg, target_g - got_g)
                take_c = min(fc, self.cfg.cpus_per_gpu * take_g)
            if take_g > 0:
                placement[node.id] = (take_g, take_c, 0.0)
                got_g += take_g
                got_c += take_c
        return placement, got_g, got_c, shrunk

    def _commit(self, js: JobState, curve: SensitivityCurve, env: Env,
                cluster: Cluster, wu: dict, placement: Placement,
                got_g: int, got_c: int, now: float) -> bool:
        """AllocMem + plan selection + state mutation (lines 19-24).
        ``wu`` is the post-walk per-node usage of the other running jobs.
        Returns False (mutating nothing) when the assignment is
        infeasible, so the caller can roll back the walk's shrinks."""
        pernode = tuple(sorted((g for g, _, _ in placement.values()),
                               reverse=True))
        if self.cfg.reconfigure_plans:
            pt = curve.best_plan_at_most(got_g, got_c, gpus_per_node=pernode)
            plan = pt.plan
        else:
            plan = self._fixed_plan(js, got_g, env)
        if plan is None:
            return False
        alloc = Alloc(got_g, got_c, gpus_per_node=pernode)
        est = memory.estimate(js.job.profile, plan, alloc, env)
        if est.gpu_bytes > env.gpu_mem:                # AllocMem failure
            return False
        # per-node host-memory fit (bugfix): the committed placement writes
        # est.host_bytes/len(placement) into every node; verify each node
        # can actually hold its share before mutating any state, or stacked
        # offload jobs over-allocate host memory
        host_share = est.host_bytes / max(len(placement), 1)
        for nid in placement:
            if host_share > cluster.nodes[nid].free(wu)[2] + 1e-3:
                return False
        # reconfiguration penalty guard (Sec 5.2)
        if js.status == "running" and not self._reconfig_ok(js, plan,
                                                            alloc, now):
            return False
        for nid in placement:
            g, c, _ = placement[nid]
            placement[nid] = (g, c, host_share)
        changed = (plan != js.plan or alloc != js.alloc)
        js.placement = placement
        js.alloc = alloc
        js.plan = plan
        if js.status == "queued":
            js.status = "running"
            js.start_time = now if js.start_time is None else js.start_time
        elif changed:
            js.n_reconfig += 1
        return True

    # ------------------------------------------------------------------
    def _target_gpus(self, js: JobState, curve: SensitivityCurve,
                     cluster: Cluster, active: list[JobState],
                     ctx: _PassCtx | None = None) -> int:
        """Grow while the slope is positive, up to cluster size — capped by
        the tenant's remaining quota room (bugfix: unbounded growth let a
        tenant exceed its quota in actually-held GPUs)."""
        if not self.cfg.reallocate_resources:
            return js.job.req_gpus
        target = curve.grow_target(js.job.req_gpus, cluster.total_gpus)
        room = self._quota_room(js, active, ctx)
        if room is not None:
            min_g = js.min_res[0] if js.min_res else js.job.req_gpus
            target = min(target, max(room, min_g, 1))
        return target

    def _fixed_plan(self, js: JobState, gpus: int,
                    env: Env | None = None) -> ExecutionPlan | None:
        """Rubick-R: keep the plan family, scale only the DP size (Sia's
        approach for 3D-parallel jobs)."""
        env = env or self.env
        orig = js.job.orig_plan
        tp_pp = orig.tp * orig.pp
        if gpus % tp_pp:
            return None
        d = gpus // tp_pp
        if js.job.profile.b % (d * max(orig.ga_steps, 1)):
            return None
        plan = orig.with_(dp=d)
        alloc = Alloc(gpus, self.cfg.cpus_per_gpu * gpus)
        if not memory.feasible(js.job.profile, plan, alloc, env):
            return None
        return plan

    # ------------------------------------------------------------------
    # capacity-loss recovery (failure & elasticity engine)
    # ------------------------------------------------------------------
    def recover(self, js: JobState, active: list[JobState],
                cluster: Cluster, lost: set[int], now: float) -> str:
        """Recovery policy for one running job that just lost the nodes in
        ``lost``: re-plan over the SURVIVING slice of its placement via
        ``best_plan_at_most`` (``_fixed_plan`` for DP-only elasticity when
        plan reconfiguration is off), falling back to kill-and-requeue
        when nothing feasible survives — or always, under the
        ``recovery="kill"`` checkpoint-restart baseline.

        Mutates ``js`` exactly like ``_commit`` (fresh placement dict) and
        returns "shrunk" or "killed"; the simulator charges the restore
        pause and rolls progress back to the last checkpoint either way.
        Shrinking below minRes intentionally beats killing here: a
        degraded guaranteed job keeps making progress, and the guarantee-
        violation metric charges the degradation.  No reconfiguration gate
        — the reconfiguration is forced, not elective."""
        surv = {nid: r for nid, r in js.placement.items() if nid not in lost}
        got_g = sum(g for g, _, _ in surv.values())
        got_c = sum(c for _, c, _ in surv.values())
        elastic = self.cfg.reconfigure_plans or self.cfg.reallocate_resources
        if self.cfg.recovery == "shrink" and elastic and got_g >= 1:
            env = (cluster.env_for(next(iter(surv)), self.env) or self.env) \
                if cluster.is_hetero else self.env
            pernode = tuple(sorted((g for g, _, _ in surv.values()),
                                   reverse=True))
            if self.cfg.reconfigure_plans:
                curve = self.curve(js, cluster, env)
                pt = curve.best_plan_at_most(got_g, got_c,
                                             gpus_per_node=pernode)
                plan = pt.plan
            else:
                plan = self._fixed_plan(js, got_g, env)
            if plan is not None:
                alloc = Alloc(got_g, got_c, gpus_per_node=pernode)
                est = memory.estimate(js.job.profile, plan, alloc, env)
                host_share = est.host_bytes / max(len(surv), 1)
                others = used_per_node([j for j in active if j is not js
                                        and j.status == "running"])
                fits = est.gpu_bytes <= env.gpu_mem and all(
                    host_share <= cluster.nodes[nid].free(others)[2] + 1e-3
                    for nid in surv)
                if fits:
                    js.placement = {nid: (g, c, host_share)
                                    for nid, (g, c, _) in surv.items()}
                    js.alloc = alloc
                    js.plan = plan
                    js.n_reconfig += 1
                    return "shrunk"
        js.status = "queued"
        js.placement = {}
        js.plan = None
        js.alloc = None
        return "killed"

    def _lowest_slope_over_min(self, cands, node_id: int,
                               cluster: Cluster, env: Env | None = None,
                               exclude: JobState | None = None,
                               ) -> JobState | None:
        """Least-sensitive over-minRes resident of one node.  Exact-slope
        ties (jobs of the same model type and size share one curve) break
        on the job's stable arrival order — NOT on the resident list's
        incidental order, which depends on when a job was (re)placed
        within the pass — so both pass engines pick the same victim."""
        seq = getattr(self, "_victim_seq", None) or {}
        best = None
        best_key = (math.inf, math.inf)
        for j in cands:
            if j is exclude or j.status != "running":
                continue
            p = j.placement.get(node_id)
            if p is None or p[0] <= 0:
                continue
            tg = j.total_gpus
            min_g = j.min_res[0] if j.min_res else j.job.req_gpus
            if tg <= max(min_g, 0):
                continue
            slope = self.curve(j, cluster, env).slope_gpu_down(tg)
            key = (slope, seq.get(id(j), math.inf))
            if key < best_key:
                best_key, best = key, j
        return best

    def _shrink(self, victim: JobState, node_id: int, cluster: Cluster,
                env: Env | None = None,
                ctx: _PassCtx | None = None) -> tuple[int, int, float]:
        """Take ΔGPU from the victim on one node.  Returns the (gpus,
        cpus, mem) freed there so walk-local usage maps can be updated
        without re-scanning every job."""
        affected = set(victim.placement) | {node_id}
        g, c, m = victim.placement[node_id]
        dg = min(DELTA_GPU, g)
        dc = min(self.cfg.cpus_per_gpu * dg, c)
        freed_m = 0.0
        if g - dg <= 0:
            del victim.placement[node_id]
            freed_m = m
        else:
            victim.placement[node_id] = (g - dg, c - dc, m)
        new_g = victim.total_gpus
        if new_g == 0:
            victim.status = "queued"     # preemption (best-effort only)
            victim.plan = None
            victim.alloc = None
            victim.placement = {}
        else:
            curve = self.curve(victim, cluster, env)
            pt = curve.best_plan_at_most(new_g, victim.total_cpus,
                                         victim.gpus_per_node_tuple())
            victim.plan = pt.plan if pt.plan else victim.plan
            victim.alloc = Alloc(new_g, victim.total_cpus,
                                 gpus_per_node=victim.gpus_per_node_tuple())
            victim.n_reconfig += 1
        if ctx is not None:
            ctx.mark_dirty(victim)
            # a multi-node victim's slope changed EVERYWHERE it resides —
            # bump its whole pre-shrink node set, not just this node
            ctx.bump_nodes(affected)
            if victim.job.guaranteed:
                ctx.ledger_add_live(victim.job.tenant, -dg)
        return dg, dc, freed_m

    def _undo(self, shrunk: dict[int, tuple],
              ctx: _PassCtx | None = None) -> None:
        """Restore every victim mutated during a failed walk (bugfix:
        shrinks used to persist even when the beneficiary never placed —
        victims lost GPUs for zero cluster-wide gain).  Restores into the
        ORIGINAL placement dict object (bugfix): external snapshots of
        the pre-pass placement (the event engine's migration detection)
        alias that object, and leaving it mutated made rolled-back walks
        look like phantom migrations — triggering spurious oracle
        re-measures and completion-event re-arms."""
        # lint: nondeterminism — per-victim restores touch disjoint jobs
        # and commute; rollback order cannot affect post-undo state
        for entry in shrunk.values():
            victim, orig_obj, content, plan, alloc, status, n_rcfg = entry
            if ctx is not None:
                ctx.mark_dirty(victim)
                ctx.bump_nodes(set(victim.placement) | set(content))
                if victim.job.guaranteed:
                    restored = sum(g for g, _, _ in content.values())
                    ctx.ledger_add_live(victim.job.tenant,
                                        restored - victim.total_gpus)
            orig_obj.clear()
            orig_obj.update(content)
            victim.placement = orig_obj
            victim.plan = plan
            victim.alloc = alloc
            victim.status = status
            victim.n_reconfig = n_rcfg

    def _reconfig_gate(self, js: JobState) -> bool:
        """Time-based part of the reconfiguration-penalty guard: whether a
        running job may pay one more checkpoint-resume pause while keeping
        (T − N·δ)/T above the threshold.  Independent of the candidate
        assignment, so it can gate the walk before any victim is shrunk."""
        T = max(js.run_time, 1.0)
        N = js.n_reconfig + 1
        return (T - N * self.cfg.reconfig_cost_s) / T \
            >= self.cfg.reconfig_threshold

    def _reconfig_ok(self, js: JobState, plan, alloc, now: float) -> bool:
        if plan == js.plan and alloc == js.alloc:
            return True
        if js.job.guaranteed and js.min_res is not None \
                and js.total_gpus < js.min_res[0]:
            # degraded by failure recovery: regaining minRes is the same
            # restart kill-and-requeue performs through the ungated
            # admission path — never amortization-gate it
            return True
        return self._reconfig_gate(js)


def throughput_of(js: JobState, env: Env) -> float:
    """Oracle-free predicted throughput of a job's current assignment."""
    if js.status != "running" or js.plan is None or js.alloc is None:
        return 0.0
    return predict_throughput(js.job.profile, js.plan, js.alloc, env,
                              js.fitted)
