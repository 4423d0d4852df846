"""Runtime cross-checking of the incremental scheduling core.

A copy of ``repro.analysis.sanitizer`` for the port; its violations
name the port's own mutation sites (``analysis/tables.py``).

``SchedSanitizer`` recomputes ground truth from the live job states at
well-defined checkpoints and compares it against the scheduler's
persistent indexes — the structures the invariant linter
(the reference's ``repro.analysis.lint``) can only reason about statically:

* **pass boundary** (``begin_pass`` / ``end_pass``): per-node capacity,
  rollback aliasing (a rolled-back walk must restore the ORIGINAL
  placement dict object), shrink-with-no-beneficiary, hard tenant
  quotas, and — under the incremental engine — the usage map, resident
  index coverage, the slope order, the per-node victim indexes, the
  quota ledger, and the parked-signature pin store;
* **simulation window** (``check_window``): the engines' run-time /
  progress arithmetic, including pause crediting across reconfigs;
* **calibration** (``check_manager``): version monotonicity, current-
  params identity, and the warm-start improvement guarantee.

Violations raise ``SanitizerViolation`` (an ``AssertionError``) whose
message carries the candidate mutation sites from
``repro_torch.analysis.tables`` — the report points at code, not just state.

``REPRO_SANITIZE_EVERY=N`` checks every Nth scheduling pass (default 1);
``check_window`` is cheap and always on once the sanitizer exists.
"""

from __future__ import annotations

import math
import os

from repro_torch.analysis.tables import sites_for


class SanitizerViolation(AssertionError):
    """An incremental-state invariant failed a runtime cross-check."""

    def __init__(self, rule: str, detail: str, attrs: tuple = ()):
        self.rule = rule
        self.detail = detail
        self.sites = sites_for(*attrs) if attrs else ()
        msg = f"[{rule}] {detail}"
        if self.sites:
            shown = ", ".join(str(s) for s in self.sites[:6])
            more = len(self.sites) - 6
            if more > 0:
                shown += f", +{more} more"
            msg += f"\n  candidate mutation sites: {shown}"
        super().__init__(msg)


def _jname(js) -> str:
    return getattr(js.job, "name", "?")


class SchedSanitizer:
    """Cross-checks scheduler passes / simulation windows / calibration
    against recomputed ground truth (see module docstring)."""

    MEM_RTOL = 1e-6

    def __init__(self, every: int | None = None):
        if every is None:
            every = int(os.environ.get("REPRO_SANITIZE_EVERY", "1") or 1)
        self.every = max(every, 1)
        self._tick = 0
        self._snap: dict | None = None

    # -- pass boundary -------------------------------------------------
    def begin_pass(self, active: list, cluster) -> None:
        """Snapshot every active job's pre-pass assignment (status, the
        placement dict OBJECT, and its content) so ``end_pass`` can
        check rollbacks restored in place and shrinks fed someone."""
        self._tick += 1
        if self._tick % self.every:
            self._snap = None
            return
        self._snap = {
            id(js): (js, js.status, js.placement, dict(js.placement),
                     js.total_gpus, js.n_reconfig)
            for js in active}

    def end_pass(self, active: list, cluster, ctx, scheduler) -> None:
        snap = self._snap
        if snap is None:
            return
        self._snap = None
        running = [j for j in active if j.status == "running"]
        self._check_capacity(running, cluster)
        self._check_dead_nodes(running, cluster, ctx)
        self._check_rollback_aliasing(active, snap)
        self._check_beneficiary(active, snap)
        self._check_quota(running, scheduler)
        self._check_quarantine(running, scheduler)
        if ctx is not None:
            self._check_usage_map(running, ctx)
            self._check_by_node(running, ctx)
            self._check_order(ctx, scheduler, cluster)
            self._check_victim_cache(ctx, scheduler, cluster)
            self._check_ledger(active, ctx, scheduler)
            self._check_parked_pins(ctx)

    # -- individual pass checks ----------------------------------------
    @staticmethod
    def _used_per_node(running: list) -> dict:
        used: dict[int, list] = {}
        for js in running:
            for nid, (g, c, m) in js.placement.items():
                u = used.setdefault(nid, [0, 0, 0.0])
                u[0] += g
                u[1] += c
                u[2] += m
        return {nid: (int(v[0]), int(v[1]), v[2])
                for nid, v in used.items()}

    def _check_capacity(self, running: list, cluster) -> None:
        used = self._used_per_node(running)
        for node in cluster.nodes:
            g, c, m = used.get(node.id, (0, 0, 0.0))
            if g > node.gpus or c > node.cpus or m > node.mem + 1e-3:
                raise SanitizerViolation(
                    "capacity",
                    f"node {node.id} over-allocated: used "
                    f"(g={g}, c={c}, m={m:.3e}) vs caps "
                    f"(g={node.gpus}, c={node.cpus}, m={node.mem:.3e})",
                    ("placement",))

    def _check_dead_nodes(self, running: list, cluster, ctx) -> None:
        """Failure & elasticity invariants: no running placement may
        reference a down node (the capacity-loss path must evict every
        resident), and a down node's freed capacity must be fully folded
        out of the incremental usage map (a leaked entry re-blocks the
        node forever after it recovers)."""
        down = {n.id for n in cluster.nodes if not n.up}
        if not down:
            return
        for js in running:
            for nid in js.placement:
                if nid in down:
                    raise SanitizerViolation(
                        "dead-node-placement",
                        f"job {js.job.name} still holds "
                        f"{js.placement[nid]} on down node {nid} — the "
                        "capacity-loss path failed to evict it",
                        ("placement", "up"))
        if ctx is not None:
            for nid in down:
                g, c, m = ctx.used.get(nid, (0, 0, 0.0))
                if g or c or m > 1e-3:
                    raise SanitizerViolation(
                        "dead-node-usage",
                        f"ctx.used[{nid}] = (g={g}, c={c}, m={m:.3e}) "
                        f"but node {nid} is down — eviction leaked the "
                        "usage-map entry",
                        ("used", "up"))

    def _check_rollback_aliasing(self, active: list, snap: dict) -> None:
        """A job whose post-pass assignment equals its pre-pass one must
        still hold the ORIGINAL placement dict object, and that object
        must hold the original content: external observers (the event
        engine's migration detection) alias it across the pass."""
        for js in active:
            s = snap.get(id(js))
            if s is None:
                continue
            _, old_status, old_obj, old_content, _, old_nrcfg = s
            if js.status != old_status or js.n_reconfig != old_nrcfg:
                # genuinely reconfigured this pass (a surviving shrink
                # followed by a re-grow can round-trip the CONTENT while
                # legitimately leaving the older dict behind) — only an
                # exact pre-pass state claims to be a rollback
                continue
            if dict(js.placement) != old_content:
                continue
            if js.placement is not old_obj and dict(old_obj) != old_content:
                raise SanitizerViolation(
                    "rollback-aliasing",
                    f"job {_jname(js)!r} ended the pass with its pre-pass "
                    "assignment, but the original placement dict was "
                    "abandoned while mutated (a rollback must restore "
                    "into the object external snapshots alias)",
                    ("placement",))

    def _check_beneficiary(self, active: list, snap: dict) -> None:
        """Shrinks only exist to feed a commit: if any job was shrunk in
        place this pass, some job must have committed a new assignment
        (otherwise a failed walk's shrinks escaped rollback).  A commit
        always installs a FRESH placement dict; shrink victims keep
        their original (mutated) one — that distinguishes a job that
        legitimately committed itself smaller from an abandoned victim."""
        losers, committed = [], False
        for js in active:
            s = snap.get(id(js))
            if s is None:
                committed = committed or js.status == "running"  # arrival
                continue
            _, old_status, old_obj, _, old_gpus, _ = s
            fresh_commit = js.status == "running" \
                and js.placement is not old_obj
            if fresh_commit:
                committed = True
            elif js.total_gpus < old_gpus \
                    or (old_status == "running" and js.status == "queued"):
                losers.append((js, old_gpus, js.total_gpus))
        if losers and not committed:
            worst = ", ".join(f"{_jname(j)!r} {og}->{ng}"
                              for j, og, ng in losers[:4])
            raise SanitizerViolation(
                "shrink-no-beneficiary",
                f"jobs were shrunk/preempted with no commit in the pass: "
                f"{worst} (failed-walk shrinks must be rolled back)",
                ("placement", "status", "plan", "alloc"))

    def _check_quota(self, running: list, scheduler) -> None:
        quotas = getattr(scheduler, "quotas", None) or {}
        for tenant, quota in quotas.items():
            held = sum(j.total_gpus for j in running
                       if j.job.guaranteed and j.job.tenant == tenant)
            if held > quota:
                raise SanitizerViolation(
                    "quota",
                    f"tenant {tenant!r} holds {held} GPUs over quota "
                    f"{quota} (live accounting must bound actual holdings,"
                    " not the minRes floor)",
                    ("quota_live", "quota_reserved"))

    @staticmethod
    def _check_quarantine(running: list, scheduler) -> None:
        """Gray-failure invariant: no scheduler PASS may place a job on
        a quarantined node.  Residents caught on a node at quarantine
        time are migrated by the simulator between passes, so by the
        next pass boundary no running placement intersects the set."""
        quar = getattr(scheduler, "quarantined", None)
        if not quar:
            return
        for js in running:
            held = quar & js.placement.keys()
            if held:
                raise SanitizerViolation(
                    "quarantine-placement",
                    f"running job {_jname(js)!r} holds "
                    f"{sorted(held)} of the quarantined set "
                    f"{sorted(quar)} after a pass — walks must skip "
                    "quarantined nodes and mitigation must migrate "
                    "residents away",
                    ("placement", "quarantined"))

    def _check_usage_map(self, running: list, ctx) -> None:
        truth = self._used_per_node(running)
        for nid in set(truth) | set(ctx.used):
            tg, tc, tm = truth.get(nid, (0, 0, 0.0))
            ug, uc, um = ctx.used.get(nid, (0, 0, 0.0))
            # incremental +/- on byte-scale floats leaves ~ulp residue on
            # emptied nodes: allow the same 1e-3-byte slack the capacity
            # invariant (cluster.check_capacity) grants, plus rel tol
            mem_ok = abs(tm - um) <= \
                self.MEM_RTOL * max(abs(tm), abs(um)) + 1e-3
            if tg != ug or tc != uc or not mem_ok:
                raise SanitizerViolation(
                    "usage-map",
                    f"ctx.used[{nid}] = (g={ug}, c={uc}, m={um:.6e}) but "
                    f"recomputed from placements = (g={tg}, c={tc}, "
                    f"m={tm:.6e})",
                    ("used",))

    @staticmethod
    def _check_by_node(running: list, ctx) -> None:
        """The resident index is soft (stale entries are filtered at
        query time) but must COVER: a running resident missing from its
        node's list can never be found as a shrink victim."""
        for js in running:
            for nid, (g, _, _) in js.placement.items():
                if g <= 0:
                    continue
                res = ctx.by_node.get(nid, ())
                if not any(r is js for r in res):
                    raise SanitizerViolation(
                        "resident-index",
                        f"running job {_jname(js)!r} holds {g} GPUs on "
                        f"node {nid} but is missing from ctx.by_node[{nid}]",
                        ("by_node",))

    @staticmethod
    def _check_order(ctx, scheduler, cluster) -> None:
        order = ctx.order
        for i in range(1, len(order)):
            if order[i - 1] > order[i]:
                raise SanitizerViolation(
                    "slope-order",
                    f"ctx.order not sorted at index {i}: "
                    f"{order[i - 1]} > {order[i]}",
                    ("order", "order_key"))
        if sorted(order) != sorted(ctx.order_key.values()):
            raise SanitizerViolation(
                "slope-order",
                "ctx.order and ctx.order_key hold different entry "
                f"multisets ({len(order)} vs {len(ctx.order_key)})",
                ("order", "order_key", "dirty"))
        for jid, js in ctx.members.items():
            if jid in ctx.dirty:
                continue               # repair deferred to the next pass
            key = ctx.order_key.get(jid)
            if key is None:
                raise SanitizerViolation(
                    "slope-order",
                    f"member {_jname(js)!r} is neither ordered nor dirty",
                    ("order_key", "dirty"))
            fresh = ctx._order_entry(js, scheduler, cluster)
            if key != fresh:
                raise SanitizerViolation(
                    "slope-order",
                    f"stale order entry for {_jname(js)!r}: indexed "
                    f"{key} but fresh slopes give {fresh} (mutation "
                    "without a dirty mark)",
                    ("order_key", "dirty"))

    @staticmethod
    def _check_victim_cache(ctx, scheduler, cluster) -> None:
        """Cache entries at a node's CURRENT version must equal a fresh
        scan — any resident mutation is required to bump the version."""
        for nid, hit in ctx.victim_cache.items():
            ver, env, entries = hit
            if ver != ctx.node_ver.get(nid, 0):
                continue               # stale by version: never served
            fresh = []
            for j in ctx.by_node.get(nid, ()):
                if j.status != "running":
                    continue
                p = j.placement.get(nid)
                if p is None or p[0] <= 0:
                    continue
                tg = j.total_gpus
                min_g = j.min_res[0] if j.min_res else j.job.req_gpus
                if tg <= max(min_g, 0):
                    continue
                slope = scheduler.curve(j, cluster, env).slope_gpu_down(tg)
                fresh.append((slope, ctx.seq.get(id(j), 0), j))
            fresh.sort(key=lambda e: (e[0], e[1]))
            same = len(fresh) == len(entries) and all(
                a[0] == b[0] and a[1] == b[1] and a[2] is b[2]
                for a, b in zip(fresh, entries))
            if not same:
                raise SanitizerViolation(
                    "victim-index",
                    f"victim cache for node {nid} at current version "
                    f"{ver} disagrees with a fresh scan "
                    f"({len(entries)} cached vs {len(fresh)} fresh "
                    "entries; a resident mutated without a version bump)",
                    ("victim_cache", "node_ver"))

    @staticmethod
    def _check_ledger(active: list, ctx, scheduler) -> None:
        quotas = getattr(scheduler, "quotas", None) or {}
        if not quotas or ctx.quota_live is None:
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
        for name, truth, held in (("live", live, ctx.quota_live),
                                  ("reserved", reserved,
                                   ctx.quota_reserved)):
            for t in set(truth) | set(held):
                if truth.get(t, 0) != held.get(t, 0):
                    raise SanitizerViolation(
                        "quota-ledger",
                        f"{name} ledger for tenant {t!r} holds "
                        f"{held.get(t, 0)} but recomputing from job "
                        f"states gives {truth.get(t, 0)}",
                        ("quota_live", "quota_reserved"))

    @staticmethod
    def _check_parked_pins(ctx) -> None:
        """Every remembered walk signature embeds id(profile)/id(fitted);
        the pin store must hold exactly those referents or a recycled
        address can alias a stale walk outcome onto a fresh job."""
        for sig in ctx.parked_sigs:
            pin = ctx.parked_pins.get(sig)
            if pin is None:
                raise SanitizerViolation(
                    "memo-pin",
                    f"parked signature {sig} has no pinned referents "
                    "(its id() components may be recycled)",
                    ("parked_sigs", "parked_pins"))
            if sig[0] != id(pin[0]) or sig[1] != id(pin[1]):
                raise SanitizerViolation(
                    "memo-pin",
                    f"parked signature {sig} pins objects with different "
                    f"identities (id(profile)={id(pin[0])}, "
                    f"id(fitted)={id(pin[1])})",
                    ("parked_sigs", "parked_pins"))
        for sig in ctx.parked_pins:
            if sig not in ctx.parked_sigs:
                raise SanitizerViolation(
                    "memo-pin",
                    f"orphan pin for signature {sig}: pinned but not "
                    "parked (wake paths must drop both together)",
                    ("parked_sigs", "parked_pins"))

    # -- simulation windows --------------------------------------------
    @staticmethod
    def check_window(s, old: tuple, t: float, to: float, pu: float,
                     th: float) -> None:
        """One running job advanced over [t, to): run_time grows by the
        wall window; progress grows by throughput x EFFECTIVE seconds
        (the window minus any reconfiguration pause ending at ``pu``)."""
        old_run, old_prog = old
        exp_run = old_run + (to - t)
        eff = (to - t) if pu <= t else to - pu
        exp_prog = old_prog
        if eff > 0.0:
            exp_prog = old_prog + th * eff / s.job.profile.b
        tol = 1e-9 * max(abs(exp_run), 1.0)
        if not math.isclose(s.run_time, exp_run, rel_tol=1e-9,
                            abs_tol=tol):
            raise SanitizerViolation(
                "window-accounting",
                f"job {_jname(s)!r} run_time {s.run_time!r} != expected "
                f"{exp_run!r} over window [{t}, {to})",
                ("run_time",))
        ptol = 1e-9 * max(abs(exp_prog), 1.0)
        if not math.isclose(s.progress, exp_prog, rel_tol=1e-9,
                            abs_tol=ptol):
            raise SanitizerViolation(
                "window-accounting",
                f"job {_jname(s)!r} progress {s.progress!r} != expected "
                f"{exp_prog!r} over window [{t}, {to}) "
                f"(pause_until={pu}, throughput={th}): paused seconds "
                "must not earn progress",
                ("progress",))

    # -- gray failures --------------------------------------------------
    @staticmethod
    def check_op_rollback(js, plan0, alloc0, content0: dict) -> None:
        """A flaky reconfiguration exhausted its retry budget and rolled
        back: the job must be running its prior committed assignment
        again — identical plan/alloc objects and placement content."""
        if js.plan is not plan0 or js.alloc is not alloc0:
            raise SanitizerViolation(
                "op-rollback",
                f"job {_jname(js)!r} rolled back a failed reconfig but "
                f"runs (plan={js.plan}, alloc={js.alloc}) instead of the "
                f"prior committed (plan={plan0}, alloc={alloc0})",
                ("plan", "alloc"))
        if dict(js.placement) != content0:
            raise SanitizerViolation(
                "op-rollback",
                f"job {_jname(js)!r} rolled back a failed reconfig but "
                f"holds {dict(js.placement)} instead of the prior "
                f"committed placement {content0}",
                ("placement",))

    @staticmethod
    def check_health(monitor, scheduler) -> None:
        """Health bookkeeping invariants: the live per-node scores must
        equal a from-scratch replay of the append-only ledger, and the
        scheduler's quarantined set must mirror the monitor's."""
        truth = monitor.recompute_scores()
        for nid in set(truth) | set(monitor.scores):
            if truth.get(nid, 1.0) != monitor.scores.get(nid, 1.0):
                raise SanitizerViolation(
                    "health-ledger",
                    f"live health score for node {nid} is "
                    f"{monitor.scores.get(nid, 1.0)!r} but replaying the "
                    f"ledger gives {truth.get(nid, 1.0)!r} (every score "
                    "mutation must append a ledger entry)")
        sq = getattr(scheduler, "quarantined", None)
        if sq is not None and sq != monitor.quarantined:
            raise SanitizerViolation(
                "health-quarantine",
                f"scheduler.quarantined {sorted(sq)} != monitor's "
                f"{sorted(monitor.quarantined)} (set_quarantine deltas "
                "out of sync)")

    # -- calibration ---------------------------------------------------
    @staticmethod
    def check_manager(manager) -> None:
        """Versioned-refit invariants: version == published refit count
        per key, current params are the latest publication, and each
        warm-started refit improved (or matched) its own window."""
        from repro_torch.core.perfmodel import fit_key
        counts: dict[tuple, int] = {}
        last: dict[tuple, object] = {}
        for refit in manager.history:
            key = fit_key(refit.profile)
            counts[key] = counts.get(key, 0) + 1
            last[key] = refit.new
            if counts[key] != refit.version:
                raise SanitizerViolation(
                    "calibration",
                    f"refit versions for {key} not contiguous: "
                    f"{refit.version} published as refit #{counts[key]}")
            ok = (refit.rmsle_after <= refit.rmsle_before + 1e-9
                  or math.isnan(refit.rmsle_before)
                  or math.isnan(refit.rmsle_after))
            if not ok:
                raise SanitizerViolation(
                    "calibration",
                    f"warm-started refit v{refit.version} of {key} made "
                    f"its own window WORSE ({refit.rmsle_before:.6f} -> "
                    f"{refit.rmsle_after:.6f})")
        for key, n in counts.items():
            if manager._versions.get(key, 0) != n:
                raise SanitizerViolation(
                    "calibration",
                    f"version counter for {key} is "
                    f"{manager._versions.get(key, 0)} but history holds "
                    f"{n} refits")
            if manager._current.get(key) is not last[key]:
                raise SanitizerViolation(
                    "calibration",
                    f"current params for {key} are not the latest "
                    "published refit (identity mismatch)")
