"""Synthetic trace generation (paper Sec 7.3 + 7.4).

A copy of ``repro.core.trace`` for the port, held to the reference's job
lists and event streams by ``tests/test_torch_sched.py``.  The port's
simulator (``core/simulator.py``) consumes the streams.

Philly-style: bursty arrivals over a window, lognormal durations, GPU
requests from the Microsoft-trace distribution, model chosen from the
Table-2 set.  Variants:
  base   — random feasible initial plan per job;
  mt     — two tenants (A: 64-GPU quota, guaranteed; B: no quota,
           best-effort);
  bp     — initial plan replaced with the best plan at requested resources;
  hetero — mixed-GPU pools: roughly half the jobs pin a GPU model from
           ``HETERO_MIX`` (plan feasibility checked under that type's Env),
           the rest run on any type.

``philly()`` scales the same generator to production shape: 500+ jobs for
256+ GPU clusters with the Philly long-tail duration distribution.

Capacity processes (failure & elasticity engine): ``failure_storm``
draws per-node fail/repair times from exponential MTBF/MTTR (optionally
intensified inside a storm window) and ``spot_churn`` models a diurnal
preemptible pool (nodes arrive for an off-peak window each day, revoked
with a warning that lets jobs checkpoint cleanly).  Both are seeded and
return sorted ``CapacityEvent`` lists the simulator turns into heap
events (EV_CAPACITY).

Gray failures: ``degradation_storm`` emits ``DegradationEvent`` streams
— nodes do not die, they *slow down* (throttled GPU clocks, a flapping
NIC) by a per-episode factor, or hang outright (a very large factor).
The simulator multiplies measured T_iter of any job touching a degraded
node; nothing is freed, so only telemetry can reveal the problem.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core import memory, paper_models
from repro_torch.core.cluster import Job
from repro_torch.core.oracle import AnalyticOracle
from repro_torch.core.perfmodel import Alloc, Env, env_for_gpu
from repro_torch.parallel import plan_table
from repro_torch.parallel.plan import ExecutionPlan

# Philly-like request-size distribution (Jeon et al., ATC'19)
GPU_SIZES = [1, 2, 4, 8, 16, 32, 64]
GPU_PROBS = [0.45, 0.15, 0.15, 0.13, 0.07, 0.03, 0.02]

# GPU-model mix for the ``hetero`` variant (shares of jobs that pin each
# type; the other half of the jobs are type-agnostic)
HETERO_MIX = [("a800", 0.35), ("h800", 0.15), ("a100-40g", 0.25),
              ("v100", 0.25)]


def _check_rates(horizon_s: float, **rates_s: float) -> None:
    """Shared input validation for the capacity/degradation processes:
    every rate parameter must be a positive, finite number of seconds —
    a zero MTBF would loop forever, a negative MTTR silently reorders
    fail/repair pairs, and both used to yield degenerate streams."""
    if not (horizon_s > 0.0 and math.isfinite(horizon_s)):
        raise ValueError(
            f"horizon_s must be positive and finite, got {horizon_s!r}")
    for name, val in rates_s.items():
        if not (val > 0.0 and math.isfinite(val)):
            raise ValueError(
                f"{name} must be positive and finite, got {val!r} "
                f"(zero/negative rates yield degenerate event streams)")


def _check_storm(storm: tuple[float, float, float] | None,
                 horizon_s: float) -> None:
    """A storm window entirely outside ``[0, horizon_s)`` (or inverted,
    or with a non-positive rate multiplier) silently degenerates to the
    background process — reject it loudly instead."""
    if storm is None:
        return
    start, end, rate_mult = storm
    if end <= start:
        raise ValueError(
            f"storm window is empty: end ({end!r}) <= start ({start!r})")
    if start >= horizon_s or end <= 0.0:
        raise ValueError(
            f"storm window [{start!r}, {end!r}) lies outside the "
            f"horizon [0, {horizon_s!r}) — no event would see it")
    if not (rate_mult > 0.0 and math.isfinite(rate_mult)):
        raise ValueError(
            f"storm rate_mult must be positive and finite, "
            f"got {rate_mult!r}")


@dataclass(frozen=True)
class CapacityEvent:
    """One capacity change applied to a node mid-run.

    ``down=True`` kills the node (EV_NODE_FAIL / EV_SPOT_REVOKE),
    ``down=False`` restores it (EV_NODE_RECOVER / EV_SPOT_ARRIVE).
    ``warning_s > 0`` means revoke-with-warning: residents drain to a
    clean checkpoint during the warning, so no work is lost (hard
    failures roll back to the last periodic checkpoint).  ``kind`` is a
    label for accounting only — the simulator dispatches on ``down``."""
    time: float
    node: int
    down: bool
    warning_s: float = 0.0
    kind: str = "fail"       # fail | recover | spot-arrive | spot-revoke


def failure_storm(n_nodes: int, horizon_s: float, seed: int = 0,
                  mtbf_s: float = 4 * 86400.0, mttr_s: float = 3600.0,
                  storm: tuple[float, float, float] | None = None,
                  nodes: list[int] | None = None) -> list[CapacityEvent]:
    """Per-node exponential fail/repair process over ``[0, horizon_s)``.

    ``storm=(start_s, end_s, rate_mult)`` multiplies the failure hazard
    inside the window (a correlated failure storm — rack power loss,
    bad driver rollout).  Candidate failures are drawn at the storm-peak
    rate and thinned outside the window, so the process is an exact
    non-homogeneous Poisson draw and fully determined by ``seed``."""
    _check_rates(horizon_s, mtbf_s=mtbf_s, mttr_s=mttr_s)
    _check_storm(storm, horizon_s)
    if nodes is not None and not nodes:
        raise ValueError("failure_storm: nodes=[] would emit no events; "
                         "pass nodes=None to cover all n_nodes")
    if n_nodes <= 0 and nodes is None:
        raise ValueError(f"failure_storm: n_nodes must be positive, "
                         f"got {n_nodes!r}")
    rng = np.random.default_rng(seed)
    node_ids = list(range(n_nodes)) if nodes is None else list(nodes)
    peak = storm[2] if storm else 1.0
    events: list[CapacityEvent] = []
    for nid in node_ids:
        t = 0.0
        while True:
            t += float(rng.exponential(mtbf_s / peak))
            if t >= horizon_s:
                break
            mult = peak if (storm and storm[0] <= t < storm[1]) else 1.0
            if rng.random() >= mult / peak:          # thinned candidate
                continue
            events.append(CapacityEvent(t, nid, down=True, kind="fail"))
            t += float(rng.exponential(mttr_s))
            if t < horizon_s:
                events.append(CapacityEvent(t, nid, down=False,
                                            kind="recover"))
    events.sort(key=lambda e: (e.time, e.node, not e.down))
    return events


def spot_churn(spot_nodes: list[int], horizon_s: float, seed: int = 0,
               period_s: float = 86400.0, window_frac: float = 0.45,
               jitter_s: float = 1800.0, warning_s: float = 120.0,
               surprise_p: float = 0.15) -> list[CapacityEvent]:
    """Diurnal spot pool over ``spot_nodes`` (ids from
    ``Cluster.add_spot_nodes``): each period every spot node arrives
    around the off-peak start and is revoked (with ``warning_s`` of
    notice) around the window end, with per-node jitter.  With
    probability ``surprise_p`` per window the revoke instead lands
    mid-window with NO warning (capacity reclaimed early)."""
    if not spot_nodes:
        raise ValueError("spot_churn: spot_nodes is empty — pass the ids "
                         "returned by Cluster.add_spot_nodes")
    _check_rates(horizon_s, period_s=period_s)
    if not (0.0 < window_frac <= 1.0):
        raise ValueError(f"spot_churn: window_frac must be in (0, 1], "
                         f"got {window_frac!r}")
    rng = np.random.default_rng(seed)
    events: list[CapacityEvent] = []
    n_periods = int(math.ceil(horizon_s / period_s))
    for nid in spot_nodes:
        for k in range(n_periods):
            start = k * period_s + abs(float(rng.normal(0.0, jitter_s)))
            end = start + window_frac * period_s \
                - abs(float(rng.normal(0.0, jitter_s)))
            surprise = rng.random() < surprise_p
            if surprise:
                end = start + float(rng.uniform(0.15, 0.7)) \
                    * window_frac * period_s
            if start >= horizon_s or end <= start:
                continue
            events.append(CapacityEvent(start, nid, down=False,
                                        kind="spot-arrive"))
            if end < horizon_s:
                events.append(CapacityEvent(
                    end, nid, down=True,
                    warning_s=0.0 if surprise else warning_s,
                    kind="spot-revoke"))
    events.sort(key=lambda e: (e.time, e.node, not e.down))
    return events


@dataclass(frozen=True)
class DegradationEvent:
    """One gray-failure transition on a node (EV_DEGRADE).

    ``factor > 1`` slows every job with a worker on the node by that
    multiple of measured T_iter (the gang is gated by its slowest
    worker); ``factor == 1.0`` restores full speed.  ``hang=True``
    marks the episode as a hang rather than a throttle — same slowdown
    mechanics, but the factor is large enough that the job effectively
    stalls.  ``kind`` is an accounting label only."""
    time: float
    node: int
    factor: float
    hang: bool = False
    kind: str = "degrade"    # degrade | hang | recover


def degradation_storm(n_nodes: int, horizon_s: float, seed: int = 0,
                      mtbd_s: float = 2 * 86400.0,
                      mttr_s: float = 2 * 3600.0,
                      slowdown: tuple[float, float] = (2.0, 6.0),
                      hang_p: float = 0.1, hang_factor: float = 25.0,
                      storm: tuple[float, float, float] | None = None,
                      nodes: list[int] | None = None
                      ) -> list[DegradationEvent]:
    """Per-node gray-failure process over ``[0, horizon_s)``.

    Episodes arrive per node with exponential inter-arrival ``mtbd_s``
    (mean time between degradations) and last ``Exp(mttr_s)``; each
    draws a slowdown factor uniformly from ``slowdown``, or — with
    probability ``hang_p`` — hangs at ``hang_factor``.  A recovery
    event (``factor=1.0``) closes every episode that ends inside the
    horizon.  ``storm`` intensifies the hazard inside a window exactly
    like :func:`failure_storm` (thinned non-homogeneous Poisson), so
    the stream is fully determined by ``seed``."""
    _check_rates(horizon_s, mtbd_s=mtbd_s, mttr_s=mttr_s)
    _check_storm(storm, horizon_s)
    if nodes is not None and not nodes:
        raise ValueError("degradation_storm: nodes=[] would emit no "
                         "events; pass nodes=None to cover all n_nodes")
    if n_nodes <= 0 and nodes is None:
        raise ValueError(f"degradation_storm: n_nodes must be positive, "
                         f"got {n_nodes!r}")
    lo, hi = slowdown
    if not (1.0 < lo <= hi):
        raise ValueError(f"degradation_storm: slowdown bounds must "
                         f"satisfy 1 < lo <= hi, got {slowdown!r}")
    rng = np.random.default_rng(seed)
    node_ids = list(range(n_nodes)) if nodes is None else list(nodes)
    peak = storm[2] if storm else 1.0
    events: list[DegradationEvent] = []
    for nid in node_ids:
        t = 0.0
        while True:
            t += float(rng.exponential(mtbd_s / peak))
            if t >= horizon_s:
                break
            mult = peak if (storm and storm[0] <= t < storm[1]) else 1.0
            if rng.random() >= mult / peak:          # thinned candidate
                continue
            hang = rng.random() < hang_p
            factor = hang_factor if hang \
                else float(rng.uniform(lo, hi))
            events.append(DegradationEvent(
                t, nid, factor=factor, hang=hang,
                kind="hang" if hang else "degrade"))
            t += float(rng.exponential(mttr_s))
            if t < horizon_s:
                events.append(DegradationEvent(t, nid, factor=1.0,
                                               kind="recover"))
    events.sort(key=lambda e: (e.time, e.node, e.factor))
    return events


def _feasible_plans(profile, gpus: int, env: Env, allow_tp_pp: bool,
                    max_ga: int = 8) -> list[ExecutionPlan]:
    """Feasible plan skeletons at exactly ``gpus`` — one batched OOM mask
    over the shared plan table instead of a per-plan Python loop."""
    tbl = plan_table.get(profile.b, gpus, max_ga, allow_tp_pp=allow_tp_pp)
    ok = memory.feasible_mask(profile, tbl.cols, gpus, 12 * gpus, env)
    ok &= tbl.exact_mask(gpus)
    return [tbl.plans[i] for i in np.flatnonzero(ok)]


def generate(n_jobs: int = 60, hours: float = 12.0, seed: int = 0,
             variant: str = "base", env: Env | None = None,
             large_fraction: float | None = None,
             load_scale: float = 1.0,
             dur_cap_hours: float = 6.0,
             gpu_types: list[str] | None = None) -> list[Job]:
    """Returns jobs sorted by submit time.  ``load_scale`` compresses the
    arrival window (higher load); ``large_fraction`` overrides the share of
    LLaMA-class models (paper Fig 11); ``dur_cap_hours`` bounds the
    lognormal duration tail (Philly-scale traces raise it); ``gpu_types``
    restricts the hetero variant's pinnable GPU models to the types the
    target cluster actually has (a pin to an absent type can never be
    scheduled)."""
    env = env or Env()
    rng = np.random.default_rng(seed)
    oracle = AnalyticOracle(env=env)
    names = list(paper_models.TABLE2)
    jobs: list[Job] = []
    window = hours * 3600.0 / max(load_scale, 1e-6)
    # bursty arrivals: half the jobs in the busiest third of the window
    t_arr = np.sort(np.where(rng.random(n_jobs) < 0.5,
                             rng.uniform(0, window / 3, n_jobs),
                             rng.uniform(0, window, n_jobs)))
    for i in range(n_jobs):
        if large_fraction is not None:
            if rng.random() < large_fraction:
                name = rng.choice(list(paper_models.LARGE)[1:])   # llama class
            else:
                name = rng.choice(list(paper_models.SMALL))
        else:
            name = rng.choice(names)
        profile = paper_models.TABLE2[name]
        small = name in paper_models.SMALL
        gpus = int(rng.choice(GPU_SIZES, p=GPU_PROBS))
        # hetero pools: half the jobs pin a GPU model; plan feasibility
        # (and hence the initial-plan draw) uses that type's Env
        gpu_type = ""
        env_j = env
        if variant == "hetero" and rng.random() < 0.5:
            mix = [(t, p) for t, p in HETERO_MIX
                   if gpu_types is None or t in gpu_types]
            mix_p = np.array([p for _, p in mix])
            gpu_type = mix[int(rng.choice(len(mix),
                                          p=mix_p / mix_p.sum()))][0]
            env_j = env_for_gpu(gpu_type, env)
        # paper: "In case the original GPU number is infeasible for the
        # model, we use a feasible one" — keep GPU-hours constant.
        allow_tp_pp = not small                     # paper disables TP/PP
        plans = _feasible_plans(profile, gpus, env_j, allow_tp_pp)
        tries = 0
        while not plans and tries < 6:
            gpus = min(gpus * 2, 64)
            plans = _feasible_plans(profile, gpus, env_j, allow_tp_pp)
            tries += 1
        if not plans:
            continue
        if variant == "bp":
            tbl = plan_table.get(profile.b, gpus, 8, allow_tp_pp=allow_tp_pp)
            thpt = oracle.throughput_batch(profile, tbl, gpus, 12 * gpus)
            thpt = np.where(tbl.exact_mask(gpus), thpt, 0.0)
            plan = tbl.plans[int(thpt.argmax())]
        else:
            plan = plans[int(rng.integers(len(plans)))]
        # duration: lognormal hours → target iterations at the oracle rate
        dur = float(rng.lognormal(mean=math.log(1800), sigma=1.1))
        dur = min(max(dur, 120.0), dur_cap_hours * 3600.0)
        thpt = oracle.throughput(profile, plan, Alloc(gpus, 12 * gpus),
                                 env=env_j)
        if thpt <= 0:
            continue
        target_iters = max(10.0, dur * thpt / profile.b)
        tenant, guaranteed = "A", True
        if variant == "mt":
            tenant = "A" if rng.random() < 0.5 else "B"
            guaranteed = tenant == "A"
        jobs.append(Job(
            name=f"job{i:04d}-{name}", profile=profile,
            submit=float(t_arr[i]), target_iters=target_iters,
            req_gpus=gpus, req_cpus=12 * gpus, orig_plan=plan,
            guaranteed=guaranteed, tenant=tenant, gpu_type=gpu_type))
    return jobs


def philly(n_jobs: int = 500, hours: float = 24.0, seed: int = 0,
           variant: str = "hetero", env: Env | None = None,
           load_scale: float = 1.0,
           gpu_types: list[str] | None = None) -> list[Job]:
    """Production-shape trace for 256+ GPU cluster simulations: 500+ jobs,
    Philly long-tail durations (up to 24 h), hetero GPU mix by default."""
    return generate(n_jobs=n_jobs, hours=hours, seed=seed, variant=variant,
                    env=env, load_scale=load_scale, dur_cap_hours=24.0,
                    gpu_types=gpu_types)
