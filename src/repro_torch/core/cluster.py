"""Cluster / job state shared by the Rubick scheduler, baselines, and the
simulator (paper Sec 5 + 7.3 + 7.4).

A copy of ``repro.core.cluster`` for the port, held to the reference's
outputs by ``tests/test_torch_sched.py``.  The simulator, baselines and
flight recorder named below are the port's copies (``core/simulator.py``,
``core/baselines.py``, ``obs/``).

Clusters may be heterogeneous: every node carries a ``gpu_model`` tag, and
``Cluster.envs`` maps each tag to the per-type ``Env`` (bandwidth tiers,
device memory, compute rate — see ``perfmodel.GPU_TYPES``).  A homogeneous
cluster has an empty ``envs`` dict and a single anonymous type group, so
schedulers written against type groups behave exactly as before.

Capacity is dynamic (failure & elasticity engine): every node carries an
``up`` flag flipped by fault-injection / spot-capacity events
(``trace.CapacityEvent`` applied by the simulator).  A down node offers
zero free resources (``Node.free``) and may hold no placements
(``check_capacity``).  ``spot`` marks preemptible nodes — created down
via ``add_spot_nodes`` and brought up/revoked by the spot process.  Node
GEOMETRY stays static for the whole run (``total_gpus`` keys curve
envelopes and grow targets); ``live_gpus`` is the current capacity."""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.perfmodel import (Alloc, Env, FitParams, ModelProfile,
                                  env_for_gpu)
from repro_torch.parallel.plan import ExecutionPlan


@dataclass
class Node:
    id: int
    gpus: int = 8
    cpus: int = 96
    mem: float = 1600e9
    gpu_model: str = ""              # "" = the cluster's default type
    up: bool = True                  # flipped by capacity events mid-run
    spot: bool = False               # preemptible (spot-arrive/spot-revoke)

    def free(self, used: dict[int, tuple[int, int, float]]) -> tuple[int, int, float]:
        if not self.up:
            return 0, 0, 0.0
        g = c = 0
        m = 0.0
        if self.id in used:
            g, c, m = used[self.id]
        return self.gpus - g, self.cpus - c, self.mem - m


@dataclass
class Cluster:
    n_nodes: int = 8
    gpus_per_node: int = 8
    cpus_per_node: int = 96
    mem_per_node: float = 1600e9
    envs: dict[str, Env] = field(default_factory=dict)

    def __post_init__(self):
        self.nodes = [Node(i, self.gpus_per_node, self.cpus_per_node,
                           self.mem_per_node) for i in range(self.n_nodes)]
        self._groups: dict[str, list[Node]] | None = None
        self._total_gpus: int | None = None

    @property
    def total_gpus(self) -> int:
        if self._total_gpus is None:
            self._total_gpus = sum(n.gpus for n in self.nodes)
        return self._total_gpus

    @property
    def live_gpus(self) -> int:
        """GPUs on up nodes right now (``total_gpus`` is static geometry)."""
        return sum(n.gpus for n in self.nodes if n.up)

    @property
    def is_hetero(self) -> bool:
        return bool(self.envs)

    def add_spot_nodes(self, n: int, gpus_per_node: int | None = None,
                       gpu_model: str = "") -> list[int]:
        """Append ``n`` preemptible nodes (initially DOWN — a spot-arrive
        event brings each up).  Must be called before the first scheduler
        pass: node ids stay dense and geometry is frozen afterwards.
        Returns the new node ids (feed them to ``trace.spot_churn``)."""
        ids = []
        for _ in range(n):
            nid = len(self.nodes)
            self.nodes.append(Node(nid, gpus_per_node or self.gpus_per_node,
                                   self.cpus_per_node, self.mem_per_node,
                                   gpu_model=gpu_model, up=False, spot=True))
            ids.append(nid)
        if gpu_model and gpu_model not in self.envs:
            self.envs[gpu_model] = env_for_gpu(gpu_model)
        self._groups = None
        self._total_gpus = None
        return ids

    def env_for(self, nid: int, default: Env | None = None) -> Env | None:
        """Per-type Env of one node (``default`` for untagged nodes)."""
        return self.envs.get(self.nodes[nid].gpu_model, default)

    def type_groups(self) -> dict[str, list[Node]]:
        """Nodes bucketed by GPU model, insertion-ordered (cached — node
        geometry is fixed after construction).  Homogeneous clusters yield
        one anonymous group containing every node."""
        if self._groups is None:
            groups: dict[str, list[Node]] = {}
            for node in self.nodes:
                groups.setdefault(node.gpu_model, []).append(node)
            self._groups = groups
        return self._groups


def hetero_cluster(spec: list[tuple[str, int]], gpus_per_node: int = 8,
                   cpus_per_node: int = 96, mem_per_node: float = 1600e9,
                   base_env: Env | None = None) -> Cluster:
    """Build a mixed-GPU cluster from ``[(gpu_model, n_nodes), ...]``.

    Node ids stay dense (id == index) so placements keep indexing
    ``cluster.nodes`` directly; ``cluster.envs`` gets one per-type Env
    derived from ``base_env`` via ``perfmodel.GPU_TYPES``."""
    n_total = sum(n for _, n in spec)
    cluster = Cluster(n_nodes=n_total, gpus_per_node=gpus_per_node,
                      cpus_per_node=cpus_per_node, mem_per_node=mem_per_node)
    nid = 0
    for gpu_model, n in spec:
        cluster.envs[gpu_model] = env_for_gpu(gpu_model, base_env)
        for _ in range(n):
            cluster.nodes[nid].gpu_model = gpu_model
            nid += 1
    cluster._groups = None               # retag invalidates the group cache
    return cluster


@dataclass
class Job:
    """A training job as submitted (paper Sec 2.1: gang request +
    user-chosen static plan)."""
    name: str
    profile: ModelProfile
    submit: float
    target_iters: float                  # work in iterations of batch b
    req_gpus: int
    req_cpus: int
    orig_plan: ExecutionPlan
    guaranteed: bool = True
    tenant: str = "A"
    gpu_type: str = ""               # hetero traces: required GPU model
                                     # ("" = schedulable on any type)


# placement: node id -> (gpus, cpus, mem)
Placement = dict[int, tuple[int, int, float]]


@dataclass
class SchedEvents:
    """What changed since the scheduler's previous pass.

    The event-driven simulator hands the scheduler an event-scoped dirty
    set — which jobs arrived, which completed (with the placement they
    freed, captured before the engine clears it), and which had their
    fitted params replaced by an online calibration refit (with the
    RETIRED params, whose identity keys the stale cache entries) — so an
    incremental pass engine can update its persistent indices instead of
    rebuilding them from every active job.  ``None`` (or simply not
    passing events) means "unknown delta": incremental engines must
    rebuild from scratch."""
    arrived: "list[JobState]" = field(default_factory=list)
    completed: "list[tuple[JobState, Placement]]" = field(default_factory=list)
    # (job with js.fitted already swapped to the NEW params, old params)
    refit: "list[tuple[JobState, FitParams]]" = field(default_factory=list)
    # capacity deltas (failure & elasticity engine): node ids that went
    # down / came up since the last pass, and capacity-loss victims with
    # their PRE-loss placement (the engine has already run the recovery
    # policy: js.placement is the surviving remainder, or {} if killed)
    node_down: "list[int]" = field(default_factory=list)
    node_up: "list[int]" = field(default_factory=list)
    evicted: "list[tuple[JobState, Placement]]" = field(default_factory=list)
    # gray-failure deltas: nodes the health monitor quarantined /
    # released since the last pass (capacity-style node bumps), jobs
    # migrated away from a quarantined node (pre-migration placement,
    # evicted-style delta folding), and jobs whose elective reconfig
    # exhausted its retry budget and rolled back to the prior committed
    # plan (pre-rollback placement — the one the failed pass installed)
    quarantined: "list[int]" = field(default_factory=list)
    released: "list[int]" = field(default_factory=list)
    migrated: "list[tuple[JobState, Placement]]" = field(default_factory=list)
    rolled_back: "list[tuple[JobState, Placement]]" = field(default_factory=list)


@dataclass
class JobState:
    job: Job
    status: str = "queued"               # queued | running | done
    plan: ExecutionPlan | None = None
    alloc: Alloc | None = None
    placement: Placement = field(default_factory=dict)
    fitted: FitParams | None = None
    progress: float = 0.0                # iterations completed
    n_reconfig: int = 0
    start_time: float | None = None
    finish_time: float | None = None
    run_time: float = 0.0                # aggregated running seconds
    min_res: tuple[int, int] | None = None   # (gpus, cpus) minRes
    baseline_perf: float = 0.0           # samples/s with requested+orig plan
    pause_until: float = 0.0             # checkpoint-resume pause deadline
    ckpt_progress: float = 0.0           # iterations safely checkpointed
    needs_restore: bool = False          # next start must pay a restore pause

    @property
    def total_gpus(self) -> int:
        t = 0
        for v in self.placement.values():
            t += v[0]
        return t

    @property
    def total_cpus(self) -> int:
        t = 0
        for v in self.placement.values():
            t += v[1]
        return t

    def gpus_per_node_tuple(self) -> tuple[int, ...]:
        return tuple(sorted((g for g, _, _ in self.placement.values()
                             if g > 0), reverse=True))

    def jct(self) -> float | None:
        if self.finish_time is None:
            return None
        return self.finish_time - self.job.submit


def used_per_node(jobs: list[JobState]) -> dict[int, tuple[int, int, float]]:
    used: dict[int, list[float]] = {}
    for js in jobs:
        for nid, (g, c, m) in js.placement.items():
            u = used.setdefault(nid, [0, 0, 0.0])
            u[0] += g
            u[1] += c
            u[2] += m
    return {k: (int(v[0]), int(v[1]), v[2]) for k, v in used.items()}


def state_digest(cluster: Cluster,
                 active: list[JobState]) -> list[int]:
    """Compact cluster-state fingerprint ``[n_running, n_queued,
    used_gpus, live_gpus]`` stamped onto flight-recorder decision events
    (``repro.obs``) so every trace line says what the cluster looked
    like when the decision was taken."""
    n_run = n_q = used_g = 0
    for s in active:
        if s.status == "running":
            n_run += 1
            used_g += s.total_gpus
        elif s.status == "queued":
            n_q += 1
    return [n_run, n_q, used_g, cluster.live_gpus]


def check_capacity(cluster: Cluster, jobs: list[JobState]) -> bool:
    """Invariant: no node over-allocated (property-tested)."""
    used = used_per_node(jobs)
    for node in cluster.nodes:
        g, c, m = used.get(node.id, (0, 0, 0.0))
        if g > node.gpus or c > node.cpus or m > node.mem + 1e-3:
            return False
        if not node.up and (g > 0 or c > 0 or m > 1e-3):
            return False
    return True
