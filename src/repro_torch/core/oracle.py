"""Throughput oracles: ``measure(profile, plan, alloc) -> T_iter`` seconds.

A copy of ``repro.core.oracle``'s analytic half (``true_params``,
``AnalyticOracle`` with its drift and batched methods, ``true_curve``,
``profiling_samples``, ``profiling_requests``), held to the reference's
outputs by ``tests/test_torch_perfmodel.py`` and
``tests/test_torch_sched.py``: an oracle with the performance model's own
equations over hidden per-model parameters, plan-family wiggles and
measurement noise, standing in for the paper's 64-GPU A800 cluster.

``TorchMicroOracle`` takes the place of the reference's
``JaxMicroOracle``: it times real train steps of the port on one device
(the card, or the CPU when asked), so the paper's profiling → fit →
predict → schedule loop runs against measured executions.
``build_train_step`` is the step it times, which ``chip_smoke.py``'s
``schedule`` phase also runs to execute a scheduler's plan change.
"""

from __future__ import annotations

import gc
import hashlib
import math
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import memory
from repro_torch.core.perfmodel import (_BOUNDS, GPU_TYPES, Alloc, Env, FitParams,
                                        ModelProfile, env_for_gpu, predict_titer,
                                        predict_titer_batch)
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.parallel.plan_table import PlanTable


def _unit_hash(*keys) -> float:
    h = hashlib.sha256("|".join(str(k) for k in keys).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


def true_params(model_name: str) -> FitParams:
    """Deterministic hidden truth per model type."""
    u = lambda key, lo, hi: lo + (hi - lo) * _unit_hash(model_name, key)
    return FitParams(
        k_bwd=u("bwd", 1.7, 2.4),
        k_sync=u("sync", 1.5, 8.0),
        k_opt=10 ** u("opt", -11.5, -10.5),
        # CPU-side Adam is slow enough to dominate PCIe transfer (the paper's
        # Fig 7 observation: doubling CPUs under ZeRO-Offload gives ~1.7×)
        k_opt_off=10 ** u("optoff", -9.4, -8.9),
        k_off=u("off", 1.5, 8.0),
        k_swap=u("swap", 1.5, 8.0),
        k_const=u("const", 0.002, 0.05),
    )


@dataclass
class AnalyticOracle:
    """measure(profile, plan, alloc) -> T_iter seconds (or inf if OOM).

    ``drifting=True`` slowly perturbs the hidden true params over
    SIMULATED time (``now``): each of the 7 params follows its own
    deterministic log-space direction, saturating at
    ``exp(±drift_scale)`` with time constant ``drift_tau`` — so a model
    fitted from the t=0 profile grows stale, and online calibration has
    something real to catch.  The drifted truth is clamped to
    ``perfmodel._BOUNDS`` so a refit can always reach it (tanh
    saturation alone is not enough: a hash draw near a bound edge with
    an outward drift direction would escape)."""
    env: Env = None
    noise: float = 0.01
    wiggle: float = 0.06          # plan-family efficiency deviation
    drifting: bool = False
    drift_scale: float = 0.6      # log-space drift amplitude at saturation
    drift_tau: float = 43200.0    # drift time constant, seconds (12 h)

    def __post_init__(self):
        self.env = self.env or Env()

    def true_params_at(self, model_name: str, now: float = 0.0) -> FitParams:
        """Hidden truth at simulated time ``now`` (= ``true_params`` at
        t=0 or when drifting is off)."""
        k = true_params(model_name)
        if not self.drifting or now <= 0.0:
            return k
        v = k.as_vector()
        dirs = np.array([2.0 * _unit_hash(model_name, "drift", i) - 1.0
                         for i in range(v.size)])
        v = v * np.exp(self.drift_scale * dirs * math.tanh(now /
                                                           self.drift_tau))
        v = np.clip(v, [b[0] for b in _BOUNDS], [b[1] for b in _BOUNDS])
        return FitParams.from_vector(v)

    def measure(self, profile: ModelProfile, plan: ExecutionPlan,
                alloc: Alloc, seed: int = 0,
                env: Env | None = None, now: float = 0.0) -> float:
        """``env`` overrides the oracle's default environment (the
        per-GPU-type Env of the nodes hosting the job).  ``now`` selects
        the drifted truth on drifting oracles (ignored otherwise)."""
        env = env or self.env
        if not memory.feasible(profile, plan, alloc, env):
            return float("inf")
        k = self.true_params_at(profile.name, now)
        t = predict_titer(profile, plan, alloc, env, k)
        if not math.isfinite(t):
            return float("inf")
        # plan-family wiggle: the truth is not exactly the model's form
        w = 1.0 + self.wiggle * (2 * _unit_hash(
            profile.name, plan.strategy, alloc.gpus) - 1)
        rng = np.random.default_rng(
            int(_unit_hash(profile.name, plan, alloc, seed) * 2**31))
        noise = float(rng.lognormal(0.0, self.noise))
        return t * w * noise

    def throughput(self, profile, plan, alloc, seed: int = 0,
                   env: Env | None = None, now: float = 0.0) -> float:
        t = self.measure(profile, plan, alloc, seed, env=env, now=now)
        return profile.b / t if math.isfinite(t) and t > 0 else 0.0

    # ------------------------------------------------------------------
    def measure_batch(self, profile: ModelProfile, table: PlanTable,
                      gpus: int, cpus: int, seed: int = 0) -> np.ndarray:
        """T_iter for every table row at one allocation (inf where OOM) —
        vectorized core prediction; the per-row wiggle/noise hashing stays
        scalar (cheap) so values match ``measure`` row-for-row."""
        g = np.asarray([gpus])
        c = np.asarray([float(cpus)])
        cols = table.cols.expand()
        feas = memory.feasible_mask(profile, cols, g, c, self.env)[:, 0]
        t = predict_titer_batch(profile, cols, g, c, self.env,
                                true_params(profile.name))[:, 0]
        out = np.full(len(table), np.inf)
        alloc = Alloc(gpus, cpus)
        for i in np.flatnonzero(feas & np.isfinite(t)):
            w = 1.0 + self.wiggle * (2 * _unit_hash(
                profile.name, table.strategies[i], alloc.gpus) - 1)
            rng = np.random.default_rng(int(_unit_hash(
                profile.name, table.plans[i], alloc, seed) * 2**31))
            out[i] = t[i] * w * float(rng.lognormal(0.0, self.noise))
        return out

    def throughput_batch(self, profile: ModelProfile, table: PlanTable,
                         gpus: int, cpus: int, seed: int = 0) -> np.ndarray:
        t = self.measure_batch(profile, table, gpus, cpus, seed)
        ok = np.isfinite(t) & (t > 0)
        return np.where(ok, profile.b / np.where(ok, t, 1.0), 0.0)


def true_curve(profile: ModelProfile, env: Env | None = None,
               max_gpus: int = 64, cpus_per_gpu: int = 12, max_ga: int = 8):
    """The GROUND-TRUTH sensitivity curve (hidden params, no wiggle/noise)
    — shares the process-wide CurveCache with the scheduler stack, so
    comparisons of predicted and true envelopes enumerate the plan space
    once."""
    from repro_torch.core.sensitivity import get_curve
    return get_curve(profile, true_params(profile.name), env or Env(),
                     max_gpus=max_gpus, cpus_per_gpu=cpus_per_gpu,
                     max_ga=max_ga)


PROFILE_SET = "paper Sec 4.3: ≥7 points, ≥3 with ZeRO-Offload"


def profiling_samples(profile: ModelProfile, oracle: AnalyticOracle,
                      max_gpus: int = 8,
                      ) -> list[tuple[ExecutionPlan, Alloc, float]]:
    """The minimum profiling set (7 points, 3 with offload) the paper uses,
    restricted to plans feasible at ≤ max_gpus."""
    cands: list[tuple[ExecutionPlan, Alloc]] = []
    g_hi = max_gpus
    g_mid = max(2, max_gpus // 2)
    cpus = lambda g: 12 * g
    cands += [
        (ExecutionPlan(dp=g_hi, zero_stage=1), Alloc(g_hi, cpus(g_hi))),
        (ExecutionPlan(dp=g_mid, ga_steps=2), Alloc(g_mid, cpus(g_mid))),
        (ExecutionPlan(dp=g_hi, zero_stage=3, gc=True), Alloc(g_hi, cpus(g_hi))),
        (ExecutionPlan(dp=1, tp=min(4, g_mid)), Alloc(min(4, g_mid),
                                                      cpus(min(4, g_mid)))),
        (ExecutionPlan(dp=g_hi, zero_stage=1, offload=True),
         Alloc(g_hi, cpus(g_hi))),
        (ExecutionPlan(dp=g_mid, zero_stage=1, offload=True, ga_steps=2),
         Alloc(g_mid, cpus(g_mid))),
        (ExecutionPlan(dp=1, zero_stage=1, offload=True, gc=True),
         Alloc(1, 12)),
    ]
    out = []
    for plan, alloc in cands:
        if profile.b % (plan.dp * max(plan.ga_steps, 1)):
            continue
        t = oracle.measure(profile, plan, alloc)
        if math.isfinite(t):
            out.append((plan, alloc, t))
    return out


def profiling_requests(profiles, oracle: AnalyticOracle,
                       env: Env | None = None, max_gpus: int = 8):
    """Profile each model type and package the fit inputs for ONE
    ``repro_torch.core.fitting.fit_batch`` call — the shared cold-start entry
    point (in the reference, ``Simulator`` pre-fits every cache-missed
    model type of a trace this way, and ``benchmarks._artifacts``
    pre-warms the Table-2 cache the same way).

    Returns ``(requests, skipped)``: one ``FitRequest`` per profile with
    enough feasible profiling samples, and ``(profile, samples)`` for
    the rest (< 4 points — the project-wide fit floor; callers fall back
    to default ``FitParams`` and surface the type as uncalibrated — the
    collected samples ride along so no caller re-profiles)."""
    from repro_torch.core.fitting import FitRequest
    env = env or oracle.env
    requests, skipped = [], []
    for profile in profiles:
        samples = profiling_samples(profile, oracle, max_gpus=max_gpus)
        if len(samples) >= 4:
            requests.append(FitRequest(profile=profile,
                                       samples=tuple(samples), env=env))
        else:
            skipped.append((profile, samples))
    return requests, skipped


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _release_pinned_cache() -> None:
    """Return the freed pinned host blocks that PyTorch's host allocator
    keeps cached (each offload plan pins its moments anew)."""
    release = (getattr(getattr(torch, "accelerator", None), "empty_host_cache", None)
               or getattr(torch._C, "_host_emptyCache", None))
    if release is None:
        raise RuntimeError(f"torch {torch.__version__} has neither "
                           "torch.accelerator.empty_host_cache nor "
                           "torch._C._host_emptyCache: freed pinned host blocks "
                           "cannot be returned between plans")
    release()


def _device_env(device: torch.device) -> Env | None:
    """The ``GPU_TYPES`` entry whose name the card's name holds (``h100``
    for an NVIDIA H100), or None: the CPU and unlisted cards have none."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    hits = [key for key in GPU_TYPES if key in name]
    return env_for_gpu(hits[0]) if len(hits) == 1 else None


def _pinned_bytes(opt_state: dict) -> int:
    """Bytes of the pinned host blocks that hold the moments (0 when the
    moments are on the device)."""
    blocks = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
              for k in ("m", "v") for t in opt_state.get(k, {}).values()
              if t.device.type == "cpu" and t.is_pinned()}
    return sum(blocks.values())


class TorchMicroOracle:
    """Measures real wall-clock train steps of the port, with the
    ``measure()`` interface of ``AnalyticOracle``.

    On construction it times ``make_train_step(model, ExecutionPlan(),
    OptConfig())`` at ``batch`` × ``seq``, as the reference's
    ``JaxMicroOracle`` does: one untimed step (the kernels' build and the
    allocator's warm-up; the reference compiles there), then the median
    of ``steps`` timed steps is ``t_step``.  The time is the host clock
    around a step that ends in a device synchronize: T_iter is the wall
    time of an iteration, host included (``k_const`` absorbs the host's
    part).

    ``measure`` times one plan the same way at the profile's global batch
    and sequence on this one device.  Each run frees the model, gradients
    and optimizer state it made (pinned host blocks too) before it
    returns, and leaves its step times, peak device bytes and pinned host
    bytes in ``last``, with the losses of the timed steps.  ``device``
    defaults to ``cuda`` and raises with no card unless it is ``"cpu"``.
    ``env`` is the memory model's environment for ``measure``; by default
    the ``GPU_TYPES`` entry of the card (``h100`` on an H100), and none on
    the CPU or an unlisted card, where ``measure`` then needs one.
    """

    def __init__(self, cfg, batch: int = 4, seq: int = 64, steps: int = 3, *,
                 device="cuda", seed: int = 0, env: Env | None = None):
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.models.api import resolve_device

        self.cfg = cfg
        self.steps = steps
        self.seed = seed
        self.device = resolve_device(device)
        self.env = env or _device_env(self.device)
        self.last: dict = {}
        # after_steps(plan, run, batch, times), when set, sees each run after
        # its timed steps and before it is freed (a caller counting one
        # more step of it).
        self.after_steps = None
        self.t_step = self._time(ExecutionPlan(), ShapeConfig("micro", seq, batch, "train"))
        self.tokens = batch * seq

    def t_fwd_unit(self, k_bwd: float = 2.0) -> float:
        """Back out per-token fwd time from the measured full step."""
        return self.t_step / (self.tokens * (1 + k_bwd + 0.2))

    def measure(self, profile: ModelProfile, plan: ExecutionPlan,
                alloc: Alloc, seed: int = 0, env: Env | None = None,
                now: float = 0.0) -> float:
        """T_iter seconds of ``plan`` at the profile's ``b`` × ``s`` on this
        device; ``inf`` where the memory model (``env``, by default the
        oracle's) calls the plan infeasible.  ``seed`` and ``now`` are
        accepted and ignored: a real device has no hidden truth to draw
        noise from or to drift.  Multi-device plans and allocations raise
        ``NotImplementedError``: one process times one device.  An
        out-of-memory error of a plan the memory model calls feasible
        propagates."""
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.train.step import check_plan

        if profile.name != self.cfg.name:
            raise ValueError(f"this oracle times {self.cfg.name}, not {profile.name}")
        if plan.n_gpus > 1 or alloc.gpus > 1:
            raise NotImplementedError(
                f"{plan.strategy} on {alloc.gpus} GPU(s): one process times one "
                f"device; multi-card plans are ROADMAP A14b")
        env = env or self.env
        if env is None:
            raise ValueError(f"no memory model for {self.device}: give the oracle or "
                             f"measure an env")
        if not memory.feasible(profile, plan, alloc, env):
            return float("inf")
        check_plan(self.cfg, plan)
        return self._time(plan, ShapeConfig("profile", profile.s, profile.b, "train"))

    def _time(self, plan: ExecutionPlan, shape) -> float:
        """The median wall seconds of ``self.steps`` steps of ``plan`` at
        ``shape`` (``build_train_step``, ``run_steps``), after one untimed
        step; every tensor the run made is freed before it returns."""
        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        run = build_train_step(self.cfg, plan, shape, dev, seed=self.seed)
        batch = run.model.dummy_batch(shape)
        times, losses = run_steps(run, batch, self.steps)
        self.last = {
            "step_s": times,
            "loss": losses,
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "pinned_host_bytes": _pinned_bytes(run.opt_state)}
        if self.after_steps is not None:
            self.after_steps(plan, run, batch, times)
        run.release()
        return float(np.median(times))


@dataclass
class TrainRun:
    """One model laid out for one plan on one device, with its train step
    (``build_train_step``).  ``layout`` is the ``compile_train_step``
    layout, or None for a ``make_train_step`` run."""
    model: Any
    plan: ExecutionPlan
    step: Any
    params: Any
    opt_state: dict | None

    @property
    def layout(self):
        return getattr(self.step, "layout", None)

    def whole_state(self) -> dict[str, Any]:
        """Every parameter (``params/<name>``) and moment (``m/<name>``,
        ``v/<name>``) whole, in the reference's layout, and the step count
        (``count``): the state a checkpoint holds."""
        lay = self.layout
        if lay is None:
            params, opt = dict(self.params.named_parameters()), self.opt_state
        else:
            params, opt = lay.full_params(self.params), lay.full_opt(self.opt_state)
        out = {f"params/{n}": t.detach() for n, t in params.items()}
        for k in ("m", "v"):
            out.update((f"{k}/{n}", t) for n, t in opt.get(k, {}).items())
        out["count"] = int(opt["count"])
        return out

    def release(self) -> None:
        """Drop the model, step, params and optimizer state, and return the
        memory they held (the device's cache, pinned host blocks too)."""
        dev = self.model.device
        self.model = self.step = self.params = self.opt_state = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            _release_pinned_cache()


def build_train_step(cfg, plan: ExecutionPlan, shape, device, seed: int = 0) -> TrainRun:
    """A fresh model of ``cfg`` (weights from ``seed``) laid out for
    ``plan`` at ``shape`` on one device, with its optimizer state
    (``OptConfig()``).  Plans with ``offload`` or ``zero_stage == 3`` run
    through ``compile_train_step`` on a one-device mesh (reusing an
    initialised process group), every other plan through
    ``make_train_step``, where GA acts; GC acts through the model's
    ``remat="full"``.  ``TorchMicroOracle`` times this step, and
    ``chip_smoke.py``'s ``schedule`` phase runs it under a scheduler's
    plans."""
    from repro_torch.models import ModelOpts, build
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.step import compile_train_step, make_train_step

    model = build(cfg, device=device, seed=seed,
                  opts=ModelOpts(remat="full" if plan.gc else "none", loss_chunk=0))
    optcfg = OptConfig()
    if plan.offload or plan.zero_stage == 3:
        from repro_torch.launch.mesh import single_device_mesh

        step, _, _, _, params, opt_state = compile_train_step(
            model, plan, single_device_mesh(model.device), optcfg, model.input_specs(shape))
    else:
        params = model.init()
        opt_state = opt_init(params, optcfg)
        step = make_train_step(model, plan, optcfg)
    return TrainRun(model, plan, step, params, opt_state)


def run_steps(run: TrainRun, batch: dict, steps: int,
              warmup: int = 1) -> tuple[list[float], list[float]]:
    """``warmup`` untimed steps, then ``steps`` steps each timed by the host
    clock around a step that ends in a device synchronize: (seconds,
    losses) of the timed ones."""
    dev = run.model.device
    for _ in range(warmup):
        run.params, run.opt_state, _ = run.step(run.params, run.opt_state, batch)
    _sync(dev)
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        run.params, run.opt_state, metrics = run.step(run.params, run.opt_state, batch)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    return times, [float(x) for x in losses]


def reconfigure(run: TrainRun, plan: ExecutionPlan, shape, directory, step: int,
                seed: int = 0) -> tuple[TrainRun, dict]:
    """Rubick's reconfiguration mechanism (paper Sec 5.2, checkpoint and
    restart): save ``run`` as checkpoint ``step`` into ``directory``
    (``CheckpointManager``, blocking), release it (``run`` is left empty),
    build ``plan``'s run (``build_train_step``) and restore the checkpoint
    into it.  Returns the new run and ``{"save_s", "restore_s",
    "checkpoint_bytes", "differ"}``: ``restore_s`` covers the build and the
    restore, and ``differ`` names every parameter and moment (and the step
    count) whose restored value is not bit-equal to the one saved.  The
    saved state is held on the host for that check (a copy of the
    parameters and of moments on the device; host moments by reference)."""
    from repro_torch.train.checkpoint import CheckpointManager

    dev = run.model.device
    cfg = run.model.cfg
    saved = {k: (v.to("cpu", copy=True) if isinstance(v, torch.Tensor) and v.device.type != "cpu"
                 else v) for k, v in run.whole_state().items()}
    ckpt = CheckpointManager(directory, keep_last=1, async_save=False)
    t0 = time.perf_counter()
    target = ckpt.save(step, run.params, run.opt_state, block=True, layout=run.layout)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in target.iterdir())
    run.release()
    t0 = time.perf_counter()
    new = build_train_step(cfg, plan, shape, dev, seed=seed)
    ckpt.restore(new.params, new.opt_state, step=step, layout=new.layout)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    got = new.whole_state()
    differ = sorted(k for k in saved.keys() | got.keys()
                    if k not in saved or k not in got or not _bit_equal(saved[k], got[k]))
    return new, {"save_s": save_s, "restore_s": restore_s, "checkpoint_bytes": nbytes,
                 "differ": differ}


def _bit_equal(a, b) -> bool:
    """Same dtype, shape and bytes (signed zeros and NaNs told apart)."""
    if not isinstance(a, torch.Tensor):
        return a == b
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))
