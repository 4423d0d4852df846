"""Throughput oracles: ``measure(profile, plan, alloc) -> T_iter`` seconds.

A copy of ``repro.core.oracle``'s analytic half (``true_params``,
``AnalyticOracle``, ``profiling_samples``, ``profiling_requests``), held
to the reference's outputs by ``tests/test_torch_perfmodel.py``: an
oracle with the performance model's own equations over hidden per-model
parameters, plan-family wiggles and measurement noise, standing in for
the paper's 64-GPU A800 cluster.  The reference's ``true_curve`` needs
its sensitivity curves, which the port does not have yet (ROADMAP A13b).

``TorchMicroOracle`` takes the place of the reference's
``JaxMicroOracle``: it times real train steps of the port on one device
(the card, or the CPU when asked), so the paper's profiling → fit →
predict loop runs against measured executions.
"""

from __future__ import annotations

import gc
import hashlib
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import memory
from repro_torch.core.perfmodel import (GPU_TYPES, Alloc, Env, FitParams, ModelProfile,
                                        env_for_gpu, predict_titer)
from repro_torch.parallel.plan import ExecutionPlan


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

    The reference's drift over simulated time and its batched
    ``measure_batch``/``throughput`` methods serve its simulator, which the
    port does not have yet (ROADMAP A13b); they come over with it."""
    env: Env = None
    noise: float = 0.01
    wiggle: float = 0.06          # plan-family efficiency deviation

    def __post_init__(self):
        self.env = self.env or Env()

    def measure(self, profile: ModelProfile, plan: ExecutionPlan,
                alloc: Alloc, seed: int = 0,
                env: Env | None = None, now: float = 0.0) -> float:
        """``env`` overrides the oracle's default environment (the
        per-GPU-type Env of the nodes hosting the job).  ``now`` is
        accepted for the interface's sake: this oracle does not drift."""
        env = env or self.env
        if not memory.feasible(profile, plan, alloc, env):
            return float("inf")
        t = predict_titer(profile, plan, alloc, env, true_params(profile.name))
        if not math.isfinite(t):
            return float("inf")
        # plan-family wiggle: the truth is not exactly the model's form
        w = 1.0 + self.wiggle * (2 * _unit_hash(
            profile.name, plan.strategy, alloc.gpus) - 1)
        rng = np.random.default_rng(
            int(_unit_hash(profile.name, plan, alloc, seed) * 2**31))
        noise = float(rng.lognormal(0.0, self.noise))
        return t * w * noise


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
        ``shape``, after one untimed step.  Plans with ``offload`` or
        ``zero_stage == 3`` run through ``compile_train_step`` on a
        one-device mesh (reusing an initialised process group), every other
        plan through ``make_train_step``, where GA acts; GC acts through
        the model's ``remat="full"``."""
        from repro_torch.models import ModelOpts, build
        from repro_torch.train.optimizer import OptConfig, opt_init
        from repro_torch.train.step import compile_train_step, make_train_step

        dev = self.device
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model = build(self.cfg, device=dev, seed=self.seed,
                      opts=ModelOpts(remat="full" if plan.gc else "none", loss_chunk=0))
        optcfg = OptConfig()
        if plan.offload or plan.zero_stage == 3:
            from repro_torch.launch.mesh import single_device_mesh

            step, _, _, _, params, opt_state = compile_train_step(
                model, plan, single_device_mesh(dev), optcfg, model.input_specs(shape))
        else:
            params = model.init()
            opt_state = opt_init(params, optcfg)
            step = make_train_step(model, plan, optcfg)
        batch = model.dummy_batch(shape)
        params, opt_state, _ = step(params, opt_state, batch)
        _sync(dev)
        times, losses = [], []
        for _ in range(self.steps):
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, batch)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
        self.last = {
            "step_s": times,
            "loss": [float(x) for x in losses],
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "pinned_host_bytes": _pinned_bytes(opt_state)}
        del model, params, opt_state, step, batch
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            _release_pinned_cache()
        return float(np.median(times))
