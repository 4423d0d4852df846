"""Checkpoints: the torch twin of ``repro.train.checkpoint``, in the same
layout, so a job restarts across frameworks in either direction.

Layout:  <dir>/step_<n:09d>/{arrays.npz, meta.json}

``arrays.npz`` holds the JAX package's flat keys: ``params/...`` and
``opt/...`` (``opt/count`` an int32 scalar, ``opt/m/...``, ``opt/v/...``),
every layer stacked on a leading axis, bfloat16 stored as uint16 under
``<key>::bf16`` (``repro_torch.convert`` does the restacking).  A step is
written into a temporary directory, ``meta.json`` through a temporary file
that is fsynced and renamed, then the directory is renamed into place and
the parent fsynced, so a crash leaves the previous step intact and never a
torn ``meta.json`` (``list_steps`` trusts a step only once it exists).
Saves run on a thread by default (``wait`` joins it); every leaf is copied
to the host before ``save`` returns, so the training loop may update the
params and moments in place while the thread writes.  An optional recorder (anything with
``span(name, t0, t1, step, **attrs)``, such as ``repro.obs``'s) gets a
``checkpoint-save`` and a ``checkpoint-restore`` span.

Checkpoints are plan-agnostic, as the reference's are: a sharded run
(``layout=`` the ``compile_train_step`` step's ``layout``) gathers every
leaf whole in the reference's layout on every rank, rank 0 writes it (and a
blocking save ends in a barrier), and a restore under any plan copies each
rank's pieces out of the whole leaves.  Moments in host memory are read
only after the device has finished writing them.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from time import perf_counter
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert

# The reference's restore-cost model (repro/core/memory.py: RESTORE_BANDWIDTH,
# RESTORE_OVERHEAD_S, restore_seconds), copied so both price a restart alike.
RESTORE_BANDWIDTH = 4e9       # bytes/s aggregate read from shared storage
RESTORE_OVERHEAD_S = 8.0      # process respawn + NCCL re-init floor


def restore_seconds(nbytes: float) -> float:
    """Seconds to restore ``nbytes`` of checkpoint state."""
    return nbytes / RESTORE_BANDWIDTH + RESTORE_OVERHEAD_S


def _state(params) -> dict[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, torch.nn.Module) else params


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3,
                 async_save: bool = True, recorder: Any | None = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self.recorder = recorder
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, params, opt_state: dict | None = None,
             meta: dict | None = None, block: bool = False, layout=None) -> Path:
        """Atomic save of params (an ``nn.Module`` or a state dict) and the
        optimizer state; async unless ``block``.  With a ``layout`` every rank
        calls it and rank 0 writes."""
        self.wait()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()    # offloaded moments: the copies out have landed
        target = self.dir / f"step_{step:09d}"
        if layout is not None:
            params = layout.full_params(params)
            if opt_state is not None:
                opt_state = layout.full_opt(opt_state)
            if layout.rank != 0:
                if block:
                    dist.barrier()
                return target
        arrays = convert.params_to_jax_numpy(_state(params), flat=True)
        if opt_state is not None:
            arrays.update(convert.opt_state_to_jax_numpy(opt_state, flat=True))
        meta = dict(meta or {})
        meta["step"] = step

        def _write():
            t0 = perf_counter()
            tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
            np.savez(tmp / "arrays.npz", **arrays)
            mtmp = tmp / ".meta.json.tmp"
            with open(mtmp, "w") as f:
                f.write(json.dumps(meta))
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, tmp / "meta.json")
            if target.exists():
                shutil.rmtree(target)
            os.replace(tmp, target)
            fd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            self._gc()
            if self.recorder is not None:
                nbytes = sum(a.nbytes for a in arrays.values())
                self.recorder.span("checkpoint-save", t0, perf_counter(),
                                   float(step), bytes=nbytes)

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            if layout is not None:
                dist.barrier()
        return target

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def restore_cost_estimate(params, opt_state: dict | None = None) -> float:
        """Seconds a restart from this state would cost: the bytes of every
        param and optimizer leaf (the count as an int32) through
        :func:`restore_seconds`."""
        tensors = list(_state(params).values())
        nbytes = 0
        if opt_state is not None:
            nbytes += 4
            for k in ("m", "v"):
                tensors += list(opt_state.get(k, {}).values())
        nbytes += sum(t.numel() * t.element_size() for t in tensors)
        return restore_seconds(float(nbytes))

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, params: torch.nn.Module, opt_state: dict | None = None,
                step: int | None = None, layout=None) -> tuple[torch.nn.Module, dict | None,
                                                               dict]:
        """Copy a step (the latest by default) into ``params`` (the model's
        module, whose ``cfg`` names the layout) and ``opt_state``, in place,
        on their devices and in their dtypes; with a ``layout``, this rank's
        pieces of each leaf.  Returns (params, opt_state, meta)."""
        t0 = perf_counter()
        self.wait()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()    # offloaded moments: no copy is still in flight
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        arrays = dict(np.load(d / "arrays.npz"))
        meta = json.loads((d / "meta.json").read_text())
        cfg = params.cfg
        state = convert.params_from_jax_numpy(arrays, cfg)
        if layout is None:
            params.load_state_dict(state, strict=True)
        else:
            layout.load_params(params, state)
        if opt_state is not None:
            saved = convert.opt_state_from_jax_numpy(arrays, cfg)
            for k in ("m", "v"):
                if (k in saved) != (k in opt_state):
                    raise KeyError(f"checkpoint and optimizer disagree on moment {k!r}")
                for name, t in opt_state.get(k, {}).items():
                    whole = saved[k][name]
                    t.copy_(whole if layout is None else layout.opt_piece(name, whole))
            opt_state["count"] = saved["count"]
        if self.recorder is not None:
            self.recorder.span("checkpoint-restore", t0, perf_counter(), float(step))
        return params, opt_state, meta
