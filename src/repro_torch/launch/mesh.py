"""Device meshes for a (dp × tp) job: the torch twin of
``repro.launch.mesh`` (``make_mesh``, ``single_device_mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dims
``("data", "model")``, or ``("pod", "data", "model")`` when ``pods > 1``,
over ranks laid out row-major (rank = (pod·dp + data)·tp + model).  The
process group's backend follows the device: NCCL on ``cuda`` (each rank on
the card ``LOCAL_RANK`` names, or its rank), gloo on ``cpu``.  The default
device is ``cuda``, as every entry point of the port has; nothing picks the
CPU because no card is present.

Without a process group, ``make_mesh`` starts one from the environment
``torchrun`` sets (``env://``), and ``single_device_mesh`` starts a
one-rank group on an in-process store.  A group of the other backend, or a
world of another size than the mesh, raises: every rank sits in the mesh.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.api import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device) -> tuple[torch.device, str]:
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"meshes run on cuda or cpu, not {dev.type}")
    return dev, BACKENDS[dev.type]


def _checked_group(dev: torch.device, backend: str, n: int) -> None:
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"the process group runs {have}; a {dev.type} mesh needs {backend}")
    ws = dist.get_world_size()
    if ws < n:
        raise ValueError(f"need {n} ranks, have {ws}")
    if ws > n:
        raise ValueError(f"the mesh holds {n} ranks but the world has {ws}: every rank "
                         f"must sit in the mesh")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {dist.get_rank()} wants card {local}, but "
                               f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(local)


def make_mesh(dp: int, tp: int, pods: int = 1, device="cuda") -> DeviceMesh:
    """Mesh for an arbitrary (dp × tp) job (Rubick jobs run at 1–64 GPUs)."""
    dev, backend = _backend(device)
    if not dist.is_initialized():
        dist.init_process_group(backend)
    n = dp * tp * pods
    _checked_group(dev, backend, n)
    if pods > 1:
        shape, names = (pods, dp, tp), ("pod", "data", "model")
    else:
        shape, names = (dp, tp), ("data", "model")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def single_device_mesh(device="cuda") -> DeviceMesh:
    """The 1 × 1 mesh of a one-card (or one-CPU) job."""
    dev, backend = _backend(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh(1, 1, device=dev)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{axis: size}`` of a mesh, in its dim order (what
    ``repro_torch.parallel.sharding`` takes)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
