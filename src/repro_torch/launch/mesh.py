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

``make_production_mesh`` is the twin of the reference's: the 16 x 16
("data", "model") or 2 x 16 x 16 ("pod", "data", "model") mesh, here on a
fake process group (torch's in-tree ``"fake"`` backend, ``FakeStore``) of
256 or 512 ranks held by this one process as rank 0: its collectives move
nothing, so a dry run counts one rank's step without a cluster.
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


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(multi_pod: bool = False, device="cpu") -> DeviceMesh:
    """The production mesh, 16 x 16 (256 chips) or 2 x 16 x 16 (512), on a
    fake process group of that many ranks, this process rank 0."""
    shape, names = PRODUCTION[bool(multi_pod)]
    return make_fake_mesh(shape, names, device=device)


def make_fake_mesh(shape: tuple[int, ...], names: tuple[str, ...], device="cpu") -> DeviceMesh:
    """A mesh of ``shape`` on a fake process group of as many ranks, this
    process rank 0.  A fake group of another size is replaced; any other
    group raises (a real world is never torn down).  ``FakeStore`` comes
    from torch's testing package (checked against torch 2.11 and 2.13)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is running; a fake "
                               f"mesh needs a fake group of its own")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    dev = torch.device(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{axis: size}`` of a mesh, in its dim order (what
    ``repro_torch.parallel.sharding`` takes)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
