"""Production and smoke meshes, the worlds they run on, and the card's
roofline constants.

Own counterpart of ``repro.launch.mesh``.  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the active process
group, built by a *function*, so importing this module starts no group.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis is
outer data parallelism (the batch shards over pod x data through the
``batch`` logical rule), so cross-pod traffic is gradient all-reduce only.

The dry-run (:mod:`repro_torch.launch.dryrun`) builds the production
meshes on :func:`fake_world`, a process group of any size in one process
whose collectives move no data: it runs on any host and never touches a
card, as the reference's dry-run forces 512 host devices.

The search fleet's mesh (:func:`make_fleet_mesh`) is of another kind: the
local devices of one process on one ``data`` axis, which
:func:`repro_torch.core.tensor_search.tensor_search` splits its
population over.  It needs no process group.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device

# One NVIDIA H100 SXM, the roofline denominators: NVIDIA's data-sheet
# peaks at the 700 W power limit (dense bf16 tensor cores; HBM3; NVLink 4
# at 900 GB/s a card, 450 GB/s each way), not measurements.  A card set
# below 700 W runs slower.  The reference's TPU v5e figures do not apply.
PEAK_FLOPS_BF16 = 989e12       # FLOP/s
HBM_BW = 3.35e12               # bytes/s
LINK_BW = 450e9                # bytes/s, NVLink each way


def production_shape(multi_pod: bool = False, dims=None) -> tuple[tuple, tuple]:
    """(extents, axis names) of the production mesh; ``dims`` replaces the
    extents with the same axis names (small worlds in tests)."""
    shape = tuple(dims or ((2, 16, 16) if multi_pod else (16, 16)))
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, dims=None):
    """The production mesh (:func:`production_shape`) on the active
    process group, which must hold exactly its 256 (512 with
    ``multi_pod``) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_shape(multi_pod, dims)
    size = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != size:
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{size} ranks, found {have or 'none'}; start one, e.g. "
            f"fake_world({size}) for a dry-run")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_smoke_mesh(device: str = "cuda"):
    """A (1, n) mesh with the production axis names over the active
    process group of n ranks (a world of one: :func:`local_world`).  Every
    logical axis resolves to replication on it, so the model runs as it
    does outside any context.  Raises without a card unless asked for
    ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_smoke_mesh needs a process group; start "
                           "one with local_world()")
    n = dist.get_world_size()
    return init_device_mesh(dev.type, (1, n), mesh_dim_names=("data", "model"))


@dataclass(frozen=True)
class FleetMesh:
    """Devices of this process on one ``data`` axis.  ``shape`` and
    ``axis_names`` read as a jax mesh's do (``mesh.shape["data"]``).  One
    process drives every device, as the reference's fleet worker drives
    every local device; a ``DeviceMesh`` would need a process a rank."""

    devices: tuple[torch.device, ...]
    axis_names = ("data",)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices)}


def make_fleet_mesh(devices=None) -> FleetMesh:
    """Every visible card on one ``data`` axis, the search fleet's layout:
    :func:`~repro_torch.core.tensor_search.tensor_search` evaluates a
    contiguous shard of its population on each device, and the argsort
    of the gathered fitness is the only step across shards.  ``devices``
    names them instead (``["cpu"] * 3`` is three shards on the CPU).
    Without a card and without ``devices`` it raises: it never falls back
    to the CPU."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass devices=[...] "
                               "(e.g. ['cpu'] * 2) to build a fleet mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("a fleet mesh needs at least one device")
    return FleetMesh(devs)


@contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks in this process, this process rank
    0, whose collectives return at once and move nothing: enough to build
    a mesh and lay out DTensors on fake tensors.  Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextmanager
def local_world(device: str = "cuda"):
    """A real gloo process group of one rank over an in-process store, on
    which :func:`make_smoke_mesh` builds its mesh for ``device`` (a mesh
    of one rank sends nothing); destroyed on exit."""
    resolve_device(device)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
