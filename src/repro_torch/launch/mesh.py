"""Device meshes (PyTorch port of ``repro.launch.mesh``).

``make_production_mesh`` is the dry-run target: 16 x 16 = 256 chips per
pod on axes ("data", "model"), 2 pods = 512 chips on ("pod", "data",
"model").  It is a ``torch.distributed.device_mesh.DeviceMesh`` over
PyTorch's fake process group (backend ``"fake"``): this process is rank
0 of the whole world, every collective returns at once and touches no
network, and a step run on the mesh executes rank 0's shards only.
``make_local_mesh`` is the (1, 1) mesh over one device that the
launchers run real steps on: a world-size-1 group on an in-process
``HashStore`` (NCCL on the card, gloo on the CPU).

A process has one default process group.  A mesh function reuses the
group that is up when it fits (the same backend and world size), swaps
one fake world for another, and refuses to replace a real group;
``close_mesh`` takes the group down.

``AbstractMesh`` carries axis names and sizes only, with no process
group: the sharding rules need nothing else (the counterpart of
``repro.compat.abstract_mesh``).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.devices import DeviceLike, resolve_device

POD_SHAPE = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, without devices or a group."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def axis_sizes(mesh) -> dict:
    """{axis name: size} of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _ensure_world(backend: str, world: int) -> None:
    """Bring up the default group as ``backend`` with ``world`` ranks, this
    process rank 0, on an in-process store."""
    if dist.is_initialized():
        up = dist.get_backend()
        if up == backend and dist.get_world_size() == world:
            return
        if up != "fake":
            raise RuntimeError(
                f"a {up} process group of {dist.get_world_size()} ranks is "
                f"up; a {backend} mesh of {world} needs its own process "
                "(close_mesh() first)")
        dist.destroy_process_group()
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    else:
        if backend == "gloo":
            # the loopback device: no host-name lookup
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=world)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips when multi_pod (a
    fake world: see the module docstring)."""
    shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else POD_AXES
    world = math.prod(shape)
    _ensure_world("fake", world)
    return DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_local_mesh(device: DeviceLike = None) -> DeviceMesh:
    """The (1, 1) ("data", "model") mesh over one device (default
    ``cuda``): NCCL on the card, gloo on the CPU, world size 1."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    _ensure_world("nccl" if dev.type == "cuda" else "gloo", 1)
    return DeviceMesh(dev.type, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=POD_AXES)


def mesh_devices(mesh) -> int:
    if isinstance(mesh, AbstractMesh):
        return mesh.size
    return mesh.size()


def close_mesh() -> None:
    """Destroy the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
