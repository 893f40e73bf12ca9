"""Meshes of devices in one process.

A port of `repro.launch.mesh`. The JAX package runs its mesh from a single
controller: one process steps a state sharded over a `jax.sharding.Mesh`.
The port keeps that model. Its `Mesh` is a named grid of `torch.device`s,
and a plan on it (`weather/program.py::compile(mesh=...)`) runs every
shard's round from this process, moving each halo ride with a copy into the
neighbour shard's device (`weather/domain.py`). Several shards may sit on
one device, but only when the caller lists that device more than once:
nothing here repeats a device on its own.

Each entry of a mesh also has a logical id (`Mesh.ids`), the twin of
`jax.Device.id`: by default its position in the list `make_mesh` was given,
which for the default mesh over the card's devices is the CUDA index. A
mesh built from some of another's entries (a failover's survivors) keeps
their ids, so four shards of one card (`["cuda:0"] * 4`) are four logical
devices that a fault, a failover record or `stats()` can name apart.

The LM trains on another kind of mesh: `make_device_mesh` builds a
`torch.distributed` `DeviceMesh`, one process a device (NCCL on the
cards, gloo where the caller asks for the CPU), on which parameters,
optimizer state and batches are DTensors (`parallel/sharding.py`,
`train/loop.py`). Sharding parameters over processes is a different
problem from the weather rounds' halo rides, which stay single-process.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "production_shape", "make_production_mesh",
           "data_axes", "make_device_mesh"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`, an object array of `torch.device` shaped like the mesh,
    and one name an axis. `shape` maps each axis to its size, in axis
    order, as `jax.sharding.Mesh.shape` does. Shards are numbered in the
    C order of `devices`; `ids` holds each shard's logical device id in that
    order (by default 0, 1, ...). Two meshes are equal when they place
    shards on the same devices, whatever their ids."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    ids: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        ids = (tuple(range(self.devices.size)) if self.ids is None
               else tuple(int(i) for i in self.ids))
        if len(ids) != self.devices.size or len(set(ids)) != len(ids):
            raise ValueError(f"a mesh of {self.devices.size} devices needs "
                             f"as many distinct ids, got {ids}")
        object.__setattr__(self, "ids", ids)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names {self.axis_names} repeat")
        kinds = {d.type for d in self.devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh spans one kind of device, got "
                             f"{sorted(kinds)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list:
        """The shards' devices in shard order."""
        return list(self.devices.flat)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def axis_size(self, name: Optional[str]) -> int:
        """The size of axis `name`; 1 for None or an axis the mesh lacks."""
        return self.shape.get(name, 1) if name is not None else 1

    def coords(self, shard: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(shard,
                                                      self.devices.shape))

    def neighbor(self, shard: int, axis: str, offset: int) -> int:
        """The shard `offset` steps along `axis` from `shard`, around the
        ring."""
        c = list(self.coords(shard))
        a = self.axis_names.index(axis)
        c[a] = (c[a] + offset) % self.devices.shape[a]
        return int(np.ravel_multi_index(c, self.devices.shape))

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))

    def __repr__(self) -> str:
        devs = ", ".join(f"{i}:{d}" for i, d in zip(self.ids,
                                                   self.devices.flat))
        return f"Mesh({self.shape}, devices=[{devs}])"


def make_mesh(shape, axes, devices: Optional[Sequence] = None,
              ids: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of `shape` named `axes` over the first prod(shape) of
    `devices`, by default the card's devices (`cuda:0`, `cuda:1`, ...).
    Asking for more shards than there are devices raises, as the JAX
    package's `make_mesh` does; to put several shards on one device, list
    it that many times in `devices` (e.g. `["cuda:0"] * 4`, or `["cpu"] *
    4` for the plain versions). `ids` are the devices' logical ids, one a
    listed device (default: their positions in the list); the mesh keeps
    those of the devices it takes."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass "
                               "devices= (e.g. ['cpu'] * n) to run the plain "
                               "PyTorch versions")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if len(devs) < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {len(devs)}; list a "
            f"device more than once in devices= to put several shards on it")
    ids = list(range(len(devs))) if ids is None else [int(i) for i in ids]
    if len(ids) != len(devs):
        raise ValueError(f"{len(ids)} ids for {len(devs)} devices")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = d
    return Mesh(arr.reshape(shape), tuple(axes), tuple(ids[:n]))


def production_shape(*, multi_pod: bool = False):
    """(shape, axes) of the production mesh. Single pod: (16, 16) =
    ("data", "model"), 256 devices. Multi-pod: (2, 16, 16) = ("pod",
    "data", "model"), 512. The "pod" axis carries the ensemble, and an
    LM's batch beside "data" (data parallel across pods)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh (`production_shape`) over the card's devices."""
    return make_mesh(*production_shape(multi_pod=multi_pod))


def data_axes(mesh) -> tuple:
    """Mesh axes that carry batch/data parallelism (a `Mesh` or a
    `DeviceMesh`)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def make_device_mesh(shape, axes, device_type: Optional[str] = None):
    """The LM's mesh: a `torch.distributed` `DeviceMesh` of `shape` named
    `axes`, one process a device (the port's twin of a JAX mesh for
    parameter sharding; the weather rounds keep the single-process
    `Mesh`). `device_type` is "cuda" (the default: NCCL, one card a rank,
    the rank's `LOCAL_RANK` card) or "cpu" (gloo, where the caller asks
    for the CPU). The process group is taken from the launcher's
    environment (torchrun's `RANK`/`WORLD_SIZE`), or made a world of one
    for a (1, ..., 1) shape when none exists; an existing group is used as
    it is. Raises when the world is not prod(shape), or when the card is
    asked for and CUDA or NCCL is not there: nothing falls back to gloo or
    the CPU.

    One exception: a group the caller made with the "fake" backend
    (`torch.testing._internal.distributed.fake_pg.FakeStore`; the
    dry-run's world, `launch/dryrun.py`), whose collectives move nothing.
    On it a mesh of either device type is made without a card, and may
    take the world's first prod(shape) ranks, so one fake world serves
    meshes of several sizes."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    device_type = device_type or "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    cuda = device_type == "cuda"
    fake = dist.is_initialized() and dist.get_backend() == "fake"
    if fake:
        if n > dist.get_world_size():
            raise RuntimeError(f"mesh {shape} needs {n} ranks, the fake "
                               f"world has {dist.get_world_size()}")
        return init_device_mesh(device_type, shape,
                                mesh_dim_names=tuple(axes))
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("make_device_mesh: no CUDA device is available; "
                           "pass device_type='cpu' for gloo on the CPU")
    backend = "nccl" if cuda else "gloo"
    if not dist.is_initialized():
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        elif n == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise RuntimeError(
                f"a {shape} mesh needs {n} processes: run under torchrun "
                f"(--nproc-per-node {n}) or init the process group first")
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {shape} needs a world of {n}, the process "
                           f"group has {dist.get_world_size()}")
    if cuda and dist.get_backend() != "nccl":
        raise RuntimeError(f"a CUDA mesh runs on NCCL; the process group's "
                           f"backend is {dist.get_backend()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))
