"""Device mesh of the gallery and of data-parallel training (port of
``parallel/mesh.py``).

The JAX package shards the (N, K) template axis of a gallery, or the batch
axis of a training step, over a 1-D ``jax.sharding.Mesh`` that one
controller drives. The port is one process a device: a mesh of W devices is
a ``torch.distributed`` process group of W ranks, each holding its own
device, and every rank runs the same program on its share. The backend
follows the device: NCCL for ``cuda``, gloo for ``cpu``.
``parallel/launch.py`` starts such ranks (or joins the group ``torchrun``
made). Outside a process group a mesh is one device, as before.

``gallery_sharding`` and ``replicated`` describe where a rank's rows live:
its device, and the mesh axis the rows are split over (None: every rank
holds every row).
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


class Mesh(NamedTuple):
    devices: tuple          # one torch.device per rank, in rank order
    axis_name: str
    group: Any = None       # the process group; None: one device, no group
    rank: int = 0           # this process's position on the axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device this process drives."""
        return self.devices[self.rank]


class Placement(NamedTuple):
    """Where a rank's gallery rows live: ``device``, and the mesh axis its
    template axis is split over (None: replicated on every rank)."""
    device: torch.device
    axis_name: str | None


def _rank_device(backend: str, device=None) -> torch.device:
    """The device of this rank of a group on ``backend``: ``device`` when
    given (``"cuda"`` means the card ``set_device`` bound), else the card
    ``LOCAL_RANK`` names for NCCL and the CPU for gloo."""
    if device is None:
        if backend != "nccl":
            return torch.device("cpu")
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(device, "create_mesh")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def create_mesh(n_devices: int | None = None, axis_name: str = "gallery",
                device=None) -> Mesh:
    """A 1-D mesh.

    Inside an initialised process group of W ranks: the mesh of the W
    ranks, each on its own device (``_rank_device``); ``n_devices`` is W or
    None, and every rank must call this (it gathers the ranks' devices).
    Outside one: one device of ``device``'s kind (default: the card; pass
    ``"cpu"`` to run there), and ``n_devices`` is 1 or None. More devices
    need one process a device: ``parallel.launch.run_ranks``, or
    ``torchrun --nproc-per-node N``."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices={n_devices} must be at least 1")
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} devices needs a process group of "
                f"{n_devices} ranks, one a device: start them with "
                "parallel.launch.run_ranks, or under torchrun "
                f"--nproc-per-node {n_devices}")
        dev = resolve_device(device, "create_mesh")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh((dev,), axis_name)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"n_devices={n_devices}: the process group has "
                         f"{world} ranks, one a device")
    own = _rank_device(dist.get_backend(), device)
    if own.type == "cuda":
        torch.cuda.set_device(own)          # NCCL's collectives use it
    names = [None] * world
    dist.all_gather_object(names, str(own))
    return Mesh(tuple(torch.device(n) for n in names), axis_name,
                dist.group.WORLD, dist.get_rank())


def gallery_sharding(mesh: Mesh, axis_name: str = "gallery") -> Placement:
    """The leading (template) axis split over the mesh."""
    return Placement(mesh.device, axis_name)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh.device, None)
