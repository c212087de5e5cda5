"""Device mesh of the gallery (port of ``parallel/mesh.py``).

The JAX package shards the (N, K) template axis of a gallery over a 1-D
``jax.sharding.Mesh``. The port runs the gallery on one device: a mesh is
that device and the axis name, and the placements ``gallery_sharding`` and
``replicated`` describe put every row on it. A mesh of more than one device
raises ``NotImplementedError`` rather than splitting a gallery silently or
using the first device quietly; multi-GPU sharding through
``torch.distributed`` is ROADMAP.md queue 1, item 5.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device


class Mesh(NamedTuple):
    devices: tuple          # one torch.device per position on the axis
    axis_name: str

    @property
    def size(self) -> int:
        return len(self.devices)


class Placement(NamedTuple):
    """Where a gallery's rows live: ``device``, and the mesh axis its
    template axis is split over (None: replicated on every device)."""
    device: torch.device
    axis_name: str | None


def create_mesh(n_devices: int | None = None, axis_name: str = "gallery",
                device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` devices of ``device``'s kind (default:
    the card; pass ``"cpu"`` to run there). ``n_devices=None`` takes every
    device of that kind, as the JAX package's ``jax.devices()`` does: every
    visible card for ``device=None`` or ``"cuda"``, else the one named."""
    dev = resolve_device(device, "create_mesh")
    n = 1
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
        n = torch.cuda.device_count()
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"n_devices={n_devices} must be at least 1")
        n = n_devices
    if n != 1:
        raise NotImplementedError(
            f"a mesh of {n} devices: the port's gallery runs on one device "
            "(create_mesh(1) takes one); multi-GPU sharding through "
            "torch.distributed is ROADMAP.md queue 1, item 5")
    return Mesh((dev,), axis_name)


def gallery_sharding(mesh: Mesh, axis_name: str = "gallery") -> Placement:
    """The leading (template) axis split over the mesh."""
    return Placement(mesh.devices[0], axis_name)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh.devices[0], None)
