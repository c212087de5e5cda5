"""The collectives of a mesh of ranks (``parallel/mesh.py``).

A mesh of one device, or a mesh with no process group, makes every
function here the identity, so one-device code runs unchanged.

Autograd. A data-parallel step (``train/ssl_train.py``) computes the same
global loss on every rank from the rows the ranks gathered, and then sums
the ranks' parameter gradients. Under that rule ``gather_rows_grad``'s
backward is this rank's rows of the incoming gradient, which every rank
holds whole: summing it over ranks, as ``torch.distributed.nn``'s gather
does, would count the loss W times. (The global BatchNorm's all-reduce,
``models/backbone.py``, sums its backward over ranks: each rank's incoming
gradient holds only what flows through its own rows.) The gradient of a
parameter on a rank is then that rank's share of the global one, and the
sum of the shares is the global gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh

# torch 2.13 renamed all_gather_into_tensor; both take (out, in, group)
_all_gather = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")


def is_multi(mesh: Mesh | None) -> bool:
    """Whether ``mesh`` spans more than one rank."""
    return mesh is not None and mesh.group is not None and mesh.size > 1


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's equal-sized ``x``, concatenated along dim 0 in rank
    order, on every rank."""
    if not is_multi(mesh):
        return x
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x, group=mesh.group)
    return out


def broadcast_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank, in place: every rank passes a tensor
    of the same shape and dtype on its device (the others' contents are
    overwritten)."""
    if is_multi(mesh):
        dist.broadcast(x, 0, group=mesh.group)
    return x


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ranks, in place, on every rank."""
    if is_multi(mesh):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def broadcast_state(module: torch.nn.Module, mesh: Mesh, src: int = 0
                    ) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank ``src``'s, in
    place."""
    if is_multi(mesh):
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src, group=mesh.group)
    return module


def rank_rows(x, mesh: Mesh | None):
    """This rank's rows [r B/W, (r+1) B/W) of a global batch ``x`` (an
    array or a tensor); all of them on one device. B must be divisible by
    the mesh size."""
    if not is_multi(mesh):
        return x
    if x.shape[0] % mesh.size:
        raise ValueError(f"a global batch of {x.shape[0]} rows is not "
                         f"divisible by the mesh's {mesh.size} ranks")
    b = x.shape[0] // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.rank
        return g[r * ctx.n:(r + 1) * ctx.n].contiguous(), None


def gather_rows_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``gather_rows`` under autograd, for a loss every rank computes whole
    (see the module note)."""
    if not is_multi(mesh):
        return x
    return _GatherRows.apply(x, mesh)
