"""SSL (SimCLR-style) training of the port (the JAX package's
``train/ssl_train.py``), on the card unless given ``device="cpu"``.

The same loop: ``PRNGKey(seed)`` split once a step; two-view batches,
NT-Xent, AdamW after a global-norm clip with the cosine-warmup schedule
(``train/optim.py``, ``train/schedule.py``), the loss of each epoch, the
best (``ssl_best``), periodic (``ssl_epoch{N}``) and final
(``ssl_model_final``) checkpoints, early stopping. A step runs the model in
train mode on view i with the step key as its dropout key, then on view j
with ``fold_in(key, 1)``; BatchNorm's running statistics move on both
views, the second from where the first left them, as the JAX step feeds
the first apply's ``batch_stats`` into the second. The forward, the
backward and the loss run in float32 with TF32 off
(``utils.device.full_float32``).

Checkpoints are the JAX payload ``{params, batch_stats, step}`` in flax's
msgpack format (``utils/checkpoint.py``), written through
``models.ssl_variables_from_state``: either package reads the other's.

The state: ``SSLTrainState(params, batch_stats, opt_state, step)`` with
``params`` and ``batch_stats`` the model's own parameters and running
statistics by name (a step updates them in place) and ``opt_state`` the
optimizer's (``train.optim.AdamWState``).

Initial weights: flax's ``init`` draws cannot be reproduced without flax,
so ``init_ssl_state`` seeds the weights through ``models.seed_weights``
(flax's initialisers from a ``torch.Generator`` seeded with the key's
seed): the same seed gives the same weights on every machine, but not the
JAX package's.

Data-parallel training: ``train_ssl(..., mesh=...)`` on a mesh of W ranks
(``parallel/mesh.py``) is the JAX step over a ``data`` mesh axis, the
global batch sharded and everything else replicated. Every rank calls it
with the same arguments and the same global batches; rank r takes rows
[r B/W, (r+1) B/W) of both views (B must be divisible by W). The weights
start as rank 0's. In the step (``step(..., mesh=mesh)``, which hands the
models the mesh's process group as their ``batch_group``) BatchNorm
normalises with the global batch's statistics and moves its
running statistics by them, dropout keeps the rank's rows of the global
batch's masks, and NT-Xent is taken over the projections of the global
batch, gathered with autograd; the ranks' gradients are summed, once (see
``parallel/collectives.py``), so the clip and AdamW run the same on every
rank and the parameters, moments and statistics stay equal. Losses are
equal on every rank; only rank 0 writes checkpoints and logs. On one
device nothing of this runs.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..models.convert import ssl_variables_from_state
from ..models.losses import nt_xent_loss
from ..models.seeding import seed_weights
from ..models.ssl_model import SSLModel
from ..parallel.collectives import (all_reduce_sum, broadcast_state,
                                    gather_rows_grad, is_multi, rank_rows)
from ..utils import threefry
from ..utils.checkpoint import load_msgpack, save_msgpack
from ..utils.device import full_float32, resolve_device
from ..utils.logging import get_file_logger
from .optim import ClipAdamW
from .schedule import cosine_warmup_schedule


def _logger():
    return get_file_logger(__name__, "data/metadata/train.log")


class SSLTrainState(NamedTuple):
    params: Any
    batch_stats: Any
    opt_state: Any
    step: int


def _sum_over_ranks(grads: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """Each gradient summed over the mesh's ranks, in one all-reduce."""
    if not is_multi(mesh):
        return grads
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), mesh)
    return [v.view_as(g) for v, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def ssl_loss_and_grads(model: SSLModel, x_i: torch.Tensor, x_j: torch.Tensor,
                       rng, temperature: float = 0.5, mesh=None):
    """(loss, gradients aligned with ``model.parameters()``) of one step on
    views ``x_i``, ``x_j`` with the step key ``rng``; moves the running
    statistics twice. On a ``mesh`` of W ranks ``x_i``, ``x_j`` are this
    rank's rows of the global views, and the loss and the gradients are
    the global batch's, on every rank."""
    model.train()
    params = list(model.parameters())
    group = mesh.group if is_multi(mesh) else None
    with full_float32():
        z_i = model(x_i, dropout_rng=rng, batch_group=group)
        z_j = model(x_j, dropout_rng=threefry.fold_in(rng, 1),
                    batch_group=group)
        loss = nt_xent_loss(gather_rows_grad(z_i, mesh),
                            gather_rows_grad(z_j, mesh), temperature)
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), _sum_over_ranks(list(grads), mesh)


def create_ssl_train_step(model: SSLModel, tx: ClipAdamW,
                          temperature: float = 0.5) -> Callable:
    """Returns ``step(state, x_i, x_j, rng, mesh=None) -> (state, loss)``;
    ``rng`` is a ``utils.threefry`` key. The step updates the model in
    place. With a ``mesh`` of W ranks it is one rank's part of the
    data-parallel step (see the module note), where the JAX step is one
    program over the global batch whatever its placement."""

    def step(state: SSLTrainState, x_i, x_j, rng, mesh=None):
        loss, grads = ssl_loss_and_grads(model, x_i, x_j, rng, temperature,
                                         mesh)
        tx.step(list(model.parameters()), grads, state.opt_state)
        return SSLTrainState(state.params, state.batch_stats,
                             state.opt_state, state.step + 1), loss

    return step


def init_ssl_state(model: SSLModel, rng, input_shape,
                   tx: ClipAdamW) -> SSLTrainState:
    """Seed ``model``'s weights from ``rng`` (``threefry.key(seed)``, whose
    second word is the seed; see the module note) and return its state.
    ``input_shape`` is the JAX function's (``init`` traces a batch of that
    shape); the port's modules know their shapes."""
    del input_shape
    device = next(model.parameters()).device
    seed_weights(model.cpu(), int(rng[1]))
    model.to(device)
    return SSLTrainState(dict(model.named_parameters()),
                         dict(model.named_buffers()),
                         tx.init(list(model.parameters())), 0)


def save_checkpoint(path: str | Path, state: SSLTrainState):
    """``{"params", "batch_stats", "step"}`` in the JAX package's format."""
    v = ssl_variables_from_state({**state.params, **state.batch_stats})
    save_msgpack(path, {"params": v["params"],
                        "batch_stats": v["batch_stats"],
                        "step": int(state.step)})


def load_checkpoint(path: str | Path, template: dict) -> dict:
    """The payload of ``path`` (nested dicts of numpy arrays); raises if
    its top-level keys are not ``template``'s."""
    payload = load_msgpack(path)
    if set(payload) != set(template):
        raise KeyError(f"{path}: keys {sorted(payload)}, expected "
                       f"{sorted(template)}")
    return payload


def _train_device(device, mesh, what: str) -> torch.device:
    if mesh is not None:
        if mesh.size > 1 and mesh.group is None:
            raise ValueError(
                f"{what} on a mesh of {mesh.size} devices without a process "
                "group: build the mesh with parallel.create_mesh inside the "
                "ranks (parallel.launch.run_ranks, or torchrun)")
        return mesh.device
    return resolve_device(device, what)


def _epochs(state, step_batches, epochs, save_dir, save_every,
            early_stop_patience, sync_every_step, lead: bool = True):
    """The loop both trainers share: per epoch ``step_batches(state)``
    yields (state, loss) a step; checkpoints and early stopping. Only the
    ``lead`` rank writes checkpoints and logs."""
    info = _logger().info if lead else (lambda *args: None)
    save = save_checkpoint if lead else (lambda path, state: None)
    history: list[float] = []
    best_loss = float("inf")
    patience = 0
    for epoch in range(epochs):
        t0 = time.time()
        losses = []
        for state, loss in step_batches(state):
            losses.append(float(loss) if sync_every_step else loss)
        losses = [float(v) for v in losses]
        epoch_loss = float(np.mean(losses)) if losses else float("inf")
        history.append(epoch_loss)
        info("epoch %d: loss=%.4f (%.1fs)", epoch, epoch_loss,
             time.time() - t0)
        if epoch_loss < best_loss:
            best_loss = epoch_loss
            patience = 0
            save(save_dir / "ssl_best.msgpack", state)
        else:
            patience += 1
            if patience >= early_stop_patience:
                info("early stop at epoch %d", epoch)
                break
        if save_every and (epoch + 1) % save_every == 0:
            save(save_dir / f"ssl_epoch{epoch + 1}.msgpack", state)
    save(save_dir / "ssl_model_final.msgpack", state)
    return state, history


def train_ssl(model: SSLModel,
              batches: Callable[[], Any],     # yields (x_i, x_j) numpy pairs
              steps_per_epoch: int,
              epochs: int = 3,
              lr: float = 1e-5,
              weight_decay: float = 1e-4,
              grad_clip: float = 1.0,
              warmup_epochs: int = 5,
              temperature: float = 0.5,
              input_shape=(224, 224),
              seed: int = 42,
              save_dir: str | Path = "save_models",
              save_every: int = 30,
              early_stop_patience: int = 15,
              mesh=None,
              device=None) -> tuple[SSLTrainState, list[float]]:
    """Train on host-rendered views: ``batches()`` returns an iterator of
    (x_i, x_j) two-view numpy batches for one epoch. On ``device`` (default:
    the card), or data-parallel on ``mesh`` (see the module note: every
    rank passes the same global batches and keeps its rows)."""
    device = _train_device(device, mesh, "train_ssl")
    save_dir = Path(save_dir)
    schedule = cosine_warmup_schedule(lr, warmup_epochs * steps_per_epoch,
                                      epochs * steps_per_epoch)
    tx = ClipAdamW(grad_clip, schedule, weight_decay)
    rng = threefry.key(seed)
    state = init_ssl_state(model.to(device), rng, input_shape, tx)
    broadcast_state(model, mesh)
    step_fn = create_ssl_train_step(model, tx, temperature)

    def step_batches(state):
        nonlocal rng
        for x_i, x_j in batches():
            xi, xj = (torch.from_numpy(np.ascontiguousarray(rank_rows(
                np.asarray(x, np.float32), mesh))).to(device)
                for x in (x_i, x_j))
            rng, sub = threefry.split(rng)
            state, loss = step_fn(state, xi, xj, sub, mesh)
            yield state, loss

    return _epochs(state, step_batches, epochs, save_dir, save_every,
                   early_stop_patience, sync_every_step=True,
                   lead=mesh is None or mesh.rank == 0)


def device_views(data_dev: torch.Tensor, idx: torch.Tensor, rng,
                 image_size: int):
    """The device step's inputs: the batch ``idx`` of the uint8 set in
    [0, 1] and its two views, ``augment_batch`` under ``fold_in(rng, 0)``
    and ``fold_in(rng, 1)``."""
    from ..classifier.augment_device import augment_batch
    x = torch.div(data_dev.index_select(0, idx).to(torch.float32),
                  torch.tensor(255.0, device=data_dev.device))
    return (augment_batch(x, threefry.fold_in(rng, 0), image_size),
            augment_batch(x, threefry.fold_in(rng, 1), image_size))


def train_ssl_device(model: SSLModel,
                     data: np.ndarray,               # (N, H, W) uint8
                     batch_size: int,
                     epochs: int = 30,
                     lr: float = 1e-3,
                     weight_decay: float = 1e-4,
                     grad_clip: float = 1.0,
                     warmup_epochs: int = 2,
                     temperature: float = 0.5,
                     image_size: int = 224,
                     seed: int = 42,
                     save_dir: str | Path = "save_models",
                     save_every: int = 30,
                     early_stop_patience: int = 15,
                     device=None,
                     ) -> tuple[SSLTrainState, list[float]]:
    """Device-resident SSL training: the uint8 set goes to ``device``
    (default: the card) once and both views of a step are rendered there
    (``classifier.augment_device``); the batch order is
    ``np.random.default_rng(seed).permutation`` per epoch, and a step's key
    ``sub`` gives ``fold_in(sub, 0)`` and ``fold_in(sub, 1)`` to the views
    and ``fold_in(sub, 2)`` to the train step. The losses are read once an
    epoch."""
    device = resolve_device(device, "train_ssl_device")
    save_dir = Path(save_dir)
    n = data.shape[0]
    steps_per_epoch = max(1, n // batch_size)
    schedule = cosine_warmup_schedule(lr, warmup_epochs * steps_per_epoch,
                                      epochs * steps_per_epoch)
    tx = ClipAdamW(grad_clip, schedule, weight_decay)
    rng = threefry.key(seed)
    state = init_ssl_state(model.to(device), rng, (image_size, image_size), tx)
    base_step = create_ssl_train_step(model, tx, temperature)
    data_dev = torch.from_numpy(np.asarray(data, dtype=np.uint8)).to(device)
    perm_rng = np.random.default_rng(seed)

    def step_batches(state):
        nonlocal rng
        order = perm_rng.permutation(n)
        for b in range(steps_per_epoch):
            idx = torch.from_numpy(
                order[b * batch_size:(b + 1) * batch_size]).to(device)
            rng, sub = threefry.split(rng)
            x_i, x_j = device_views(data_dev, idx, sub, image_size)
            state, loss = base_step(state, x_i, x_j, threefry.fold_in(sub, 2))
            yield state, loss

    return _epochs(state, step_batches, epochs, save_dir, save_every,
                   early_stop_patience, sync_every_step=False)
