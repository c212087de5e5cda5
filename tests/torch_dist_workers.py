"""Rank bodies of the multi-rank tests (``tests/test_torch_distributed*.py``).

``parallel.launch.run_ranks`` pickles a rank's function by its module path
and a spawned rank imports that module afresh: these import torch and the
port only, so a rank does not import JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (
    MinutiaeSet as TSet, minutiae_from_numpy)
from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
    ransac as tr)
from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import (
    gallery as tg, mesh as tmesh)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    users_gallery)

# --- the gallery ---------------------------------------------------------------

PARAMS = dict(ransac_iter=16, min_inliers=5)
SCREEN = dict(ransac_iter=8, full_iters=16, min_inliers=3)


def n16():
    return users_gallery(4, 4, k=16, n_min=16, seed=1)


def n70():
    return users_gallery(14, 5, k=16, n_min=16, seed=2)


def pairs37():
    """37 of N=16's 120 unique pairs: a count no multiple of W x chunk."""
    pairs = tg.unique_pairs(16)
    pick = np.sort(np.random.default_rng(3).choice(len(pairs), 37,
                                                   replace=False))
    return pairs[pick]


def gallery_calls(mesh) -> dict:
    """Every gallery function on ``mesh``, as numpy."""
    torch.set_num_threads(1)
    g16, g70 = minutiae_from_numpy(n16()), minutiae_from_numpy(n70())
    p, sp = tr.MatchParams(**PARAMS), tr.MatchParams(**SCREEN)
    probes = tg.take_templates(g16, [1, 6, 13])
    bp, mask = tg.shard_blocks_screen(g16, mesh, sp, block=8)
    out = {
        "all_pairs_scores": tg.all_pairs_scores(g16, mesh, p, col_chunk=8),
        "shard_pairs_scores": np.stack(tg.shard_pairs_scores(
            g16, pairs37(), mesh, p, chunk=8)).astype(np.float64),
        "shard_pairs_screen": tg.shard_pairs_screen(
            g16, pairs37(), mesh, sp, chunk=8),
        "shard_blocks_screen": np.concatenate([bp.ravel(), mask.ravel()]),
        "all_pairs_unique": tg.all_pairs_unique(g70, mesh, p, chunk=512,
                                                cascade=False),
        "all_pairs_unique cascade": tg.all_pairs_unique(
            g70, mesh, p, chunk=512, cascade=True, screen_iters=8),
        "identify": tg.identify(TSet(*(x[6] for x in g16)),
                                tg.shard_gallery(g16, mesh), mesh, p,
                                chunk=4),
        "identify_batch": tg.identify_batch(probes, g16, mesh, p, chunk=4),
        "identify_batch cascade": tg.identify_batch(
            probes, g16, mesh, p, chunk=4, cascade=True, screen_iters=8),
        # the list is chosen after the ranks' blocks are gathered
        "identify_batch candidates": np.concatenate([
            x.numpy().astype(np.float64) for x in tg.candidate_list(
                tg.identify_batch(probes, g16, mesh, p, chunk=4, cascade=True,
                                  screen_iters=8), 6)]),
    }
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def gallery_rank() -> dict:
    mesh = tmesh.create_mesh()
    assert mesh.device == torch.device("cpu")
    return gallery_calls(mesh)


# --- data-parallel SSL training -------------------------------------------------

TINY = dict(backbone_name="effnetv2_tiny", embedding_dim=32,
            proj_hidden_dim=32, proj_output_dim=16)
B, S = 4, 48
DROPOUT_PATH = ("projection_head", "Dropout_0")


def port_model(seed=3):
    """The tiny model with seeded weights and BatchNorm statistics that
    are not the identity (``tests/test_torch_train.py``'s)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
        SSLModel, seed_weights)
    m = seed_weights(SSLModel(**TINY), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.running_mean.copy_(0.1 * torch.randn(
                    mod.running_mean.shape, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(
                    mod.running_var.shape, generator=g))
    return m


def views(seed, n=B):
    g = np.random.default_rng(seed)
    return tuple(g.random((n, S, S), np.float32) for _ in range(2))


def ssl_steps(mesh, lr: float, steps: int = 2) -> dict:
    """``steps`` steps of ``create_ssl_train_step`` on ``mesh`` from
    ``port_model``'s weights, views ``views(20 + k)`` (this rank's rows),
    key 11, the cosine-warmup schedule (lr 0 at step 0). Returns per step
    the loss, the JAX-layout variables and Adam's state; the gradients of
    the first step's loss at the start; this rank's rows of a dropout
    mask drawn over the mesh's process group."""
    import copy

    from multimodal_biometric_fingerprints_palms_tpu_torch.models.convert import (
        params_tree_of, ssl_variables_from_state)
    from multimodal_biometric_fingerprints_palms_tpu_torch.models.projection_head import (
        flax_dropout)
    from multimodal_biometric_fingerprints_palms_tpu_torch.parallel.collectives import (
        is_multi, rank_rows)
    from multimodal_biometric_fingerprints_palms_tpu_torch.train import (
        schedule as TS, ssl_train as TT)
    from multimodal_biometric_fingerprints_palms_tpu_torch.train.optim import (
        ClipAdamW)
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils import threefry

    torch.set_num_threads(1)
    rows = lambda x: torch.from_numpy(rank_rows(x, mesh))
    tm = port_model()
    rng = threefry.key(11)
    first = threefry.split(rng)[1]
    xi, xj = views(20)
    _, grads = TT.ssl_loss_and_grads(copy.deepcopy(tm), rows(xi), rows(xj),
                                     first, mesh=mesh)
    mask = flax_dropout(torch.ones(B // mesh.size, TINY["proj_hidden_dim"]),
                        first, DROPOUT_PATH, 0.1,
                        mesh.group if is_multi(mesh) else None) != 0
    tx = ClipAdamW(1.0, TS.cosine_warmup_schedule(lr, 1, 3), 1e-4)
    state = TT.SSLTrainState(dict(tm.named_parameters()),
                             dict(tm.named_buffers()),
                             tx.init(list(tm.parameters())), 0)
    step = TT.create_ssl_train_step(tm, tx, 0.5)
    out = []
    for k in range(steps):
        xi, xj = views(20 + k)
        rng, sub = threefry.split(rng)
        state, loss = step(state, rows(xi), rows(xj), sub, mesh)
        v = ssl_variables_from_state(tm.state_dict())
        adam = tx.to_flax(state.opt_state,
                          lambda ts: params_tree_of(tm, ts))["1"]["0"]
        out.append(dict(loss=float(loss), params=v["params"],
                        batch_stats=v["batch_stats"], mu=adam["mu"],
                        nu=adam["nu"], count=int(adam["count"])))
    return dict(steps=out, grads=[g.numpy() for g in grads],
                mask=mask.numpy())


def ssl_steps_rank(lr: float) -> dict:
    return ssl_steps(tmesh.create_mesh(axis_name="data"), lr)


def train_loop(mesh, save_dir: str) -> dict:
    """``train_ssl`` on ``mesh``: 2 epochs of 2 global batches of ``B``,
    lr 1e-3, checkpoints every epoch into ``save_dir``. Returns the
    history and how many checkpoints this rank wrote."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
        SSLModel)
    from multimodal_biometric_fingerprints_palms_tpu_torch.train import (
        ssl_train as TT)

    torch.set_num_threads(1)
    writes = []
    real = TT.save_checkpoint
    TT.save_checkpoint = lambda path, state: (writes.append(str(path)),
                                              real(path, state))
    try:
        _, hist = TT.train_ssl(
            SSLModel(**TINY), lambda: iter([views(30 + k) for k in range(2)]),
            2, epochs=2, lr=1e-3, warmup_epochs=1, input_shape=(S, S),
            save_dir=save_dir, save_every=1, mesh=mesh,
            device=None if mesh is not None else "cpu")
    finally:
        TT.save_checkpoint = real
    return dict(history=hist, writes=writes)


def train_loop_rank(save_dir: str) -> dict:
    return train_loop(tmesh.create_mesh(axis_name="data"), save_dir)


# --- the launcher, the mesh, the SSL pipeline, the dry run ---------------------

def mesh_rank(pid_dir: str) -> dict:
    """This rank's mesh, what ``create_mesh`` refuses inside a group of 2,
    and its pid written under ``pid_dir``."""
    import os
    from pathlib import Path

    mesh = tmesh.create_mesh(axis_name="rows")
    Path(pid_dir, f"{mesh.rank}.pid").write_text(str(os.getpid()))
    try:
        tmesh.create_mesh(mesh.size + 1)
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(size=mesh.size, rank=mesh.rank, devices=mesh.devices,
                axis=mesh.axis_name, sharding=tmesh.gallery_sharding(mesh),
                refused=refused)


def failing_rank(pid_dir: str) -> None:
    """Rank 1 raises; rank 0 waits for it in a collective."""
    import os
    from pathlib import Path

    import torch.distributed as dist
    rank = dist.get_rank()
    Path(pid_dir, f"{rank}.pid").write_text(str(os.getpid()))
    if rank == 1:
        raise KeyError("rank one's own failure")
    dist.barrier()


def hanging_rank(pid_dir: str) -> None:
    """Rank 0 waits in a collective that rank 1 never joins."""
    import os
    import time
    from pathlib import Path

    import torch.distributed as dist
    rank = dist.get_rank()
    Path(pid_dir, f"{rank}.pid").write_text(str(os.getpid()))
    if rank == 0:
        dist.all_reduce(torch.ones(1))
    time.sleep(600)


def pipeline_rank(config: str, workdir: str) -> dict:
    """``classifier.pipeline.main(train=True)`` on the world mesh."""
    import os

    from multimodal_biometric_fingerprints_palms_tpu_torch.classifier.pipeline import (
        main)
    torch.set_num_threads(1)
    os.chdir(workdir)
    res = main(config, train=True, mesh=tmesh.create_mesh(axis_name="data"))
    return {k: res[k] for k in ("embeddings", "labels", "training",
                                "num_ids")}


# --- calls of a group that stays up (``parallel.launch.RankGroup``) ---------------

def failing_call(ctx, data) -> None:
    """Rank 1 raises; rank 0 waits for it in a collective."""
    import torch.distributed as dist
    if ctx.mesh.rank == 1:
        raise KeyError("rank one's own failure")
    dist.barrier()


def dying_call(ctx, data) -> None:
    """Rank 1's process exits inside the call; rank 0 waits for it in a
    collective."""
    import os

    import torch.distributed as dist
    if ctx.mesh.rank == 1:
        os._exit(3)
    dist.barrier()
