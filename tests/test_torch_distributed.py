"""The port's multi-rank paths on the CPU, over spawned gloo ranks
(``parallel.launch.run_ranks``): the launcher and the mesh, the
data-parallel SSL step at W=2 against W=1 and against the JAX step on a
2-device ``data`` mesh, ``train_ssl``'s loop and checkpoints,
``classifier.pipeline.main`` on a mesh, and the dry run. The gallery's
sharded functions are ``tests/test_torch_distributed_gallery.py``'s.

Every launch carries its own time limit (``LAUNCH_S``), which the
launcher's join enforces: a rank that hangs in a collective fails its test
and is terminated. The ranks run the bodies of ``tests/torch_dist_workers.py``,
which import torch and the port only.

Sizes and tolerances: ``effnetv2_tiny`` (embedding 32, head 32 -> 16),
48x48 views, a global batch of 4 (2 rows a rank), two steps of the
cosine-warmup schedule at lr 1e-3 (lr 0 at step 0), key 11, from the same
weights and views on both sides.

- W=2 against W=1: loss and running statistics within 1e-6 (the global
  BatchNorm sums over ranks in another order); the gradients at the start
  within 1e-3 by relative norm (measured 3.7e-5: the BatchNorms over 4
  rows amplify float order, as ``tests/test_torch_train.py`` states), so a
  gradient counted W times (off by 1 - 1/W) fails; Adam's ``mu``/``nu``, the moves' relative norm and every
  parameter under ``tests/test_torch_train.py``'s bounds; dropout masks
  bit-equal to rows of the one-device draw; both ranks' states equal.
- W=2 against the JAX step jitted with the views on a 2-device ``data``
  ``NamedSharding``: ``tests/test_torch_train.py``'s bounds at lr 1e-3.
"""

from __future__ import annotations

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from multimodal_biometric_fingerprints_palms_tpu.models import SSLModel as JSSL
from multimodal_biometric_fingerprints_palms_tpu.train import ssl_train as JT
from multimodal_biometric_fingerprints_palms_tpu.train.schedule import (
    cosine_warmup_schedule as j_schedule)
from multimodal_biometric_fingerprints_palms_tpu_torch import entry
from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
    ssl_variables_from_state)
from multimodal_biometric_fingerprints_palms_tpu_torch.models.projection_head import (
    flax_dropout)
from multimodal_biometric_fingerprints_palms_tpu_torch.parallel import (
    launch, mesh as tmesh)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import threefry
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
    load_msgpack)
import torch_dist_workers as W

torch.set_num_threads(1)

LAUNCH_S = 120.0
LR = 1e-3
MOMENT_RTOL, MOMENT_FLOOR, DELTA_RTOL = 2e-3, 1e-2, 1e-2


def _gone(pid_dir) -> bool:
    """Whether every rank that wrote a pid under ``pid_dir`` has ended."""
    pids = [int(p.read_text()) for p in pid_dir.iterdir()]
    assert pids
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        return False
    return True


def tree_max_abs(a, b) -> float:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(la, lb))


def moments_max_rel(want, got) -> float:
    """``tests/test_torch_train.py``'s: the largest difference of a leaf
    over its largest value, or over ``MOMENT_FLOOR`` of the tree's
    largest where that is more."""
    la = [np.asarray(a) for a in jax.tree.leaves(want)]
    lb = jax.tree.leaves(got)
    assert len(la) == len(lb)
    top = max(float(np.abs(a).max()) for a in la)
    return max(float(np.abs(a - np.asarray(b)).max())
               / max(float(np.abs(a).max()), MOMENT_FLOOR * top)
               for a, b in zip(la, lb))


def moves_rel_norm(start, want, got) -> float:
    move = lambda tree: np.concatenate([
        (np.asarray(a, np.float64) - np.asarray(s, np.float64)).ravel()
        for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(start))])
    dw, dg = move(want), move(got)
    return float(np.linalg.norm(dg - dw) / np.linalg.norm(dw))


# --- the mesh and the launcher -----------------------------------------------

@pytest.mark.parametrize("n", [2, 8])
def test_create_mesh_without_a_group_raises_and_names_the_launcher(n):
    with pytest.raises(ValueError, match=r"run_ranks.*torchrun"):
        tmesh.create_mesh(n, device="cpu")


def test_create_mesh_inside_a_group(tmp_path):
    out = launch.run_ranks(W.mesh_rank, 2, str(tmp_path), device="cpu",
                           timeout=LAUNCH_S)
    cpu = torch.device("cpu")
    for rank, got in enumerate(out):
        assert (got["size"], got["rank"], got["axis"]) == (2, rank, "rows")
        assert got["devices"] == (cpu, cpu)
        assert got["sharding"] == (cpu, "gallery")
        assert "process group has 2 ranks" in got["refused"]
    assert _gone(tmp_path)


def test_a_failing_rank_fails_the_parent_with_its_traceback(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="rank 1 of 2 failed") as e:
        launch.run_ranks(W.failing_rank, 2, str(tmp_path), device="cpu",
                         timeout=LAUNCH_S)
    assert "KeyError" in str(e.value) and "rank one's own failure" in str(
        e.value) and "failing_rank" in str(e.value)
    assert time.monotonic() - t0 < LAUNCH_S
    assert _gone(tmp_path)


@pytest.mark.parametrize("fn", [lambda: 1, W.failing_rank],
                         ids=["lambda", "unpicklable argument"])
def test_a_rank_that_cannot_start_names_the_pickling_failure(fn):
    """Spawned ranks pickle ``fn`` and ``args``: a lambda, or an argument
    such as a lock, fails ``start()``. The launcher raises that failure as
    a ``RankError`` chained from it, not the ``AssertionError`` of joining
    a process that never started."""
    import threading
    args = () if fn.__name__ == "<lambda>" else (threading.Lock(),)
    with pytest.raises(launch.RankError, match="picklable") as e:
        launch.run_ranks(fn, 2, *args, device="cpu", timeout=LAUNCH_S)
    assert "did not start" in str(e.value)
    assert isinstance(e.value.__cause__, (
        __import__("pickle").PicklingError, AttributeError, TypeError))
    assert not isinstance(e.value.__context__, AssertionError)


def test_a_hanging_collective_fails_at_the_time_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(launch.RankError, match="did not finish within 10 s"):
        launch.run_ranks(W.hanging_rank, 2, str(tmp_path), device="cpu",
                         timeout=10.0)
    assert time.monotonic() - t0 < 40
    assert _gone(tmp_path)


# --- the data-parallel SSL step ------------------------------------------------

@functools.cache
def _one_device() -> dict:
    return W.ssl_steps(tmesh.create_mesh(axis_name="data", device="cpu"), LR)


@functools.cache
def _two_ranks() -> list:
    return launch.run_ranks(W.ssl_steps_rank, 2, LR, device="cpu",
                            timeout=LAUNCH_S)


def _start():
    return ssl_variables_from_state(W.port_model().state_dict())["params"]


def _hold(want: dict, got: dict, k: int, loss_rtol: float, stats_atol: float):
    """Step ``k`` of ``got`` against ``want`` under the module's bounds."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    assert tree_max_abs(want["batch_stats"], got["batch_stats"]) <= stats_atol
    assert got["count"] == want["count"] == k + 1
    for name in ("mu", "nu"):
        assert moments_max_rel(want[name], got[name]) <= MOMENT_RTOL, name
    assert tree_max_abs(want["params"], got["params"]) <= 2 * LR + 1e-6
    if k == 0:
        assert tree_max_abs(_start(), got["params"]) == 0.0
    else:
        assert moves_rel_norm(_start(), want["params"],
                              got["params"]) <= DELTA_RTOL


@pytest.mark.parametrize("k", [0, 1])
def test_data_parallel_step_matches_one_device(k):
    """Loss and running statistics within 1e-6 of the one-device step;
    the update under the bounds of the module note."""
    want = _one_device()["steps"][k]
    for got in _two_ranks():
        got = got["steps"][k]
        assert abs(got["loss"] - want["loss"]) <= 1e-6
        _hold(want, got, k, 1e-6, 1e-6)


def test_data_parallel_gradients_are_the_global_batchs():
    """The summed gradients of the two ranks are the one-device ones: the
    relative norm of the difference is 1e-3 at most (measured 3.7e-5), where
    a gradient counted twice is off by 1/2 or more."""
    want = np.concatenate([g.ravel() for g in _one_device()["grads"]])
    for got in _two_ranks():
        got = np.concatenate([g.ravel() for g in got["grads"]])
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3
        assert np.linalg.norm(2 * got - want) / np.linalg.norm(want) > 0.5


def test_data_parallel_dropout_masks_are_rows_of_the_global_draw():
    want = _one_device()["mask"]
    assert want.shape == (W.B, W.TINY["proj_hidden_dim"])
    ones = torch.ones(W.B, W.TINY["proj_hidden_dim"])
    first = threefry.split(threefry.key(11))[1]
    np.testing.assert_array_equal(
        want, flax_dropout(ones, first, W.DROPOUT_PATH, 0.1).numpy() != 0)
    rows = [got["mask"] for got in _two_ranks()]
    np.testing.assert_array_equal(np.concatenate(rows), want)
    assert not np.array_equal(rows[0], rows[1])


def test_data_parallel_ranks_hold_equal_states():
    a, b = (r["steps"][-1] for r in _two_ranks())
    assert a["loss"] == b["loss"]
    for name in ("params", "batch_stats", "mu", "nu"):
        assert tree_max_abs(a[name], b[name]) == 0.0, name


@functools.cache
def _jax_two_steps() -> list:
    """The JAX package's step jitted with the views on a 2-device ``data``
    mesh, from the port's seeded weights: 2 steps."""
    v = ssl_variables_from_state(W.port_model().state_dict())
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(j_schedule(LR, 1, 3), weight_decay=1e-4))
    mesh = JMesh(np.asarray(jax.devices()[:2]), ("data",))
    rep, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    params = jax.tree.map(jnp.asarray, v["params"])
    state = jax.device_put(JT.SSLTrainState(
        params, jax.tree.map(jnp.asarray, v["batch_stats"]),
        tx.init(params), jnp.int32(0)), rep)
    step = jax.jit(JT.create_ssl_train_step(JSSL(**W.TINY), tx, 0.5))
    rng = jax.random.PRNGKey(11)
    out = []
    for k in range(2):
        xi, xj = (jax.device_put(x, data) for x in W.views(20 + k))
        rng, sub = jax.random.split(rng)
        state, loss = step(state, xi, xj, sub)
        got = jax.device_get(state)
        adam = got.opt_state[1][0]          # chain(clip, adamw)'s adam
        out.append(dict(loss=float(loss), params=got.params,
                        batch_stats=got.batch_stats, mu=adam.mu, nu=adam.nu,
                        count=int(adam.count)))
    return out


@pytest.mark.parametrize("k", [0, 1])
def test_data_parallel_step_matches_jax_on_a_data_mesh(k):
    """Against the JAX step over a 2-device ``data`` mesh, under
    ``tests/test_torch_train.py``'s bounds at lr 1e-3: loss within 1e-5
    relative, running statistics within 1e-4, Adam's moments, the moves
    and every parameter as in the module note."""
    want = _jax_two_steps()[k]
    got = _two_ranks()[0]["steps"][k]
    _hold(want, got, k, 1e-5, 1e-4)


# --- the loop, its checkpoints, the SSL pipeline -------------------------------

def test_train_ssl_on_two_ranks_writes_the_checkpoints_once(tmp_path):
    """Rank 0 writes every checkpoint and rank 1 none; the losses and the
    final checkpoint are the one-device run's, under the bounds
    ``tests/test_torch_train.py`` holds three steps at lr 1e-3 to: the
    losses within 1e-5 relative (measured 2.0e-6 after 3 moving steps),
    every parameter within ``2 lr + 1e-6`` and the running statistics
    within 1e-4 (measured 1.9e-5): Adam moves an element whose gradient is
    near 0 by about +-lr either way, and the later steps see that."""
    ranks = launch.run_ranks(W.train_loop_rank, 2, str(tmp_path / "w2"),
                             device="cpu", timeout=LAUNCH_S)
    one = W.train_loop(None, str(tmp_path / "w1"))
    assert ranks[0]["writes"] and ranks[1]["writes"] == []
    names = lambda writes: [os.path.basename(p) for p in writes]
    assert names(ranks[0]["writes"]) == names(one["writes"])
    assert sorted(p.name for p in (tmp_path / "w2").iterdir()) == sorted(
        p.name for p in (tmp_path / "w1").iterdir())
    for r in ranks:
        np.testing.assert_allclose(r["history"], one["history"], rtol=1e-5)
    got = load_msgpack(tmp_path / "w2" / "ssl_model_final.msgpack")
    want = load_msgpack(tmp_path / "w1" / "ssl_model_final.msgpack")
    assert got["step"] == want["step"] == 4
    assert tree_max_abs(want["params"], got["params"]) <= 2 * LR + 1e-6
    assert tree_max_abs(want["batch_stats"], got["batch_stats"]) <= 1e-4


def _pipeline_tree(root):
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (
        encode_png)
    d = root / "dataset" / "DBII"
    d.mkdir(parents=True)
    g = np.random.default_rng(0)
    for k in range(8):
        (d / f"{k // 4 + 1}_{k % 4 + 1}_1.png").write_bytes(
            encode_png(g.integers(0, 256, (64, 56), np.uint8)))
    cfg = {"paths": {"root_dir": str(root),
                     "dataset_dir": str(root / "dataset"),
                     "save_dir": str(root / "save"),
                     "figures_dir": str(root / "figures")},
           "ssl": {"dataset": {"batch_size": 4, "seed": 3, "image_size": 48},
                   "model": {"backbone": "effnetv2_tiny", "embedding_dim": 32,
                             "projection_hidden_dim": 32, "projection_dim": 16,
                             "projection_layers": 2, "use_predictor": True},
                   "training": {"epochs": 1, "lr": 1e-5, "warmup_epochs": 1,
                                "device_augment": True},
                   "clustering": {"n_clusters": 2, "pca_dim": 0}}}
    path = root / "classifier.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_pipeline_main_on_two_ranks_equals_one_device(tmp_path, monkeypatch):
    """``main(train=True, mesh=...)`` on 2 ranks trains on host views
    (``device_augment`` is ignored with a mesh, as in the JAX package),
    every rank returns the one-device run's result, and the files rank 0
    writes are the one-device run's: the CSV byte for byte. At the
    shipped config's lr (1e-5) the trained weights differ within 2 lr
    (see the loop's test), so the embeddings are held within 1e-4
    (measured 2.2e-5) and the cluster labels exactly."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.classifier.pipeline import (
        main)
    two, one = tmp_path / "two", tmp_path / "one"
    cfg2, cfg1 = _pipeline_tree(two), _pipeline_tree(one)
    ranks = launch.run_ranks(W.pipeline_rank, 2, str(cfg2), str(two),
                             device="cpu", timeout=LAUNCH_S)
    monkeypatch.chdir(one)
    want = main(str(cfg1), train=True,
                mesh=tmesh.create_mesh(axis_name="data", device="cpu"))
    assert want["training"]["branch"] == "host"
    for got in ranks:
        assert got["training"]["branch"] == "host"
        np.testing.assert_allclose(got["training"]["history"],
                                   want["training"]["history"], atol=1e-6)
        np.testing.assert_allclose(got["embeddings"], want["embeddings"],
                                   atol=1e-4)
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["num_ids"] == want["num_ids"]
    assert ((two / "save" / "id_clusters.csv").read_bytes().replace(
        bytes(two), b"") == (one / "save" / "id_clusters.csv").read_bytes(
        ).replace(bytes(one), b""))
    for name in ("clustering_report_detailed.json", "ssl_model_final.msgpack",
                 "embeddings.npz"):
        assert (two / "save" / name).is_file(), name
    assert (two / "figures" / "embeddings_clusters.png").is_file()


# --- the dry run ----------------------------------------------------------------

SMALL = dict(users=40, per_user=4, sample=2048, planted=32, full_cap=512,
             probes=4)


def test_dryrun_on_two_ranks():
    """The dry run's body on 2 gloo ranks at a small gallery: both ranks
    pass its assertions and report the same sweep."""
    lines = launch.run_ranks(entry.dryrun_rank, 2, SMALL, device="cpu",
                             timeout=LAUNCH_S)
    head = lambda s: s.split(": screen")[0]
    assert head(lines[0]) == head(lines[1])
    assert lines[0].startswith("dryrun_multichip(2): ssl loss=")
    assert "N=160 (2048 unique pairs" in lines[0]
    assert lines[0].endswith("batched identify P=4xN=160 "
                             + lines[0].rsplit(" ", 2)[-2] + " ok")


def test_dryrun_multichip_passes_polyus_sizes(monkeypatch, capsys):
    """``dryrun_multichip(n)`` runs the body on n ranks at the JAX dry
    run's PolyU sizes (``__graft_entry__.py``: 1,480 templates, a
    16,384-pair sample with 256 planted, a full pass of at most 4,096,
    4 probes) and prints rank 0's line."""
    seen = {}

    def fake(fn, n, sizes, device, timeout):
        seen.update(fn=fn, n=n, sizes=sizes, device=device)
        return ["line of rank 0", "line of rank 1"]

    monkeypatch.setattr(launch, "run_ranks", fake)
    assert entry.dryrun_multichip(2, device="cpu") == "line of rank 0"
    assert capsys.readouterr().out == "line of rank 0\n"
    assert seen == dict(fn=entry.dryrun_rank, n=2, sizes=entry.POLYU,
                        device="cpu")
    assert entry.POLYU["users"] * entry.POLYU["per_user"] == 1480
    assert (entry.POLYU["sample"], entry.POLYU["planted"],
            entry.POLYU["full_cap"], entry.POLYU["probes"]) == (
        16384, 256, 4096, 4)
