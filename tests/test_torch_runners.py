"""The port's file runners against the JAX package's, on the CPU.

A tiny dataset (3 users x 2 sessions of blob prints at 320x240, written by
OpenCV) goes through the JAX package's runners stage by stage and through
the port's ``pipeline.run_all(skip_ssl=True, device="cpu")``, each into its
own tree. The trees must hold the same files; the skeletons the two wrote
are held to the end-to-end bounds of ``tests/test_torch_enhance.py`` (<= 5%
of skeleton pixels, <= 2 valid minutiae per image); the device step alone
(the JPEG taken out) to the same bounds; and the matching protocol to the
same pair lists, CSV headers and, on one minutiae tree, to the matcher's
tolerance against the JAX package's XLA route
(``tests/test_torch_matching.py``: 1e-4).
"""

import csv
import json
import os

import cv2
import numpy as np
import pytest
import torch

from multimodal_biometric_fingerprints_palms_tpu_torch import pipeline
from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
    runner as tmrun)
from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
    runner as tprun)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    blob_prints)

torch.set_num_threads(1)

E2E_SKEL_MISMATCH = 0.05
E2E_COUNT_DIFF = 2
# the enhanced grey is the denoised grey under the hull mask: NLM's 2/255
# (tests/test_torch_enhance.py's DENOISE_ATOL) and one more level of
# rounding to uint8, except on the hull boundary pixels the masks differ on
ENHANCED_ATOL = 3
MASK_MISMATCH = 1e-3
SCORE_ATOL = 1e-4
USERS, SESSIONS = (1, 2, 3), (1, 2)
BATCH = len(USERS) * len(SESSIONS)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The dataset, the JAX package's runs and the port's ``run_all``, in
    a working directory of their own (the runners write their logs, the
    catalog and the matching reports relative to it)."""
    root = tmp_path_factory.mktemp("runners")
    cluster = root / "ds" / "sorted_dataset" / "cluster_0"
    cluster.mkdir(parents=True)
    names = [(u, s) for u in USERS for s in SESSIONS]
    prints = blob_prints([10 + u for u, _ in names],
                         [0.06 * (s - 1) for _, s in names], 320, 240)
    for (u, s), img in zip(names, prints):
        cv2.imwrite(str(cluster / f"{u}_1_{s}.jpg"),
                    np.round(img * 255).astype(np.uint8))
    cwd = os.getcwd()
    try:
        os.chdir(root)
        # imported here: the JAX runners open their log files on import
        from multimodal_biometric_fingerprints_palms_tpu.features.runner import (
            process_directory)
        from multimodal_biometric_fingerprints_palms_tpu.matching import (
            runner as jmrun)
        from multimodal_biometric_fingerprints_palms_tpu.preprocessing.runner import (
            run_preprocessing)
        jax_stats = run_preprocessing(root / "ds" / "sorted_dataset",
                                      root / "jax" / "processed",
                                      batch_size=BATCH)
        process_directory(root / "jax" / "processed" / "enhanced",
                          root / "jax" / "processed" / "minutiae",
                          batch_size=BATCH)
        jax_match = jmrun.main(demo=True, minutiae_base=str(
            root / "jax" / "processed" / "minutiae"),
            logs_dir=str(root / "jax" / "logs"))
        port = pipeline.run_all(str(root / "ds"), skip_ssl=True,
                                device="cpu")
    finally:
        os.chdir(cwd)
    return dict(root=root, jax_stats=jax_stats, jax_match=jax_match,
                port=port)


def _files(base):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*")
                  if p.is_file())


def test_runner_trees_hold_the_same_files(trees):
    root = trees["root"]
    port_files = _files(root / "ds" / "processed")
    assert port_files == _files(root / "jax" / "processed")
    assert len([f for f in port_files if f.endswith("_skeleton.jpg")]) == BATCH
    assert trees["port"]["preprocessing"]["num_images"] == BATCH
    assert trees["port"]["preprocessing"]["canonical_shape"] == (
        trees["jax_stats"]["canonical_shape"])


def test_skeletons_and_minutiae_within_the_enhance_bounds(trees):
    root = trees["root"]
    for rel in _files(root / "jax" / "processed" / "enhanced"):
        if not rel.endswith("_skeleton.jpg"):
            continue
        a = cv2.imread(str(root / "jax" / "processed" / "enhanced" / rel),
                       cv2.IMREAD_GRAYSCALE) > 127
        b = cv2.imread(str(root / "ds" / "processed" / "enhanced" / rel),
                       cv2.IMREAD_GRAYSCALE) > 127
        assert int((a != b).sum()) <= E2E_SKEL_MISMATCH * a.sum(), rel
        js = rel.replace("_skeleton.jpg", "_minutiae.json")
        na = len(json.loads((root / "jax/processed/minutiae" / js).read_text()))
        nb = len(json.loads((root / "ds/processed/minutiae" / js).read_text()))
        assert abs(na - nb) <= E2E_COUNT_DIFF, (rel, na, nb)
        assert nb >= 8, (rel, nb)


def test_device_step_matches_packed_pipeline_fn(trees):
    """The same uint8 batch through the JAX package's jitted runner step
    and the port's (no JPEG in between)."""
    from multimodal_biometric_fingerprints_palms_tpu.preprocessing.runner import (
        _packed_pipeline_fn)
    from multimodal_biometric_fingerprints_palms_tpu.utils.transfer import (
        host_unpackbits)
    cluster = trees["root"] / "ds" / "sorted_dataset" / "cluster_0"
    batch = np.zeros((BATCH, 320, 256), np.uint8)
    for j, p in enumerate(sorted(cluster.iterdir())):
        batch[j, :, :240] = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
    ref = {k: np.asarray(v) for k, v in _packed_pipeline_fn(
        False, None, True)(batch).items()}
    got = {k: v.numpy() for k, v in tprun._device_outputs(
        torch.from_numpy(batch), False, None, True).items()}
    sk_j = host_unpackbits(ref["skeleton"], 256)
    mask_j = host_unpackbits(ref["mask"], 256)
    assert int((got["skeleton"] != sk_j).sum()) <= E2E_SKEL_MISMATCH * sk_j.sum()
    mask_off = got["mask"] != mask_j
    assert int(mask_off.sum()) <= MASK_MISMATCH * mask_j.sum()
    d = np.abs(got["enhanced"].astype(int) - ref["enhanced"])
    assert d[~mask_off].max() <= ENHANCED_ATOL
    for k in ("normalized", "denoised"):
        assert got[k].dtype == ref[k].dtype == np.uint8


def _header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_matching_main_on_both_trees(trees, tmp_path, monkeypatch):
    root = trees["root"]
    jm, tm = trees["jax_match"], trees["port"]["matching"]
    for k in ("num_users", "num_samples", "genuine_pairs", "impostor_pairs"):
        assert tm[k] == jm[k], k
    assert (tm["num_users"], tm["genuine_pairs"]) == (len(USERS), len(USERS))
    for name in ("minutiae_stats.csv", "genuine_match_stats.csv"):
        assert _header(root / "logs" / name) == _header(
            root / "jax" / "logs" / name)
    for logs in (root / "logs", root / "jax" / "logs"):
        assert cv2.imread(str(logs / "roc.png")) is not None
    # the port's protocol on the JAX package's minutiae tree
    monkeypatch.chdir(tmp_path)
    same = tmrun.main(demo=True, minutiae_base=str(
        root / "jax" / "processed" / "minutiae"), logs_dir=str(tmp_path),
        device="cpu")
    np.testing.assert_allclose(same["genuine_scores"], jm["genuine_scores"],
                               rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(same["impostor_scores"], jm["impostor_scores"],
                               rtol=0, atol=SCORE_ATOL)
    assert same["eer"] == pytest.approx(jm["eer"], abs=1e-9)


def test_run_all_skip_ssl_end_to_end(trees):
    port = trees["port"]
    root = trees["root"]
    assert port["catalog_rows"] == BATCH
    assert port["features"]["num_images"] == BATCH
    assert set(port["seconds"]) == {"catalog", "preprocessing", "features",
                                    "matching"}
    assert set(port["preprocessing"]["seconds"]) == {"read", "device",
                                                     "encode", "write"}
    assert port["preprocessing"]["reader"] in ("native", "image_codec")
    m = port["matching"]
    assert np.isfinite(m["genuine_scores"]).all() and 0.0 <= m["eer"] <= 1.0
    assert (root / "data" / "metadata" / "catalog.csv").is_file()
    for name in ("minutiae_stats.csv", "genuine_match_stats.csv", "roc.png"):
        assert (root / "logs" / name).is_file()


def _raw_tree_and_config(tmp_path):
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (
        encode_png)
    d = tmp_path / "dataset" / "DBII"
    d.mkdir(parents=True)
    g = np.random.default_rng(0)
    for name in ("1_1_1.png", "1_2_1.png", "2_1_1.png", "2_2_1.png"):
        (d / name).write_bytes(encode_png(g.integers(60, 200, (96, 96),
                                                     dtype=np.uint8)))
    cfg = tmp_path / "classifier.yml"
    cfg.write_text(
        f"paths:\n  root_dir: {tmp_path}\n  save_dir: ./save_models\n"
        "ssl:\n  dataset:\n    batch_size: 2\n    image_size: 64\n"
        "  model:\n    backbone: effnetv2_tiny\n    embedding_dim: 16\n"
        "    projection_hidden_dim: 16\n    projection_dim: 8\n"
        "  training:\n    epochs: 1\n"
        "  clustering:\n    n_clusters: 2\n    pca_dim: 0\n")
    return cfg


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where CUDA is not available")
def test_run_all_without_skip_ssl_raises(tmp_path, monkeypatch):
    """The SSL branch runs on the card by default: without CUDA,
    ``run_all`` (``train=True``, no SSL checkpoint) raises before it trains,
    writes a CSV or sorts anything."""
    cfg = _raw_tree_and_config(tmp_path)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.run_all(str(tmp_path / "dataset"), classifier_config=str(cfg))
    assert not (tmp_path / "save_models").exists()
    assert not (tmp_path / "dataset" / "sorted_dataset").exists()


def test_run_all_trains_without_a_checkpoint(tmp_path, monkeypatch):
    """``run_all(train=True, device="cpu")`` with no SSL checkpoint trains
    one epoch of the tiny config (two steps of two images), writes
    ``ssl_model_final.msgpack`` in the JAX payload's layout, then clusters
    and sorts with the trained weights and runs the file stages."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (
        load_msgpack)
    cfg = _raw_tree_and_config(tmp_path)
    monkeypatch.chdir(tmp_path)
    res = pipeline.run_all(str(tmp_path / "dataset"),
                           classifier_config=str(cfg), train=True,
                           device="cpu")
    payload = load_msgpack(tmp_path / "save_models" / "ssl_model_final.msgpack")
    assert sorted(payload) == ["batch_stats", "params", "step"]
    assert payload["step"] == 2
    assert res["ssl"]["training"]["branch"] == "host"
    assert res["ssl"]["num_images"] == 4
    assert len(list((tmp_path / "dataset" / "sorted_dataset").rglob(
        "*.png"))) == 4
    assert res["catalog_rows"] == 4 and "matching" in res