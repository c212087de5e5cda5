"""The port's SSL front against the JAX package's and OpenCV: the numpy
counterparts of ``cv2.resize``, ``cv2.blur``, ``cv2.getRotationMatrix2D``
and ``cv2.warpAffine`` (``utils/cvcompat.py``), ``preprocess_image``, image
discovery and subject ids, ``extract_embeddings`` with its npz cache, the
cluster sorter, and ``classifier.pipeline.main(train=False)`` end to end
from a JAX-written checkpoint.

What is exact and what is not (measured against OpenCV 5.0): area
resizes of uint8 and float32 exact; the float32
linear resize within 2.4e-7 (measured 1.19e-07: OpenCV's vector code
rounds some products once more than the port); the uint8 linear resize
within 1 LSB (74 of 76,800 and 63 of 65,536 pixels; no path of the port
takes it on PolyU or NIST frames); blur, the rotation matrix and the warp bit-equal (OpenCV 4.11 and
later; earlier versions cut warp coordinates to 1/32 pixel);
``preprocess_image`` and its orientation bin bit-equal."""

import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from multimodal_biometric_fingerprints_palms_tpu.classifier import (
    data as JD, embeddings as JE, sorter as JS)
from multimodal_biometric_fingerprints_palms_tpu.classifier.pipeline import (
    main as j_main)
from multimodal_biometric_fingerprints_palms_tpu.models import SSLModel as JSSL
from multimodal_biometric_fingerprints_palms_tpu_torch.classifier import (
    data as TD, embeddings as TE, sorter as TS)
from multimodal_biometric_fingerprints_palms_tpu_torch.classifier.pipeline import (
    main as t_main)
from multimodal_biometric_fingerprints_palms_tpu_torch.models import (
    SSLModel, seed_weights, ssl_variables_from_state)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import cvcompat
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (
    blob_prints)

torch.set_num_threads(1)

TINY = dict(backbone_name="effnetv2_tiny", embedding_dim=32,
            proj_hidden_dim=32, proj_output_dim=16)


def prints(seeds, h=320, w=240):
    return [np.round(p * 255.0).astype(np.uint8)
            for p in blob_prints(list(seeds), None, h, w)]


FRAMES = {"polyu": prints([11])[0],                        # 320 x 240
          "nist": np.random.default_rng(0).integers(
              0, 256, (512, 512), dtype=np.uint8),          # NIST-shaped
          "ratio2": np.random.default_rng(1).integers(
              0, 256, (448, 448), dtype=np.uint8),          # integer ratio
          "small": np.random.default_rng(2).integers(
              0, 256, (200, 180), dtype=np.uint8)}          # an axis grows


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("size", [(224, 224), (256, 256)])
def test_area_resize_matches_opencv(frame, size):
    """INTER_AREA, uint8 and float32 exact on all three OpenCV paths (the
    float integer-ratio path sums in OpenCV's order, the growing axis
    rounds each product)."""
    img = FRAMES[frame]
    got = cvcompat.resize(img, size, cvcompat.INTER_AREA)
    np.testing.assert_array_equal(
        got, cv2.resize(img, size, interpolation=cv2.INTER_AREA))
    f = img.astype(np.float32) / 255.0
    np.testing.assert_array_equal(
        cvcompat.resize(f, size, cvcompat.INTER_AREA),
        cv2.resize(f, size, interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("size", [(240, 320), (256, 256), (300, 100)])
def test_linear_resize_matches_opencv(size):
    """The segmentation's resize back to the frame: float32 within 2.4e-7;
    uint8 within 1 LSB on at most 0.2% of pixels."""
    prob = np.random.default_rng(3).random((256, 256), np.float32)
    np.testing.assert_allclose(cvcompat.resize(prob, size), cv2.resize(prob, size),
                               rtol=0, atol=2.4e-7)
    u8 = FRAMES["small"]
    d = np.abs(cvcompat.resize(u8, size).astype(int) - cv2.resize(u8, size))
    assert d.max() <= 1 and (d > 0).sum() <= 0.002 * d.size


@pytest.mark.parametrize("frame", ["polyu", "nist"])
def test_blur_matches_opencv(frame):
    """15x15 box, BORDER_REFLECT_101: bit-equal on an image and on the
    squared deviations the contrast normalisation blurs."""
    img = cv2.resize(FRAMES[frame], (224, 224),
                     interpolation=cv2.INTER_AREA).astype(np.float32) / 255.0
    mean = cv2.blur(img, (15, 15))
    np.testing.assert_array_equal(cvcompat.blur(img, (15, 15)), mean)
    sq = (img - mean) ** 2
    np.testing.assert_array_equal(cvcompat.blur(sq, (15, 15)),
                                  cv2.blur(sq, (15, 15)))


@pytest.mark.parametrize("shape", [(224, 224), (256, 256), (320, 240)])
def test_rotation_and_warp_match_opencv(shape):
    """getRotationMatrix2D equal; warpAffine (INTER_LINEAR,
    BORDER_REFLECT_101) bit-equal over 26 angles."""
    img = np.random.default_rng(4).random(shape, np.float32)
    h, w = shape
    for angle in np.degrees(np.linspace(-np.pi, np.pi, 181))[::7]:
        m = cv2.getRotationMatrix2D((w // 2, h // 2), float(angle), 1.0)
        mine = cvcompat.rotation_matrix_2d((w // 2, h // 2), float(angle), 1.0)
        np.testing.assert_array_equal(mine, m)
        np.testing.assert_array_equal(
            cvcompat.warp_affine_linear(img, mine, (w, h)),
            cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                           borderMode=cv2.BORDER_REFLECT_101))


@pytest.mark.parametrize("frame", ["polyu", "nist", "ratio2"])
@pytest.mark.parametrize("size", [(224, 224), (256, 256)])
def test_preprocess_image_matches_jax(frame, size):
    """Bit-equal, and the dominant-orientation bin itself equal (an ulp in
    the contrast normalisation could move it and rotate the image)."""
    img = FRAMES[frame]
    np.testing.assert_array_equal(TD.preprocess_image(img, size),
                                  JD.preprocess_image(img, size))
    j = JD.local_contrast_normalization(cv2.resize(
        img, size, interpolation=cv2.INTER_AREA).astype(np.float32) / 255.0)
    t = TD.local_contrast_normalization(cvcompat.resize(
        img, size, cvcompat.INTER_AREA).astype(np.float32) / 255.0)
    assert (TD.estimate_dominant_orientation(t)
            == JD.estimate_dominant_orientation(j))


def test_preprocess_from_files_and_unreadable(tmp_path):
    """From a JPEG on disk (the port's codec decodes as OpenCV does), and
    a file neither reads gives the zero image in both."""
    cv2.imwrite(str(tmp_path / "1_1_1.jpg"), FRAMES["polyu"])
    (tmp_path / "2_1_1.jpg").write_bytes(b"not a jpeg")
    for name in ("1_1_1.jpg", "2_1_1.jpg"):
        np.testing.assert_array_equal(
            TD.preprocess_image(tmp_path / name, (224, 224)),
            JD.preprocess_image(tmp_path / name, (224, 224)))


def test_paths_and_ids_match_jax(tmp_path):
    for rel in ("DBII/1_1_1.jpg", "DBII/sub/012_2_1.png", "Nist/F0001_01.png",
                "Nist/F0123_02.bmp", "other/x_1.jpeg", "DBII/skip.tif"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    dirs = [tmp_path / "DBII", tmp_path / "Nist", tmp_path / "other"]
    assert TD.collect_image_paths(dirs) == JD.collect_image_paths(dirs)
    for p in TD.collect_image_paths(dirs):
        assert TD.extract_id(p.name) == JD.extract_id(p.name)
        assert TD.global_id_for(p) == JD.global_id_for(p)
    for name in ("F0001_01", "f0999_12.png", "0007_1_1.jpg", "000_1.jpg",
                 "F12_01.png"):
        assert TD.extract_id(name) == JD.extract_id(name)


def write_tree(root: Path, subjects=2, impressions=4, size=(120, 100)):
    """DBII-style ``<subject>_<impression>_1.jpg`` prints, written by
    OpenCV."""
    d = root / "dataset" / "DBII"
    d.mkdir(parents=True)
    h, w = size
    for s in range(1, subjects + 1):
        imgs = [np.round(p * 255.0).astype(np.uint8) for p in blob_prints(
            [20 + s] * impressions, [0.07 * k for k in range(impressions)], h, w)]
        for k, img in enumerate(imgs, 1):
            cv2.imwrite(str(d / f"{s}_{k}_1.jpg"), img)
    return d


def tiny_models(seed=3):
    tm = seed_weights(SSLModel(**TINY), seed).eval()
    return tm, JSSL(**TINY), ssl_variables_from_state(tm.state_dict())


def test_extract_embeddings_matches_jax(tmp_path):
    """6 files, tiny plan, batch 4 (the port's last batch is not padded):
    within 1e-5, the same kept paths, the cache in the JAX file's layout
    and read back by both."""
    d = write_tree(tmp_path, subjects=2, impressions=3)
    paths = JD.collect_image_paths([d])
    tm, jm, v = tiny_models()
    want, wpaths = JE.extract_embeddings(jm, v, paths, batch_size=4,
                                         image_size=64,
                                         cache_file=tmp_path / "j.npz")
    got, gpaths = TE.extract_embeddings(tm, paths, batch_size=4, image_size=64,
                                        cache_file=tmp_path / "t.npz")
    assert gpaths == wpaths and got.shape == want.shape == (6, 16)
    np.testing.assert_allclose(got, want, atol=1e-5)
    jz, tz = np.load(tmp_path / "j.npz", allow_pickle=True), np.load(
        tmp_path / "t.npz", allow_pickle=True)
    assert sorted(jz.files) == sorted(tz.files)
    assert tz["paths"].dtype == jz["paths"].dtype == object
    cached, cpaths = JE.extract_embeddings(jm, v, [], cache_file=tmp_path / "t.npz")
    np.testing.assert_array_equal(cached, got)
    assert cpaths == gpaths
    emb, _ = TE.extract_embeddings(tm, paths, batch_size=4, image_size=64,
                                   use_projection=False)
    np.testing.assert_allclose(emb, JE.extract_embeddings(
        jm, v, paths, batch_size=4, image_size=64, use_projection=False)[0],
        atol=1e-5)


def test_sorter_matches_jax(tmp_path):
    """Copies (with dedup renames and a missing source), purity and the
    report, embedding metrics within 1e-5."""
    src = tmp_path / "src"
    (src / "a").mkdir(parents=True)
    (src / "b").mkdir()
    rows, g = [], np.random.default_rng(5)
    for i in range(10):
        sub = "a" if i < 6 else "b"
        p = src / sub / f"{i % 6}_1_1.jpg"
        p.write_bytes(bytes([i]))
        rows.append([p.name, str(p), f"DBII_{i % 3}", int(i % 3 == 2)])
    rows.append(["gone.jpg", str(src / "gone.jpg"), "DBII_9", 1])
    csv_path = tmp_path / "id_clusters.csv"
    with open(csv_path, "w") as f:
        f.write("filename,path,global_id,cluster_label\n")
        f.writelines(",".join(map(str, r)) + "\n" for r in rows)
    emb = g.normal(size=(len(rows), 8)).astype(np.float32)
    np.savez(tmp_path / "emb.npz", embeddings=emb,
             paths=np.asarray([r[1] for r in rows], dtype=object))
    reports = {}
    for name, fn in (("jax", JS.main), ("port", TS.main)):
        kw = {"device": "cpu"} if name == "port" else {}
        reports[name] = fn(csv_path, tmp_path / "emb.npz", tmp_path / name,
                           report_path=tmp_path / f"{name}.json", **kw)
    listing = {name: sorted(str(p.relative_to(tmp_path / name))
                            for p in (tmp_path / name).rglob("*") if p.is_file())
               for name in ("jax", "port")}
    assert listing["port"] == listing["jax"] and len(listing["jax"]) == 10
    for rel in listing["jax"]:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "jax" / rel).read_bytes())
    j, t = (json.loads((tmp_path / f"{n}.json").read_text())
            for n in ("jax", "port"))
    jm_, tm_ = j.pop("embedding_metrics"), t.pop("embedding_metrics")
    assert t == j
    for k in ("silhouette_cosine", "davies_bouldin", "calinski_harabasz"):
        assert abs(tm_[k] - jm_[k]) <= 1e-5 * max(1.0, abs(jm_[k]))
    assert {k: tm_[k] for k in ("cluster_sizes", "n_samples", "embedding_stats")} == \
        {k: jm_[k] for k in ("cluster_sizes", "n_samples", "embedding_stats")}


def write_config(root: Path, save: str, seed=0) -> Path:
    cfg = {
        "paths": {"root_dir": str(root), "dataset_dir": str(root / "dataset"),
                  "save_dir": str(root / save),
                  "figures_dir": str(root / save / "fig")},
        "ssl": {
            "dataset": {"batch_size": 4, "seed": seed, "image_size": 64},
            "model": {"backbone": "effnetv2_tiny", "embedding_dim": 32,
                      "projection_hidden_dim": 32, "projection_dim": 16,
                      "projection_layers": 2, "use_predictor": True},
            "training": {"epochs": 1},
            "clustering": {"n_clusters": 2, "pca_dim": 0},
            "visualization": {"method": "pca", "max_points": 100},
        },
    }
    path = root / f"{save}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_ssl_pipeline_matches_jax(tmp_path):
    """``main(train=False)`` from a JAX-written tiny checkpoint, 2 subjects
    x 4 impressions: equal ``id_clusters.csv`` rows, embeddings within
    1e-5; then the port's sorter fills ``cluster_*`` with every file once."""
    import flax.serialization as fs
    write_tree(tmp_path)
    _, _, v = tiny_models(seed=9)
    for save in ("jax", "port"):
        (tmp_path / save).mkdir()
        (tmp_path / save / "ssl_model_final.msgpack").write_bytes(
            fs.to_bytes({"params": v["params"], "batch_stats": v["batch_stats"],
                         "step": 1}))
    want = j_main(str(write_config(tmp_path, "jax")), train=False)
    got = t_main(str(write_config(tmp_path, "port")), train=False, device="cpu")
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], atol=1e-5)
    assert (got["num_images"], got["num_ids"]) == (want["num_images"], want["num_ids"]) == (8, 2)
    np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))
    assert ((tmp_path / "port" / "id_clusters.csv").read_text()
            == (tmp_path / "jax" / "id_clusters.csv").read_text())
    jr = json.loads((tmp_path / "jax" / "clustering_report_detailed.json").read_text())
    tr = json.loads((tmp_path / "port" / "clustering_report_detailed.json").read_text())
    assert tr["cluster_sizes"] == jr["cluster_sizes"]
    assert tr["method"] == jr["method"] == "kmeans"
    assert abs(tr["inertia"] - jr["inertia"]) <= 1e-5 * max(1.0, jr["inertia"])
    assert set(got["seconds"]) >= {"embeddings", "pca", "cluster", "csv"}
    rep = TS.main(got["csv_path"], tmp_path / "port" / "embeddings.npz",
                  tmp_path / "sorted", report_path=tmp_path / "r.json",
                  device="cpu")
    files = sorted(p.name for p in (tmp_path / "sorted").rglob("*.jpg"))
    assert files == sorted(p.name for p in (tmp_path / "dataset").rglob("*.jpg"))
    assert sum(rep["cluster_counts"].values()) == 8
    shutil.rmtree(tmp_path / "sorted")


def test_ssl_pipeline_without_checkpoint(tmp_path):
    """``train=False``: seeded weights, the same on every call, and no
    checkpoint written. (``train=True`` trains: ``tests/test_torch_train.py``
    runs both of its branches.)"""
    write_tree(tmp_path, subjects=2, impressions=2)
    cfg = str(write_config(tmp_path, "port", seed=5))
    a = t_main(cfg, train=False, device="cpu")
    (tmp_path / "port" / "embeddings.npz").unlink()
    b = t_main(cfg, train=False, device="cpu")
    np.testing.assert_array_equal(a["embeddings"], b["embeddings"])
    assert "training" not in a
    assert not (tmp_path / "port" / "ssl_model_final.msgpack").exists()
