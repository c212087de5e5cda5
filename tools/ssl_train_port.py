#!/usr/bin/env python3
"""SSL training of the port at PolyU DBII's scale, layer by layer, and the
SSL-quality protocol of ``benchmarks/ssl_at_scale.py`` on the port.

    python3 tools/ssl_train_port.py [--subjects 148] [--ids 256] [--per-id 8]
                                    [--steps 20] [--device cpu]

1. ``subjects`` x 10 PolyU-shaped JPEGs (``tools/polyu_set.write_raw``;
   148 subjects make PolyU's 1,480 files) and the shipped
   ``configs/config_classifier.yml`` (EfficientNetV2-S, 756 -> 512 -> 256,
   predictor on, 224 x 224, batch 16, lr 1e-5). Both SSL paths:
   - host views: ``steps`` steps broken down into host decode, host views
     (``FingerprintAugmentations``, in ``two_view_batches``' order), host
     to device, forward + backward, optimizer (each synchronized), then
     ``train_ssl`` itself for one epoch over every file;
   - device views: the set decoded once on the host, put on the device
     once, then ``steps`` steps broken down into views on the device
     (``classifier.augment_device``), forward + backward, optimizer, then
     ``train_ssl_device`` itself for one epoch.
2. The protocol of ``benchmarks/ssl_at_scale.py`` on the port's copy of its
   generator (``utils.synthetic.family_render``): ``ids`` x ``per_id``
   320 x 256 JPEGs of 8 ridge-pattern families, the reference's budget (3
   epochs, lr 1e-5, batch 16, warmup 5), trained by
   ``classifier.pipeline.main(train=True)`` with ``device_augment`` (the
   images share one shape), and the same set with seeded, untrained
   weights (``train=False``). For each, kmeans and agglomerative
   clustering of the embeddings (PCA to 100, 8 clusters, the pipeline's
   per-id rule): family purity (chance 1/8) and the largest over the
   smallest cluster.

Prints each part's numbers and, as its last line, one JSON object with
all of it. On the card unless given ``--device cpu``; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

from multimodal_biometric_fingerprints_palms_tpu_torch.classifier import (  # noqa: E402
    data as cdata, pipeline as ssl_pipeline)
from multimodal_biometric_fingerprints_palms_tpu_torch.clustering import (  # noqa: E402
    agglomerative_fast, kmeans, pca_reduce)
from multimodal_biometric_fingerprints_palms_tpu_torch.train import (  # noqa: E402
    ssl_train)
from multimodal_biometric_fingerprints_palms_tpu_torch.train.optim import (  # noqa: E402
    ClipAdamW)
from multimodal_biometric_fingerprints_palms_tpu_torch.train.schedule import (  # noqa: E402
    cosine_warmup_schedule)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (  # noqa: E402
    threefry)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (  # noqa: E402
    encode_jpeg)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.io import (  # noqa: E402
    read_image_grayscale)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (  # noqa: E402
    N_FAMILIES, family_params, family_render)

import polyu_set  # noqa: E402
from ssl_front_port import card_line, classifier_config  # noqa: E402


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Seconds by layer, each closed by a device synchronization."""

    def __init__(self, device):
        self.device, self.s = device, defaultdict(float)

    def __call__(self, layer, fn):
        _sync(self.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        self.s[layer] += time.perf_counter() - t0
        return out


def _training_args(cfg) -> dict:
    t = cfg.ssl.training
    return dict(lr=t.get("lr", 1e-5), weight_decay=t.get("weight_decay", 1e-5),
                grad_clip=t.get("grad_clip", 1.0),
                warmup_epochs=t.get("warmup_epochs", 5),
                temperature=t.get("temperature", 0.5))


def breakdown_host(cfg, paths, steps, device) -> dict:
    """``steps`` steps of host views, by layer (``two_view_batches``'
    draws: decode a file, then its two views)."""
    d, a = cfg.ssl.dataset, _training_args(cfg)
    batch, size, seed = d.get("batch_size"), d.get("image_size"), d.get("seed")
    model = ssl_pipeline.build_model(cfg).to(device)
    n_spe = len(paths) // batch
    tx = ClipAdamW(a["grad_clip"], cosine_warmup_schedule(
        a["lr"], a["warmup_epochs"] * n_spe, 3 * n_spe), a["weight_decay"])
    ssl_train.init_ssl_state(model, threefry.key(seed), (size, size), tx)
    params = list(model.parameters())
    opt = tx.init(params)
    rng = np.random.default_rng(seed + 1)
    aug = cdata.FingerprintAugmentations(size, rng)
    order = rng.permutation(len(paths))
    key = threefry.key(seed)
    clock = Clock(device)
    for b in range(steps + 1):
        if b == 1:                                   # step 0 warms up
            clock.s.clear()
        xi, xj = [], []
        for p in order[b * batch:(b + 1) * batch]:
            img = clock("host decode", lambda: read_image_grayscale(paths[p]))
            xi.append(clock("host views", lambda: aug(img)))
            xj.append(clock("host views", lambda: aug(img)))
        ti, tj = clock("host to device", lambda: (
            torch.from_numpy(np.stack(xi)).to(device),
            torch.from_numpy(np.stack(xj)).to(device)))
        key, sub = threefry.split(key)
        _, grads = clock("forward + backward", lambda: ssl_train.ssl_loss_and_grads(
            model, ti, tj, sub, a["temperature"]))
        clock("optimizer", lambda: tx.step(params, grads, opt))
    return {k: v / steps for k, v in clock.s.items()}


def breakdown_device(cfg, data, steps, device) -> dict:
    """The device path's layers: decode (once, per file) and upload (once)
    are timed by the caller; here ``steps`` steps of views, forward +
    backward and optimizer."""
    d, a = cfg.ssl.dataset, _training_args(cfg)
    batch, size, seed = d.get("batch_size"), d.get("image_size"), d.get("seed")
    model = ssl_pipeline.build_model(cfg).to(device)
    n = data.shape[0]
    tx = ClipAdamW(a["grad_clip"], cosine_warmup_schedule(
        a["lr"], a["warmup_epochs"] * (n // batch), 3 * (n // batch)),
        a["weight_decay"])
    ssl_train.init_ssl_state(model, threefry.key(seed), (size, size), tx)
    params = list(model.parameters())
    opt = tx.init(params)
    clock = Clock(device)
    data_dev = clock("upload (once)", lambda: torch.from_numpy(data).to(device))
    order = np.random.default_rng(seed).permutation(n)
    key = threefry.key(seed)
    upload = clock.s["upload (once)"]
    for b in range(steps + 1):
        if b == 1:
            clock.s.clear()
        idx = torch.from_numpy(order[b * batch:(b + 1) * batch]).to(device)
        key, sub = threefry.split(key)
        xi, xj = clock("device views", lambda: ssl_train.device_views(
            data_dev, idx, sub, size))
        _, grads = clock("forward + backward", lambda: ssl_train.ssl_loss_and_grads(
            model, xi, xj, threefry.fold_in(sub, 2), a["temperature"]))
        clock("optimizer", lambda: tx.step(params, grads, opt))
    out = {k: v / steps for k, v in clock.s.items()}
    out["upload s (once)"] = upload
    return out


def scale_run(root: Path, subjects: int, steps: int, device) -> dict:
    """Part 1: both paths at ``subjects`` x 10 files."""
    cfg_path = classifier_config(root)
    cfg = ssl_pipeline.load_classifier_config(cfg_path)
    d, a = cfg.ssl.dataset, _training_args(cfg)
    batch, size, seed = d.get("batch_size"), d.get("image_size"), d.get("seed")
    polyu_set.write_raw(root / "dataset", subjects)
    paths = cdata.collect_image_paths([root / "dataset" / "DBII"])
    spe = len(paths) // batch
    out = {"files": len(paths), "steps_per_epoch": spe}
    out["host_layers_s_per_step"] = breakdown_host(cfg, paths, steps, device)

    def batches():
        return cdata.two_view_batches(paths, batch, size, seed=seed + 1)

    model = ssl_pipeline.build_model(cfg)
    _sync(device)
    t0 = time.perf_counter()
    _, hist = ssl_train.train_ssl(model, batches, spe, epochs=1,
                                  input_shape=(size, size), seed=seed,
                                  save_dir=root / "save_host", device=device,
                                  **a)
    _sync(device)
    out["host_epoch_s"] = time.perf_counter() - t0
    out["host_epoch_loss"] = hist[0]

    t0 = time.perf_counter()
    data = np.stack([read_image_grayscale(p) for p in paths])
    decode_s = time.perf_counter() - t0
    dev_layers = breakdown_device(cfg, data, steps, device)
    dev_layers["host decode s (once)"] = decode_s
    out["device_layers_s_per_step"] = dev_layers
    model = ssl_pipeline.build_model(cfg)
    _sync(device)
    t0 = time.perf_counter()
    _, dhist = ssl_train.train_ssl_device(model, data, batch, epochs=1,
                                          image_size=size, seed=seed,
                                          save_dir=root / "save_dev",
                                          device=device, **a)
    _sync(device)
    out["device_epoch_s"] = time.perf_counter() - t0
    out["device_epoch_loss"] = dhist[0]
    out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else None)
    return out


def gen_dataset(root: Path, n_ids: int, per_id: int, seed: int = 0) -> dict:
    """The protocol's set, as ``benchmarks/ssl_at_scale.gen_dataset``
    writes it (the port's JPEG encoder, byte-equal to OpenCV's)."""
    rng = np.random.default_rng(seed)
    out = root / "DBII"
    out.mkdir(parents=True, exist_ok=True)
    fam_of_id = {}
    for i in range(n_ids):
        fam = i % N_FAMILIES
        fam_of_id[str(i + 1)] = fam
        fp = family_params(rng, fam)
        for s in range(per_id):
            (out / f"{i + 1}_1_{s + 1}.jpg").write_bytes(
                encode_jpeg(family_render(rng, fp)))
    return fam_of_id


def quality(emb: np.ndarray, paths, fam_of_id: dict, seed: int,
            device) -> dict:
    """kmeans and agglomerative on the PCA projection: family purity of
    the per-id labels (the pipeline's rule: the label of the sample nearest
    the id's mean embedding) and the file clusters' sizes."""
    x = torch.from_numpy(np.asarray(emb, np.float32)).to(device)
    if x.shape[1] > 100 and x.shape[0] > 100:
        x = pca_reduce(x, 100, device=device)[0]
    runs = {"kmeans": kmeans(threefry.key(seed), x, N_FAMILIES,
                             device=device)[0],
            "agglomerative": agglomerative_fast(threefry.key(seed), x,
                                                N_FAMILIES, device=device)}
    ids = defaultdict(list)
    for k, p in enumerate(paths):
        ids[cdata.extract_id(Path(p).name)].append(k)
    out = {}
    for name, labels in runs.items():
        labels = labels.cpu().numpy()
        by_cluster = defaultdict(list)
        for gid, rows in ids.items():
            mean = emb[rows].mean(axis=0)
            near = int(np.argmin(np.linalg.norm(emb - mean, axis=1)))
            by_cluster[int(labels[near])].append(fam_of_id[gid])
        total = sum(len(v) for v in by_cluster.values())
        major = sum(Counter(v).most_common(1)[0][1]
                    for v in by_cluster.values())
        sizes = np.bincount(labels, minlength=N_FAMILIES)
        out[name] = {"family_purity": major / max(total, 1),
                     "cluster_sizes": sizes.tolist(),
                     "max_min_ratio": (float(sizes.max() / sizes.min())
                                       if sizes.min() > 0 else None)}
    return out


def quality_run(root: Path, n_ids: int, per_id: int, device) -> dict:
    """Part 2: the ssl_at_scale protocol, trained and untrained."""
    data_dir = root / "dataset"
    t0 = time.perf_counter()
    fam_of_id = gen_dataset(data_dir, n_ids, per_id)
    gen_s = time.perf_counter() - t0
    out = {"ids": n_ids, "per_id": per_id, "families": N_FAMILIES,
           "images": n_ids * per_id, "chance_purity": 1.0 / N_FAMILIES,
           "generate_s": gen_s}
    for arm, train in (("untrained", False), ("trained", True)):
        arm_root = root / arm
        arm_root.mkdir()
        cfg_path = classifier_config(arm_root)
        text = cfg_path.read_text().replace(
            "    warmup_epochs: 5\n",
            "    warmup_epochs: 5\n    device_augment: true\n")
        cfg_path.write_text(text)
        cfg = ssl_pipeline.load_classifier_config(cfg_path)
        cwd = os.getcwd()
        os.chdir(arm_root)
        try:
            t0 = time.perf_counter()
            res = ssl_pipeline.main(str(cfg_path), [data_dir / "DBII"],
                                    train=train, device=device)
            secs = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        paths = cdata.collect_image_paths([data_dir / "DBII"])
        out[arm] = {"seconds": secs, "steps_seconds": res["seconds"],
                    **({"training": res["training"]} if train else {}),
                    "epochs": cfg.ssl.training.get("epochs"),
                    "lr": cfg.ssl.training.get("lr"),
                    **quality(res["embeddings"], paths, fam_of_id,
                              int(cfg.ssl.dataset.get("seed")), device)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subjects", type=int, default=148)
    ap.add_argument("--ids", type=int, default=256)
    ap.add_argument("--per-id", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20,
                    help="timed steps of each path's breakdown")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device, "ssl_train_port")
    card = card_line() if device.type == "cuda" else None
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"), "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)                  # the trainers' relative logs
        try:
            (Path(tmp) / "scale").mkdir()
            out["scale"] = scale_run(Path(tmp) / "scale", args.subjects,
                                     args.steps, device)
            s = out["scale"]
            print(f"card: {card}")
            print(f"{s['files']} files: host views a step (s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in s["host_layers_s_per_step"].items())
                + f"; train_ssl epoch {s['host_epoch_s']:.2f} s")
            print("device views a step (s): " + ", ".join(
                f"{k} {v:.4f}" for k, v in s["device_layers_s_per_step"].items())
                + f"; train_ssl_device epoch {s['device_epoch_s']:.2f} s")
            if args.ids:
                (Path(tmp) / "quality").mkdir()
                out["quality"] = quality_run(Path(tmp) / "quality", args.ids,
                                             args.per_id, device)
                for arm in ("untrained", "trained"):
                    q = out["quality"][arm]
                    print(f"{arm}: " + "; ".join(
                        f"{m} purity {q[m]['family_purity']:.4f}, sizes "
                        f"{q[m]['cluster_sizes']}"
                        for m in ("kmeans", "agglomerative"))
                        + f" ({q['seconds']:.1f} s)")
        finally:
            os.chdir(cwd)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
