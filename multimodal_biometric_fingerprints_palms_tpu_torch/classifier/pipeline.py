"""SSL pipeline of the port (the JAX package's ``classifier/pipeline.py``),
on the card unless given ``device="cpu"``:

discover dataset/{DBII,Nist} -> load (or seed) the SSL model -> extract
embeddings (npz cache) -> PCA -> kmeans or agglomerative clustering + JSON
report -> per-ID mean embedding keyed {DBII|NIST}_{id} -> ID -> cluster via
the sample nearest that mean -> ``id_clusters.csv`` (filename, path,
global_id, cluster_label).

Weights: ``<save_dir>/ssl_model_final.msgpack``, the JAX package's
checkpoint format (``utils/checkpoint.py``), when it exists. Without one,
``train=True`` trains on ``device`` and writes it (``train/ssl_train.py``):
with ``ssl.training.device_augment`` and images of one shape the uint8 set
goes to the device and the views are rendered there
(``train_ssl_device``), otherwise (logged, as in the JAX package) host
``two_view_batches`` with seed ``seed + epoch number`` (``train_ssl``).
Initial weights, and with ``train=False`` the serving weights, are seeded
from ``ssl.dataset.seed`` through an explicit ``torch.Generator`` with
flax's initialisers (``models.seed_weights``: lecun normal kernels, zero
biases, unit BatchNorm): flax's own draws cannot be reproduced without
flax, so untrained embeddings, and the clusters built on them, differ from
the JAX package's. ``ssl.model.freeze_backbone`` is read by neither
trainer (the JAX package's ignores it too: ``ROADMAP.md`` queue 3).

After the clustering report, the embedding scatter is drawn as the JAX
pipeline draws it: ``ssl.visualization.method`` and ``max_points``, into
``paths.figures_dir``/``embeddings_clusters.png``
(``classifier/visualize.py``: the 2-D reduction in torch on ``device``, a
numpy raster written through the port's codec, where the JAX package uses
scikit-learn and matplotlib). As there, a figure that fails is logged as a
warning and does not stop the pipeline; nothing retries it on the CPU.
"""

from __future__ import annotations

import csv
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..clustering import (agglomerative_fast, evaluate_clustering, kmeans,
                          pca_reduce)
from ..config import load_classifier_config
from ..models.convert import load_jax_variables
from ..models.seeding import seed_weights
from ..models.ssl_model import SSLModel
from ..utils import threefry
from ..utils.checkpoint import load_msgpack
from ..utils.device import resolve_device
from ..utils.image_codec import ImageFormatError
from ..utils.io import read_image_grayscale
from ..utils.logging import console_step, get_file_logger
from .data import collect_image_paths, global_id_for, two_view_batches
from .embeddings import extract_embeddings

logger = get_file_logger(__name__, "data/metadata/train.log")

def build_model(cfg) -> SSLModel:
    m = cfg.ssl.model
    return SSLModel(
        backbone_name=m.get("backbone", "effnetv2_s"),
        embedding_dim=m.get("embedding_dim", 756),
        proj_hidden_dim=m.get("projection_hidden_dim", 512),
        proj_output_dim=m.get("projection_dim", 256),
        proj_num_layers=m.get("projection_layers", 2),
        use_predictor=m.get("use_predictor", True),
    )


def discover_dataset_dirs(base: str | Path) -> list[Path]:
    """``base/DBII`` and ``base/Nist`` where they exist, else ``base``."""
    base = Path(base)
    dirs = [d for d in (base / "DBII", base / "Nist") if d.exists()]
    return dirs or [base]


def _uniform_set(paths) -> np.ndarray | None:
    """The images stacked as (N, H, W) uint8 when every file reads and all
    share one shape, else None."""
    imgs = []
    for p in paths:
        try:
            imgs.append(read_image_grayscale(p))
        except (OSError, ImageFormatError):
            return None
    if len({im.shape for im in imgs}) != 1:
        return None
    return np.stack(imgs)


def train_ssl_model(cfg, model: SSLModel, paths, save_dir: Path, mesh,
                    device) -> dict:
    """Train ``model`` as the JAX pipeline does (see the module note);
    writes ``<save_dir>/ssl_model_final.msgpack``. Returns the trainer's
    history and which branch ran."""
    from ..train.ssl_train import train_ssl, train_ssl_device
    tcfg, dcfg = cfg.ssl.training, cfg.ssl.dataset
    image_size = dcfg.get("image_size", 224)
    batch_size = dcfg.get("batch_size", 16)
    seed = dcfg.get("seed", 42)
    common = dict(
        epochs=tcfg.get("epochs", 3), lr=tcfg.get("lr", 1e-5),
        weight_decay=tcfg.get("weight_decay", 1e-5),
        grad_clip=tcfg.get("grad_clip", 1.0),
        warmup_epochs=tcfg.get("warmup_epochs", 5),
        temperature=tcfg.get("temperature", 0.5), seed=seed,
        save_dir=save_dir, save_every=tcfg.get("save_every", 30),
        early_stop_patience=tcfg.get("early_stop_patience", 15))
    device_data = None
    if tcfg.get("device_augment", False) and mesh is None:
        device_data = _uniform_set(paths)
        if device_data is None:
            console_step("device_augment requested but image shapes "
                         "differ; using host augmentation")
    if device_data is not None:
        console_step("Training SSL model (device-resident augmentation)")
        _, history = train_ssl_device(model, device_data, batch_size,
                                      image_size=image_size, device=device,
                                      **common)
        return {"branch": "device", "history": history}
    console_step("Training SSL model")
    epoch_counter = [0]

    def batches():
        epoch_counter[0] += 1
        return two_view_batches(paths, batch_size, image_size,
                                seed=seed + epoch_counter[0])

    _, history = train_ssl(model, batches, max(1, len(paths) // batch_size),
                           input_shape=(image_size, image_size), mesh=mesh,
                           device=device, **common)
    return {"branch": "host", "history": history}


def load_ssl_model(cfg, save_dir: Path, train: bool, device, paths=(),
                   mesh=None) -> tuple[SSLModel, dict | None]:
    """(the SSL model on ``device`` in eval mode, what training reported or
    None): the checkpoint's weights; without one, trained (``train=True``,
    over ``paths``) or seeded."""
    model = build_model(cfg)
    final_ckpt = save_dir / "ssl_model_final.msgpack"
    trained = None
    if final_ckpt.exists():
        console_step("Loading existing SSL checkpoint")
        payload = load_msgpack(final_ckpt)
        load_jax_variables(model, {"params": payload["params"],
                                   "batch_stats": payload["batch_stats"]})
    elif train:
        trained = train_ssl_model(cfg, model.to(device), paths, save_dir,
                                  mesh, device)
    else:
        console_step("No SSL checkpoint: seeded weights (not trained)")
        seed_weights(model, int(cfg.ssl.dataset.get("seed", 42)))
    return model.to(device).eval(), trained


def main(config_path: str | None = None, dataset_dirs=None,
         train: bool = True, mesh=None, device=None) -> dict:
    """Run the SSL pipeline on ``device`` (default: the card). Returns the
    JAX function's keys, under ``seconds`` each step's wall time, and
    under ``training`` (when it trained) the branch and the loss history.
    ``mesh``: None, or a one-device mesh (``parallel.create_mesh``); as in
    the JAX package, a mesh sends training to host views."""
    device = resolve_device(device, "the SSL pipeline")
    cfg = load_classifier_config(config_path)
    save_dir = Path(cfg.paths.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    seconds: dict = {}
    clock = time.perf_counter()

    def lap(step):
        nonlocal clock
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        seconds[step] = now - clock
        clock = now

    if dataset_dirs is None:
        dataset_dirs = discover_dataset_dirs(cfg.paths.dataset_dir)
    paths = collect_image_paths(dataset_dirs)
    if not paths:
        raise FileNotFoundError(f"no images under {dataset_dirs}")
    console_step(f"SSL pipeline: {len(paths)} images")

    dcfg = cfg.ssl.dataset
    image_size = dcfg.get("image_size", 224)
    batch_size = dcfg.get("batch_size", 16)
    seed = int(dcfg.get("seed", 42))
    model, training = load_ssl_model(cfg, save_dir, train, device, paths,
                                     mesh)
    lap("train" if training else "model")

    console_step("Extracting embeddings")
    embed_s: dict = {}
    embeddings, kept_paths = extract_embeddings(
        model, paths, batch_size=batch_size, image_size=image_size,
        cache_file=save_dir / "embeddings.npz", seconds=embed_s)
    print(f"embeddings: {embeddings.shape}")
    lap("embeddings")
    seconds.update({f"embeddings {k}": v for k, v in embed_s.items()})

    console_step("Clustering")
    ccfg = cfg.ssl.clustering
    n_clusters = ccfg.get("n_clusters", 8)
    x = torch.from_numpy(np.asarray(embeddings, np.float32)).to(device)
    pca_dim = ccfg.get("pca_dim", 100)
    if pca_dim and x.shape[1] > pca_dim and x.shape[0] > pca_dim:
        x, _, _ = pca_reduce(x, pca_dim, device=device)
    lap("pca")
    method = ccfg.get("method", "kmeans")
    if method == "agglomerative":
        labels = agglomerative_fast(threefry.key(seed), x, n_clusters,
                                    device=device)
        inertia = None
    else:
        labels, _, inertia = kmeans(threefry.key(seed), x, n_clusters,
                                    device=device)
        inertia = float(inertia)
    labels = labels.cpu().numpy()
    lap("cluster")
    report = evaluate_clustering(x, labels, n_clusters, device=device)
    report["inertia"] = inertia
    report["method"] = method
    with open(save_dir / "clustering_report_detailed.json", "w") as f:
        json.dump(report, f, indent=2)
    lap("report")

    # the embedding scatter (the JAX package's call; a failed figure is
    # logged and never stops the pipeline)
    vcfg = cfg.get("ssl.visualization", {})
    try:
        from .visualize import visualize_embeddings
        figures_dir = Path(cfg.get("paths.figures_dir", "results/img"))
        visualize_embeddings(
            embeddings, labels, figures_dir / "embeddings_clusters.png",
            method=vcfg.get("method", "tsne") if hasattr(vcfg, "get") else "tsne",
            max_points=vcfg.get("max_points", 3000) if hasattr(vcfg, "get") else 3000,
            device=device)
    except Exception as e:  # the figure must never break the pipeline
        logger.warning("embedding visualization failed: %s", e)
    lap("figure")

    console_step("Per-ID aggregation")
    id_to_embeddings = defaultdict(list)
    id_to_filenames = defaultdict(list)
    for emb, fname in zip(embeddings, kept_paths):
        gid = global_id_for(fname)
        id_to_embeddings[gid].append(emb)
        id_to_filenames[gid].append(fname)

    id_list = list(id_to_embeddings)
    id_labels = []
    for gid in id_list:
        mean_emb = np.mean(np.stack(id_to_embeddings[gid]), axis=0)
        dists = np.linalg.norm(embeddings - mean_emb, axis=1)
        id_labels.append(int(labels[int(np.argmin(dists))]))

    csv_path = save_dir / "id_clusters.csv"
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["filename", "path", "global_id", "cluster_label"])
        for gid, cl in zip(id_list, id_labels):
            for full in id_to_filenames[gid]:
                writer.writerow([Path(full).name, full, gid, cl])
    console_step(f"id_clusters.csv written: {len(id_list)} ids")
    lap("csv")

    return {
        "num_images": len(kept_paths),
        "num_ids": len(id_list),
        "embeddings": embeddings,
        "labels": labels,
        "clustering_report": report,
        "csv_path": str(csv_path),
        "seconds": seconds,
        **({"training": training} if training else {}),
    }


if __name__ == "__main__":
    main()
