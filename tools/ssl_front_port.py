#!/usr/bin/env python3
"""The SSL branch of the port at PolyU DBII's scale, step by step.

    python3 tools/ssl_front_port.py [--subjects 148] [--device cpu]

Writes ``subjects`` x 10 PolyU-shaped JPEGs under ``<tmp>/dataset/DBII``
(``tools/polyu_set.write_raw``; 148 subjects make PolyU's 1,480 files) and
a full-width SSL checkpoint in the JAX package's format (seeded weights),
then runs what ``pipeline.run_all(skip_ssl=False)`` runs before the file
stages, with the shipped ``configs/config_classifier.yml`` (EfficientNetV2-S,
756 -> 512 -> 256, predictor on, 224 x 224, batch 16, PCA to 100, kmeans
with 8 clusters): ``classifier.pipeline.main(train=False)`` and
``classifier.sorter.main`` into ``<tmp>/dataset/sorted_dataset``. Also times
``agglomerative_fast`` (the config's other method) on the same PCA
projection. Prints the seconds of each step (the files' read and decode and
their preprocessing on the host,
forward, PCA, kmeans, the report, the embedding figure (its t-SNE on the
card over all the files and the raster written through the codec), the
CSV, the agglomerative alternative, the sorter's copy), the device's peak memory and, as its last line, one
JSON object with all of it. On the card unless given ``--device cpu``;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from multimodal_biometric_fingerprints_palms_tpu_torch.classifier import (  # noqa: E402
    pipeline as ssl_pipeline, sorter)
from multimodal_biometric_fingerprints_palms_tpu_torch.clustering import (  # noqa: E402
    agglomerative_fast, pca_reduce)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import (  # noqa: E402
    threefry)
from multimodal_biometric_fingerprints_palms_tpu_torch.models import (  # noqa: E402
    seed_weights, ssl_variables_from_state)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.checkpoint import (  # noqa: E402
    save_msgpack)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)


def classifier_config(root: Path) -> Path:
    """The shipped classifier config with its paths under ``root``."""
    text = (ROOT / "configs" / "config_classifier.yml").read_text()
    if "  root_dir: .\n" not in text:
        raise ValueError("configs/config_classifier.yml has no 'root_dir: .'")
    path = root / "config_classifier.yml"
    path.write_text(text.replace("  root_dir: .\n", f"  root_dir: {root}\n"))
    return path


def write_checkpoint(cfg_path: Path, seed: int) -> Path:
    """A JAX-format checkpoint of the configured SSL model with seeded
    weights, where ``main`` looks for one."""
    cfg = ssl_pipeline.load_classifier_config(cfg_path)
    model = seed_weights(ssl_pipeline.build_model(cfg), seed)
    v = ssl_variables_from_state(model.state_dict())
    return save_msgpack(Path(cfg.paths.save_dir) / "ssl_model_final.msgpack",
                        {"params": v["params"], "batch_stats": v["batch_stats"],
                         "step": 0})


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def run(root: Path, subjects: int, device: torch.device) -> dict:
    polyu_set = __import__("polyu_set")
    t0 = time.perf_counter()
    data = root / "dataset"                # the config's dataset_dir
    files = polyu_set.write_raw(data, subjects)
    cfg = classifier_config(root)
    write_checkpoint(cfg, seed=42)
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cwd = os.getcwd()
    os.chdir(root)                         # the runners' relative logs
    try:
        t0 = time.perf_counter()
        res = ssl_pipeline.main(str(cfg), train=False, device=device)
        ssl_s = time.perf_counter() - t0
        emb = torch.from_numpy(res["embeddings"]).to(device)
        seconds = dict(res["seconds"])

        def timed(fn):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return out, time.perf_counter() - t

        x, _ = timed(lambda: pca_reduce(emb, 100, device=device)[0])
        agg, seconds["agglomerative"] = timed(
            lambda: agglomerative_fast(threefry.key(42), x, 8, device=device))
        save = root / "save_models"
        report, seconds["sorter"] = timed(lambda: sorter.main(
            res["csv_path"], save / "embeddings.npz", data / "sorted_dataset",
            report_path=save / "sorted_report.json", device=device))
    finally:
        os.chdir(cwd)
    sorted_files = sorted(p.name for p in (data / "sorted_dataset").rglob("*.jpg"))
    if sorted_files != sorted(Path(r).name for r in files):
        raise SystemExit("ssl_front_port: sorted_dataset does not hold every "
                         "file once")
    sizes = res["clustering_report"]["cluster_sizes"]
    agg_sizes = torch.bincount(agg.cpu(), minlength=8).tolist()
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)
    return {
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "card": card_line() if device.type == "cuda" else None,
        "files": len(files), "num_images": res["num_images"],
        "num_ids": res["num_ids"], "setup_s": setup_s, "ssl_main_s": ssl_s,
        "seconds": seconds,
        "img_s_ssl_main": res["num_images"] / ssl_s,
        "kmeans_sizes": sizes, "agglomerative_sizes": agg_sizes,
        "overall_purity": report["purity"]["overall_purity"],
        "silhouette_cosine": res["clustering_report"]["silhouette_cosine"],
        "peak_device_bytes": peak,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subjects", type=int, default=148)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device, "ssl_front_port")
    sys.path.insert(0, str(ROOT / "tools"))
    with tempfile.TemporaryDirectory() as tmp:
        out = run(Path(tmp), args.subjects, device)
    print(f"card: {out['card']}")
    print("seconds: " + ", ".join(f"{k} {v:.3f}"
                                  for k, v in out["seconds"].items()))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
