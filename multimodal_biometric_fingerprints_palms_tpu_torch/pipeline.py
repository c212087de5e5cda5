"""Full-stack pipeline of the port (the JAX package's
``pipeline.py``).

Chains the file stages through their on-disk contracts:

  sorted_dataset/ -> catalog.csv -> preprocessing (enhanced/) ->
  minutiae extraction (minutiae/) -> matching/evaluation (logs/)

on the card (kernels A, B, C, E, F and G in preprocessing, D in matching),
or on the CPU when the caller asks. The SSL branch that sorts a raw
dataset into ``sorted_dataset/`` first (``skip_ssl=False``) is not ported
yet.

    python3 -m multimodal_biometric_fingerprints_palms_tpu_torch.pipeline \\
        --dataset <dir holding sorted_dataset/> --skip-ssl
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from .utils.device import resolve_device
from .utils.logging import console_step


def run_all(dataset_dir: str = "dataset",
            classifier_config: str | None = None,
            matching_config: str | None = None,
            train: bool = True,
            demo_matching: bool = True,
            skip_ssl: bool = False,
            device=None) -> dict:
    """Run every stage from ``<dataset_dir>/sorted_dataset`` on ``device``
    (default: the card; pass ``"cpu"`` to run there). Returns each stage's
    result under the JAX package's keys, and under ``seconds`` each stage's
    wall time."""
    if not skip_ssl:
        raise NotImplementedError(
            "the SSL branch of run_all (skip_ssl=False) is not ported yet: "
            "ROADMAP.md queue 1, items 3 and 4 (models and training); pass "
            "skip_ssl=True to start from an existing sorted_dataset")
    del classifier_config, train          # they configure the SSL branch
    device = resolve_device(device, "run_all")
    results: dict = {"seconds": {}}
    clock = time.perf_counter()

    def lap(stage):
        nonlocal clock
        now = time.perf_counter()
        results["seconds"][stage] = now - clock
        clock = now

    from .catalog.catalog import main as catalog_main
    results["catalog_rows"] = len(catalog_main(
        str(Path(dataset_dir) / "sorted_dataset"),
        "data/metadata/catalog.csv"))
    lap("catalog")

    from .preprocessing.runner import run_preprocessing
    results["preprocessing"] = run_preprocessing(
        Path(dataset_dir) / "sorted_dataset",
        Path(dataset_dir) / "processed", device=device)
    lap("preprocessing")

    from .features.runner import process_directory
    results["features"] = process_directory(
        Path(dataset_dir) / "processed" / "enhanced",
        Path(dataset_dir) / "processed" / "minutiae", device=device)
    lap("features")

    from .matching.runner import main as match_main
    results["matching"] = match_main(
        matching_config, demo=demo_matching,
        minutiae_base=str(Path(dataset_dir) / "processed" / "minutiae"),
        device=device)
    lap("matching")

    console_step("Pipeline complete")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Run the full pipeline")
    ap.add_argument("--dataset", default="dataset")
    ap.add_argument("--skip-ssl", action="store_true",
                    help="start from an existing sorted_dataset")
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--full-matching", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    res = run_all(args.dataset, train=not args.no_train,
                  demo_matching=not args.full_matching,
                  skip_ssl=args.skip_ssl, device=args.device)
    m = res["matching"]
    print(json.dumps({
        "seconds": res["seconds"], "catalog_rows": res["catalog_rows"],
        **{k: {kk: res[k][kk] for kk in ("num_images", "seconds", "reader")
               if kk in res[k]} for k in ("preprocessing", "features")},
        "matching": {k: m[k] for k in ("num_users", "genuine_pairs",
                                       "impostor_pairs", "eer",
                                       "seconds_frr", "seconds_far")}}))
