"""Full-stack pipeline of the port (the JAX package's
``pipeline.py``).

Chains every stage through its on-disk contract:

  raw dataset (DBII/, Nist/) -> SSL pipeline (id_clusters.csv) -> sorter
  (sorted_dataset/) -> catalog.csv -> preprocessing (enhanced/) ->
  minutiae extraction (minutiae/) -> matching/evaluation (logs/)

on the card (the SSL model, clustering; kernels A, B, C, E, F and G in
preprocessing, D in matching), or on the CPU when the caller asks.
``skip_ssl=True`` starts from an existing ``sorted_dataset/``.

One difference from the JAX package's ``run_all``, a fault there: its SSL
step reads the classifier config's ``dataset_dir`` and its sorter writes
the working-directory-relative ``dataset/sorted_dataset``, while the
catalog reads ``<dataset_dir>/sorted_dataset``; they meet only when
``dataset_dir == "dataset"`` is also the working directory's. The port's
SSL step reads ``<dataset_dir>/{DBII,Nist}``, and its sorter writes
``<dataset_dir>/sorted_dataset`` with its report and embeddings in the
configured ``save_dir``.

    python3 -m multimodal_biometric_fingerprints_palms_tpu_torch.pipeline \\
        --dataset <dir holding DBII/ and Nist/> --no-train
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
    """Run every stage from ``<dataset_dir>/{DBII,Nist}`` (or, with
    ``skip_ssl``, from ``<dataset_dir>/sorted_dataset``) on ``device``
    (default: the card; pass ``"cpu"`` to run there). Returns each stage's
    result under the JAX package's keys, and under ``seconds`` each stage's
    wall time. ``train=True`` without an SSL checkpoint trains the SSL
    model first (``classifier.pipeline.main``)."""
    device = resolve_device(device, "run_all")
    results: dict = {"seconds": {}}
    clock = time.perf_counter()

    def lap(stage):
        nonlocal clock
        now = time.perf_counter()
        results["seconds"][stage] = now - clock
        clock = now

    if not skip_ssl:
        from .classifier.pipeline import discover_dataset_dirs
        from .classifier.pipeline import main as ssl_main
        from .classifier.sorter import main as sorter_main
        from .catalog.verify import check_id_consistency

        results["ssl"] = ssl_main(
            classifier_config, dataset_dirs=discover_dataset_dirs(dataset_dir),
            train=train, device=device)
        lap("ssl")
        csv_path = results["ssl"]["csv_path"]
        consistency = check_id_consistency(csv_path)
        results["id_consistency"] = consistency
        if not consistency["ok"]:
            console_step(f"WARNING: id consistency violations: "
                         f"{len(consistency['violations'])}")
        save_dir = Path(csv_path).parent            # the config's save_dir
        results["sorter"] = sorter_main(
            input_csv=csv_path, embeddings_npz=save_dir / "embeddings.npz",
            output_dir=Path(dataset_dir) / "sorted_dataset",
            report_path=save_dir / "sorted_report.json", device=device)
        lap("sorter")

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
        **({"ssl": res["ssl"]["seconds"]} if "ssl" in res else {}),
        **{k: {kk: res[k][kk] for kk in ("num_images", "seconds", "reader")
               if kk in res[k]} for k in ("preprocessing", "features")},
        "matching": {k: m[k] for k in ("num_users", "genuine_pairs",
                                       "impostor_pairs", "eer",
                                       "seconds_frr", "seconds_far")}}))
