"""Cluster sorter of the port (the JAX package's ``classifier/sorter.py``):
copy files into ``cluster_*`` directories and write the purity report,
over the ``csv`` module in place of pandas. The report JSON keeps the JAX
file's keys, and like the JAX sorter reads the real ``global_id`` column
(the reference's ``global_class`` key was a bug)."""

from __future__ import annotations

import csv
import json
import shutil
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np

from ..clustering import evaluate_clustering
from ..utils.device import resolve_device
from ..utils.logging import console_step, get_file_logger

logger = get_file_logger(__name__)


def read_id_clusters(path: str | Path) -> list[dict]:
    """Rows of an ``id_clusters.csv``: filename, path, global_id (str) and
    cluster_label (int), as ``pandas.read_csv`` types them."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        r["cluster_label"] = int(r["cluster_label"])
    return rows


def copy_files_to_clusters(rows: list[dict], output_dir: str | Path,
                           copy_mode: str = "copy") -> dict[int, int]:
    """Copy/move each file into cluster_<label>/ with dedup-rename
    (``name_1.ext``, ``name_2.ext``, ... where the name is taken)."""
    output_dir = Path(output_dir)
    counts: dict[int, int] = defaultdict(int)
    for row in rows:
        src = Path(row["path"])
        if not src.exists():
            logger.warning("missing source file %s", src)
            continue
        cdir = output_dir / f"cluster_{row['cluster_label']}"
        cdir.mkdir(parents=True, exist_ok=True)
        dst = cdir / src.name
        stem, suffix = dst.stem, dst.suffix
        k = 1
        while dst.exists():
            dst = cdir / f"{stem}_{k}{suffix}"
            k += 1
        if copy_mode == "move":
            shutil.move(str(src), str(dst))
        else:
            shutil.copy2(str(src), str(dst))
        counts[int(row["cluster_label"])] += 1
    return dict(counts)


def compute_purity(rows: list[dict]) -> dict:
    """Majority-label purity per cluster, from the ``global_id`` column."""
    groups: dict[int, list] = defaultdict(list)
    for r in rows:
        groups[r["cluster_label"]].append(r["global_id"])
    out = {}
    for cl in sorted(groups):
        ids = Counter(groups[cl])
        total = sum(ids.values())
        top_id, top_n = ids.most_common(1)[0]
        out[str(cl)] = {"size": total, "majority_id": str(top_id),
                        "purity": top_n / max(total, 1)}
    sizes = [v["size"] for v in out.values()]
    overall = (sum(v["purity"] * v["size"] for v in out.values())
               / max(sum(sizes), 1))
    return {"clusters": out, "overall_purity": overall}


def main(input_csv: str | Path = "save_models/id_clusters.csv",
         embeddings_npz: str | Path = "save_models/embeddings.npz",
         output_dir: str | Path = "dataset/sorted_dataset",
         copy_mode: str = "copy",
         compute_metrics: bool = True,
         report_path: str | Path = "save_models/sorted_report.json",
         device=None) -> dict:
    """Sort the files of ``input_csv`` into ``output_dir`` and write the
    report; the embedding metrics run on ``device`` (default: the card)."""
    device = resolve_device(device, "the sorter")
    console_step("Sorting dataset into clusters")
    rows = read_id_clusters(input_csv)
    counts = copy_files_to_clusters(rows, output_dir, copy_mode)
    purity = compute_purity(rows)

    report = {"cluster_counts": counts, "purity": purity}
    if compute_metrics and Path(embeddings_npz).exists():
        data = np.load(embeddings_npz, allow_pickle=True)
        emb = data["embeddings"]
        path_to_label = {r["path"]: r["cluster_label"] for r in rows}
        labels = np.asarray([path_to_label.get(str(p), -1)
                             for p in data["paths"]])
        ok = labels >= 0
        if ok.sum() > 1 and len(set(labels[ok])) > 1:
            report["embedding_metrics"] = evaluate_clustering(
                emb[ok], labels[ok], int(labels[ok].max()) + 1,
                device=device)

    report_path = Path(report_path)
    report_path.parent.mkdir(parents=True, exist_ok=True)
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    console_step(f"sorted_report.json written (purity "
                 f"{purity['overall_purity']:.3f})")
    return report


if __name__ == "__main__":
    main()
