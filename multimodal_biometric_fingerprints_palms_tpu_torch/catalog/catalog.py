"""Catalog writer of the port (the JAX package's ``catalog/catalog.py``,
without pandas).

Walks a sorted dataset (``cluster_*`` directories) and writes the catalog
CSV with the reference's column schema:

    image_id,subject_id,finger_id,session_id,cluster_name,path,width,height,format

The CSV is written with the ``csv`` module and is byte-equal to what the
JAX package's ``DataFrame.sort_values([...]).to_csv(index=False)`` writes:
the same stable sort, minimal quoting and ``\\n`` line ends.
"""

from __future__ import annotations

import csv
from pathlib import Path

from ..utils.io import read_image_grayscale
from ..utils.logging import console_step, get_file_logger
from .parse import parse_filename

CATALOG_COLUMNS = [
    "image_id", "subject_id", "finger_id", "session_id",
    "cluster_name", "path", "width", "height", "format",
]
_SORT_KEYS = ("cluster_name", "subject_id", "finger_id", "session_id")

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}

logger = get_file_logger(__name__)


def scan_cluster(cluster_dir: Path, cluster_name: str) -> list[dict]:
    """Scan one cluster directory into catalog records."""
    records = []
    for path in sorted(cluster_dir.iterdir()):
        if not path.is_file() or path.suffix.lower() not in _IMAGE_EXTS:
            continue
        parsed = parse_filename(path.name)
        if parsed is None:
            logger.warning("unrecognized filename %s, skipped", path.name)
            continue
        subject_id, finger_id, session_id = parsed
        try:
            img = read_image_grayscale(path)
            height, width = img.shape[:2]
        except (OSError, ValueError) as e:    # unreadable image: log, skip
            logger.warning("unreadable image %s: %s", path, e)
            continue
        records.append({
            "image_id": path.stem,
            "subject_id": subject_id,
            "finger_id": finger_id,
            "session_id": session_id,
            "cluster_name": cluster_name,
            "path": str(path),
            "width": width,
            "height": height,
            "format": path.suffix.lower().lstrip("."),
        })
    return records


def scan_dataset(sorted_dataset_dir: str | Path) -> list[dict]:
    """Scan every ``cluster_*`` directory: one record (a dict keyed by
    ``CATALOG_COLUMNS``) per readable image."""
    base = Path(sorted_dataset_dir)
    records: list[dict] = []
    for cluster_dir in sorted(base.glob("cluster_*")):
        if cluster_dir.is_dir():
            records.extend(scan_cluster(cluster_dir, cluster_dir.name))
    return records


def save_catalog(records: list[dict], out_csv: str | Path) -> Path:
    """Sort (stable, by cluster, subject, finger, session) and write the
    catalog CSV."""
    out_csv = Path(out_csv)
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    rows = sorted(records, key=lambda r: tuple(r[k] for k in _SORT_KEYS))
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(CATALOG_COLUMNS)
        for r in rows:
            writer.writerow([r[c] for c in CATALOG_COLUMNS])
    return out_csv


def main(sorted_dataset_dir: str = "dataset/sorted_dataset",
         out_csv: str = "data/metadata/catalog.csv") -> list[dict]:
    console_step("Building catalog")
    records = scan_dataset(sorted_dataset_dir)
    save_catalog(records, out_csv)
    console_step(f"Catalog written: {out_csv} ({len(records)} images)")
    return records


if __name__ == "__main__":
    main()
