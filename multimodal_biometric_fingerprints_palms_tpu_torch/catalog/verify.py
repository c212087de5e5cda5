"""Data-consistency checks of the port (the JAX package's
``catalog/verify.py``, without pandas): every filename-derived id must map
to exactly one ``global_id`` in id_clusters.csv."""

from __future__ import annotations

import csv
from pathlib import Path

from .parse import user_id_from_filename


def _column_values(values: list[str]) -> list:
    """A CSV column's values typed as ``pandas.read_csv`` types a column of
    plain values: all integers, else all floats, else strings."""
    for kind in (int, float):
        try:
            return [kind(v) for v in values]
        except ValueError:
            pass
    return values


def check_id_consistency(id_clusters_csv: str | Path) -> dict:
    """Return {"ok": bool, "violations": {derived_id: [global_ids...]}}."""
    with open(id_clusters_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    ids = _column_values([r["global_id"] for r in rows])
    by_user: dict[str, set] = {}
    for r, gid in zip(rows, ids):
        by_user.setdefault(user_id_from_filename(r["filename"]), set()).add(gid)
    violations = {k: sorted(v) for k, v in sorted(by_user.items())
                  if len(v) > 1}
    return {"ok": not violations, "violations": violations}
