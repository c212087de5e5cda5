"""FRR/FAR threshold sweeps, EER and score reports (port of
``evaluation/metrics.py``).

The JAX package's module is numpy only, but the port and the script that
drives it on the card import nothing of the JAX package, so its functions
are carried over here, held equal to the originals by
``tests/test_torch_matching.py`` and ``tests/test_torch_io.py``.
Conventions: FRR(t) = mean(genuine < t), FAR(t) = mean(impostor >= t) over
linspace(0, 1, num_points); the EER is the linearly interpolated crossing.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def _sweep(scores, num_points: int, accept: bool, verbose: bool):
    thresholds = np.linspace(0.0, 1.0, num_points)
    s = np.asarray(scores, dtype=np.float64)
    if not s.size:
        rate = np.zeros(num_points)
    elif accept:
        rate = (s[None, :] >= thresholds[:, None]).mean(axis=1)
    else:
        rate = (s[None, :] < thresholds[:, None]).mean(axis=1)
    if verbose:
        for t, v in zip(thresholds, rate):
            print(f"{t:8.3f} | {v:8.3f}")
    return thresholds, rate


def evaluate_frr_across_thresholds(genuine_scores, num_points: int = 50,
                                   verbose: bool = False):
    return _sweep(genuine_scores, num_points, False, verbose)


def evaluate_far_across_thresholds(impostor_scores, num_points: int = 50,
                                   verbose: bool = False):
    return _sweep(impostor_scores, num_points, True, verbose)


def compute_eer(thresholds, frr, far) -> tuple[float, float]:
    """Equal-error rate: the crossing of FRR (rising) and FAR (falling),
    linearly interpolated. Returns (eer, threshold_at_eer)."""
    frr = np.asarray(frr, dtype=np.float64)
    far = np.asarray(far, dtype=np.float64)
    diff = frr - far
    idx = np.where(np.diff(np.sign(diff)) != 0)[0]
    if len(idx) == 0:
        i = int(np.argmin(np.abs(diff)))
        return float((frr[i] + far[i]) / 2.0), float(thresholds[i])
    i = int(idx[0])
    d0, d1 = diff[i], diff[i + 1]
    w = 0.0 if d1 == d0 else -d0 / (d1 - d0)
    eer = float(frr[i] + w * (frr[i + 1] - frr[i]))
    far_i = float(far[i] + w * (far[i + 1] - far[i]))
    thr = float(thresholds[i] + w * (thresholds[i + 1] - thresholds[i]))
    return (eer + far_i) / 2.0, thr


def report_scores(title: str, scores) -> dict:
    """Count/mean/min/max/std report, printed and returned."""
    s = np.asarray(scores, dtype=np.float64)
    stats = {"title": title, "count": int(s.size)}
    if s.size:
        stats.update(mean=float(s.mean()), min=float(s.min()),
                     max=float(s.max()), std=float(s.std()))
    print(f"\n=== {title} ===")
    for k, v in stats.items():
        if k != "title":
            print(f"{k}: {v}")
    return stats


def compute_minutiae_statistics(dataset: dict,
                                output_file: str | Path = "logs/minutiae_stats.csv"):
    """Per-sample minutiae stats CSV with the reference's header.
    ``dataset``: {user_id: [(N,7) arrays]}."""
    output_file = Path(output_file)
    output_file.parent.mkdir(parents=True, exist_ok=True)
    header = [
        "user_id", "sample_index", "num_minutiae",
        "mean_quality", "std_quality",
        "mean_orientation", "std_orientation",
        "mean_stability", "std_stability",
        "min_x", "max_x", "min_y", "max_y",
    ]
    with open(output_file, "w", newline="") as fout:
        writer = csv.writer(fout)
        writer.writerow(header)
        for user_id, samples in dataset.items():
            for idx, m in enumerate(samples):
                m = np.asarray(m)
                if m.shape[0] == 0:
                    continue
                writer.writerow([
                    user_id, idx, m.shape[0],
                    np.mean(m[:, 4]), np.std(m[:, 4]),
                    np.mean(m[:, 3]), np.std(m[:, 3]),
                    np.mean(m[:, 6]), np.std(m[:, 6]),
                    np.min(m[:, 0]), np.max(m[:, 0]),
                    np.min(m[:, 1]), np.max(m[:, 1]),
                ])
    logger.info("minutiae statistics saved to %s", output_file)
    return output_file
