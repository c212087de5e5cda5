"""FRR/FAR threshold sweeps and EER (port of ``evaluation/metrics.py``).

The JAX package's module is numpy only, but the port and the script that
drives it on the card import nothing of the JAX package, so the three
functions the matching protocol needs are carried over here, held equal to
the originals by ``tests/test_torch_matching.py``. Conventions:
FRR(t) = mean(genuine < t), FAR(t) = mean(impostor >= t) over
linspace(0, 1, num_points); the EER is the linearly interpolated crossing.
The CSV and ROC reports wait for the port of ``runner.main``.
"""

from __future__ import annotations

import numpy as np


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
