"""Pair-index matching (port of ``matching/runner.match_pair_indices``).

Genuine and impostor pairs are index arrays into one (S, K) gallery of
templates on a device, matched in chunks. There is one route on every
device, the one the JAX package takes on its accelerator: the cascade
screen is ``cuda_match.screen_promote_batch`` (the sampled screen OR the
recall anchors) and the full pass is ``cuda_match.match_pairs_batch``;
only the hypothesis-scoring wrapper looks at the device (kernel D on CUDA,
its plain twin on the CPU). The JAX package's CPU route
(``use_pallas=False``) screens with the full matcher instead
(``ransac.screen_promote_batch``); the port does not reproduce that rule.
Results are per pair, so the last chunk is not padded to a fixed shape
(the JAX package pads only to avoid recompiles).

``main()`` is the evaluation protocol of the JAX package's ``runner.main``:
the matching config (read by the port's YAML reader), the minutiae dataset
on the card, genuine pairs under the FRR gates and sampled impostor pairs
under the FAR gates (with the cascade unless ``demo``), the threshold
sweeps and EER, and ``minutiae_stats.csv``, ``genuine_match_stats.csv`` and
``roc.png`` under the logs directory.
"""

from __future__ import annotations

import argparse
import csv
import logging
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..config import load_matching_config
from ..evaluation import (
    compute_eer, compute_minutiae_statistics, evaluate_far_across_thresholds,
    evaluate_frr_across_thresholds, plot_roc, report_scores)
from ..features.minutiae import MinutiaeSet
from ..preprocessing.enhance import exact_float32
from ..utils.device import resolve_device
from ..utils.logging import console_step, get_file_logger
from .cuda_match import match_pairs_batch, screen_promote_batch
from .dataset import MinutiaeDataset, genuine_pairs, impostor_pairs, load_dataset
from .ransac import MatchParams

# the file handler and level are attached in main() from the logging.*
# config keys; library use of this module writes no file
logger = logging.getLogger(__name__)


def _gather(ds: MinutiaeDataset, idx: np.ndarray) -> MinutiaeSet:
    sel = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(
        ds.stacked.valid.device)
    return MinutiaeSet(*(x[sel] for x in ds.stacked))


def screen_pair_indices(ds: MinutiaeDataset, pairs: np.ndarray,
                        params: MatchParams, chunk: int = 512,
                        screen_iters: int = 32) -> np.ndarray:
    """(P,) promote bits of the cascade screen for (P, 2) sample-index
    pairs: ``screen_iters`` hypotheses (a prefix of the full pass's) with
    min_inliers relaxed by 2 (at least 3), OR-ed with the recall anchors."""
    screen_p = params._replace(ransac_iter=screen_iters,
                               full_iters=params.ransac_iter,
                               min_inliers=max(3, params.min_inliers - 2))
    return torch.cat([
        screen_promote_batch(_gather(ds, pairs[i:i + chunk, 0]),
                             _gather(ds, pairs[i:i + chunk, 1]), screen_p)
        for i in range(0, pairs.shape[0], chunk)]).cpu().numpy()


def match_pair_indices(ds: MinutiaeDataset, pairs: np.ndarray,
                       params: MatchParams, chunk: int = 512,
                       cascade: bool = False,
                       screen_iters: int = 32) -> dict:
    """Match (P, 2) sample-index pairs in chunks of ``chunk`` pairs on the
    gallery's device. Returns numpy arrays final_score / n_inliers / theta /
    t per pair.

    cascade=True runs a two-phase screen (``screen_pair_indices``) for
    every pair, then the full ``params.ransac_iter`` pass only on the
    promoted pairs. Pairs the screen drops score 0."""
    exact_float32()
    n = pairs.shape[0]
    if n == 0:
        return {"final_score": np.zeros(0), "n_inliers": np.zeros(0, np.int32),
                "theta": np.zeros(0), "t": np.zeros((0, 2))}

    if cascade and params.ransac_iter > screen_iters:
        promising = screen_pair_indices(ds, pairs, params, chunk, screen_iters)
        out = {
            "final_score": np.zeros(n), "n_inliers": np.zeros(n, np.int32),
            "theta": np.zeros(n), "t": np.zeros((n, 2)),
        }
        idx = np.nonzero(promising)[0]
        if idx.size:
            full = match_pair_indices(ds, pairs[idx], params, chunk=chunk)
            for key in out:
                out[key][idx] = full[key]
        return out

    # every chunk is queued on the device before any result is copied back
    res = [match_pairs_batch(_gather(ds, pairs[i:i + chunk, 0]),
                             _gather(ds, pairs[i:i + chunk, 1]), params)
           for i in range(0, n, chunk)]
    return {key: torch.cat([getattr(r, key) for r in res]).cpu().numpy()
            for key in ("final_score", "n_inliers", "theta", "t")}


def _log_pair_scores(ds: MinutiaeDataset, pairs: np.ndarray, res: dict,
                     kind: str):
    """Per-pair DEBUG audit lines in the matching log, when
    ``logging.debug_pairs`` is set (one line a pair)."""
    if not logger.isEnabledFor(logging.DEBUG):
        return
    for p, (i, j) in enumerate(pairs):
        logger.debug(
            "%s pair %s[%d] vs %s[%d]: score=%.6f inliers=%d "
            "theta=%.2fdeg t=(%.1f, %.1f)",
            kind,
            ds.users[ds.user_index[i]], int(ds.sample_index[i]),
            ds.users[ds.user_index[j]], int(ds.sample_index[j]),
            float(res["final_score"][p]), int(res["n_inliers"][p]),
            math.degrees(float(res["theta"][p])),
            float(res["t"][p, 0]), float(res["t"][p, 1]))


def _write_genuine_stats(ds: MinutiaeDataset, pairs: np.ndarray, res: dict,
                         out_csv: Path):
    """genuine_match_stats.csv with the reference's header, the metadata
    filled in."""
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["user_id", "idx1", "idx2", "score", "num_inliers",
                    "num_outliers", "rotation_deg", "translation_x",
                    "translation_y"])
        for p, (i, j) in enumerate(pairs):
            user = ds.users[ds.user_index[i]]
            n_in = int(res["n_inliers"][p])
            n_total = min(ds.matrices[i].shape[0], ds.matrices[j].shape[0])
            w.writerow([
                user, int(ds.sample_index[i]), int(ds.sample_index[j]),
                float(res["final_score"][p]), n_in, max(0, n_total - n_in),
                math.degrees(float(res["theta"][p])),
                float(res["t"][p, 0]), float(res["t"][p, 1]),
            ])


def main(config_path: str | None = None, demo: bool = False,
         minutiae_base: str | None = None, logs_dir: str = "logs",
         device=None) -> dict:
    """The FRR/FAR/EER protocol over the ``*_minutiae.json`` files under
    ``minutiae_base`` on ``device`` (default: the card; pass ``"cpu"`` to
    run there). Returns the JAX package's keys."""
    device = resolve_device(device, "matching.runner.main")
    cfg = load_matching_config(config_path)
    base = minutiae_base or cfg.get("data.minutiae_base",
                                    "dataset/processed/minutiae")
    logs = Path(logs_dir)
    debug_pairs = bool(cfg.get("logging.debug_pairs", False))
    get_file_logger(__name__,
                    cfg.get("logging.logfile", str(logs / "matching.log")),
                    level=logging.DEBUG if debug_pairs else logging.INFO)

    if cfg.get("system.deterministic", True):
        np.random.seed(cfg.get("ransac.seed", 42))

    console_step("Loading minutiae dataset")
    max_per_user = cfg.get("evaluation.max_per_user", 2)
    ds = load_dataset(base, max_per_user=max_per_user,
                      k=cfg.get("matching.pad_k", 64), device=device)
    print(f"users: {len(ds.users)}  samples: {len(ds.matrices)}")
    if not ds.matrices:
        raise FileNotFoundError(f"no *_minutiae.json under {base}")

    compute_minutiae_statistics(ds.as_dict(), logs / "minutiae_stats.csv")

    ransac_iter = cfg.get("ransac.max_iterations", 300)
    if demo:
        ransac_iter = cfg.get("evaluation.demo.ransac_iterations", 50)

    def make_params(min_inliers, phase):
        """Phase gates: the full protocol's FRR and FAR distance and
        orientation gates, else the pair matcher's; stop ratio 0.15."""
        dist = float(cfg.get(f"evaluation.{phase}.max_distance",
                             cfg.get("matching.max_distance", 10.0)))
        orient = float(cfg.get(
            f"evaluation.{phase}.max_orientation_diff_deg",
            cfg.get("matching.max_orientation_diff_deg", 12.0)))
        return MatchParams(
            dist_thresh=dist,
            orient_thresh=math.radians(orient),
            use_type=bool(cfg.get("matching.use_type", True)),
            ransac_iter=int(ransac_iter),
            min_inliers=int(min_inliers),
            stop_inlier_ratio=float(cfg.get("ransac.stop_inlier_ratio", 0.15)),
            cross_check=bool(cfg.get("matching.cross_check", True)),
            seed=int(cfg.get("ransac.seed", 42)),
        )

    cascade = bool(cfg.get("matching.cascade", True)) and not demo
    screen_iters = int(cfg.get("matching.screen_iters", 32))

    console_step("FRR: genuine pairs")
    mi_frr = (cfg.get("evaluation.demo.min_inliers", 3) if demo
              else cfg.get("evaluation.min_inliers_frr", 6))
    g_pairs = genuine_pairs(
        ds, max_pairs_per_user=(
            cfg.get("evaluation.demo.genuine_pairs_per_user", 3) if demo else None))
    t0 = time.time()
    g_res = match_pair_indices(ds, g_pairs, make_params(mi_frr, "frr"),
                               cascade=cascade, screen_iters=screen_iters)
    genuine_scores = g_res["final_score"]
    t_frr = time.time() - t0
    print(f"{len(g_pairs)} genuine pairs in {t_frr:.2f}s")
    _log_pair_scores(ds, g_pairs, g_res, kind="genuine")
    _write_genuine_stats(ds, g_pairs, g_res, logs / "genuine_match_stats.csv")
    report_scores("GENUINE SCORES", genuine_scores)

    console_step("FAR: impostor pairs")
    mi_far = (cfg.get("evaluation.demo.min_inliers", 3) if demo
              else cfg.get("evaluation.min_inliers_far", 12))
    peers = (cfg.get("evaluation.demo.impostor_peers_per_user", 5) if demo
             else cfg.get("evaluation.impostor_peers_per_user", 100))
    i_pairs = impostor_pairs(ds, peers_per_user=peers,
                             seed=cfg.get("ransac.seed", 42))
    t0 = time.time()
    i_res = match_pair_indices(ds, i_pairs, make_params(mi_far, "far"),
                               cascade=cascade, screen_iters=screen_iters)
    impostor_scores = i_res["final_score"]
    t_far = time.time() - t0
    print(f"{len(i_pairs)} impostor pairs in {t_far:.2f}s")
    _log_pair_scores(ds, i_pairs, i_res, kind="impostor")
    report_scores("IMPOSTOR SCORES", impostor_scores)

    num_points = cfg.get("evaluation.num_threshold_points", 50)
    thr, frr = evaluate_frr_across_thresholds(genuine_scores, num_points)
    _, far = evaluate_far_across_thresholds(impostor_scores, num_points)
    eer, eer_thr = compute_eer(thr, frr, far)
    print(f"EER = {eer:.4f} @ threshold {eer_thr:.3f}")
    plot_roc(far, frr, logs / "roc.png")

    return {
        "num_users": len(ds.users),
        "num_samples": len(ds.matrices),
        "genuine_pairs": int(len(g_pairs)),
        "impostor_pairs": int(len(i_pairs)),
        "genuine_scores": genuine_scores,
        "impostor_scores": impostor_scores,
        "frr": frr, "far": far, "thresholds": thr,
        "eer": eer, "eer_threshold": eer_thr,
        "seconds_frr": t_frr, "seconds_far": t_far,
        "pairs_per_second": (len(g_pairs) + len(i_pairs))
                            / max(t_frr + t_far, 1e-9),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Minutiae matching evaluation")
    ap.add_argument("--config", default=None)
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--minutiae-base", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(args.config, demo=args.demo, minutiae_base=args.minutiae_base,
         device=args.device)
