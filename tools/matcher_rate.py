#!/usr/bin/env python3
"""The 1:1 matcher's rates on one GPU, to compare two checkouts in turns.

    python3 tools/matcher_rate.py --root CHECKOUT
    python3 tools/matcher_rate.py --compare PARENT CHANGE [--turns 2]

With ``--root`` it imports the port from CHECKOUT and, on the fixture
templates of this tool's own tree (``tests/fixtures/parity_full``, so two
checkouts see the same templates), times on the card:

- the full pass (RANSAC 300, the FRR gates) of one chunk of 512 and of
  4,096 pairs through ``match_pair_indices``, as ``chip_smoke.py`` does:
  the median of ``--reps`` synchronized calls after a warm-up, as pairs/s,
  and the device operations of one call and their summed device time
  under ``torch.profiler``;
- the golden protocol's two passes (``parity_full_golden.json``: genuine
  pairs under the FRR gates, sampled impostor pairs under the FAR gates),
  cascade off and on: the median seconds of three synchronized runs.

It prints one JSON line. With ``--compare`` it runs itself once per
checkout and turn, each in a process of its own, in the order PARENT,
CHANGE, CHANGE, PARENT (``--turns`` such rounds), prints every run, and
the largest difference of the golden protocol's scores between the two
checkouts (each run writes them through ``--save``).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FIXTURE = HERE / "tests" / "fixtures" / "parity_full"
GOLDEN = HERE / "tests" / "fixtures" / "parity_full_golden.json"
CHUNKS = (512, 4096)
H_FULL = 300


def wall(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_ops(fn) -> tuple[int, float]:
    """(count, summed ms) of the device operations one call of ``fn``
    issues, between two sentinel kernels that are left out by name (a
    short profiler window can lose the operation at its edge)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and "spin_kernel" not in e.name]
    return len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3


def rates(root: Path, save: Path | None, reps: int) -> dict:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("matcher_rate: needs a GPU")
    sys.path.insert(0, str(root))
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.dataset import (
        genuine_pairs, impostor_pairs, load_dataset)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (
        MatchParams)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching.runner import (
        match_pair_indices)
    out = {"card": torch.cuda.get_device_name(0)}

    frr = MatchParams(ransac_iter=H_FULL, dist_thresh=30.0,
                      orient_thresh=math.radians(30.0), min_inliers=6)
    fix = load_dataset(FIXTURE, max_per_user=4, device="cuda")
    many = np.concatenate([genuine_pairs(fix), impostor_pairs(fix)])
    for chunk in CHUNKS:
        prs = many[:chunk]
        match_pair_indices(fix, prs, frr, chunk=chunk)
        call = lambda: match_pair_indices(fix, prs, frr, chunk=chunk)
        secs = statistics.median(wall(call) for _ in range(reps))
        out[f"full_pass_{chunk}_pairs_s"] = len(prs) / secs
        ops, ms = device_ops(call)
        out[f"full_pass_{chunk}_device_ops"] = ops
        out[f"full_pass_{chunk}_device_ms"] = ms

    golden = json.loads(GOLDEN.read_text())
    pr = golden["protocol"]
    ds = load_dataset(FIXTURE, max_per_user=pr["max_per_user"], k=64,
                      device="cuda")

    def params(gates):
        return MatchParams(dist_thresh=float(gates["dist"]),
                           orient_thresh=math.radians(gates["orient_deg"]),
                           min_inliers=int(gates["min_inliers"]),
                           ransac_iter=int(pr["ransac_iter"]),
                           stop_inlier_ratio=float(pr["stop_inlier_ratio"]),
                           seed=42)

    runs = ((genuine_pairs(ds), params(pr["frr"])),
            (impostor_pairs(ds, peers_per_user=100, seed=42), params(pr["far"])))
    kept = {}
    for cascade in (False, True):
        def protocol():
            kept[cascade] = [match_pair_indices(ds, prs, p, 512, cascade,
                                                32)["final_score"]
                             for prs, p in runs]
        protocol()
        out[f"golden_cascade_{cascade}_s"] = statistics.median(
            wall(protocol) for _ in range(3))
    if save is not None:
        np.save(save, np.concatenate([np.asarray(s, np.float64)
                                      for c in (False, True) for s in kept[c]]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path)
    ap.add_argument("--compare", nargs=2, type=Path, metavar="CHECKOUT")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5,
                    help="synchronized full-pass calls a chunk size")
    ap.add_argument("--save", type=Path,
                    help="with --root: also write the golden scores (.npy)")
    args = ap.parse_args()
    if args.root:
        print(json.dumps(rates(args.root.resolve(), args.save, args.reps)))
        return
    if not args.compare:
        ap.error("give --root or --compare")
    import numpy as np
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    parent, change = args.compare
    scores = {}
    with tempfile.TemporaryDirectory() as tmp:
        for turn in range(args.turns):
            for i, root in enumerate((parent, change, change, parent)):
                res = subprocess.run(
                    [sys.executable, __file__, "--root", str(root), "--save",
                     f"{tmp}/{root == change}.npy", "--reps", str(args.reps)],
                    capture_output=True, text=True, check=False)
                if res.returncode:
                    raise SystemExit(f"{root}: failed\n{res.stdout}\n"
                                     f"{res.stderr}")
                run = json.loads(res.stdout.strip().splitlines()[-1])
                print(f"turn {turn}, {'change' if root == change else 'parent'} "
                      f"({root}): {json.dumps(run)}")
        for which in (False, True):
            scores[which] = np.load(f"{tmp}/{which}.npy")
    d = np.abs(scores[True] - scores[False])
    print(f"golden protocol scores, change against parent: {int((d != 0).sum())} "
          f"of {d.size} differ, max |d| {float(d.max()):.6g}")


if __name__ == "__main__":
    main()
