#!/usr/bin/env python3
"""The Gabor stage's EER effect on the port: the protocol of
``benchmarks/gabor_eer.py`` (hard impostors that share one ridge field, a
NIST-style degraded second session), Gabor off and on.

    python3 tools/gabor_eer_port.py [--users 32] [--severity 0.35]
        [--batch 32] [--out build/gabor_eer_port.json] [--device cpu]

Each user gets ``<u>_1_1.jpg`` (``utils.synthetic.protocol_print(10 + u)``)
and ``<u>_1_2.jpg`` (the same print at ridge phase 0.06 through
``degrade_session`` at ``severity``), written by the port's JPEG encoder.
Both arms run the stages the JAX script runs, on the card unless
``--device`` says otherwise: ``run_preprocessing(gabor=...)``,
``process_directory`` and the matcher's ``main`` under the production
configuration (``demo=False``). (``pipeline.run_all`` chains the same
three stages but takes the Gabor switch only from the repository's
config file.) The second sessions are the port's own degradation (its
affine warp, blur and numpy ellipses), not the JAX script's OpenCV
images, so compare the two arms of one run with each other, not with the
JAX script's numbers. Prints the card's name and power limit, one JSON
line per arm (EER, genuine and impostor means, pairs, seconds) and writes
both to ``--out``. Exits non-zero without a CUDA device unless
``--device cpu``.
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

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (  # noqa: E402
    encode_jpeg)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (  # noqa: E402
    degrade_session, protocol_print)


def write_protocol(cluster: Path, users: int, severity: float) -> None:
    cluster.mkdir(parents=True, exist_ok=True)
    for u in range(1, users + 1):
        (cluster / f"{u}_1_1.jpg").write_bytes(encode_jpeg(protocol_print(10 + u)))
        (cluster / f"{u}_1_2.jpg").write_bytes(encode_jpeg(degrade_session(
            protocol_print(10 + u, 0.06), 10 + u, severity)))


def run_arm(root: Path, gabor: bool, batch: int, device) -> dict:
    """One arm in ``root`` (its own working directory: the runners write
    their logs relative to it)."""
    from multimodal_biometric_fingerprints_palms_tpu_torch.features.runner import (
        process_directory)
    from multimodal_biometric_fingerprints_palms_tpu_torch.matching import (
        runner as mrun)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.runner import (
        run_preprocessing)
    cwd = os.getcwd()
    try:
        os.chdir(root)
        t0 = time.perf_counter()
        run_preprocessing(root / "sorted", root / "processed",
                          batch_size=batch, debug=False, gabor=gabor,
                          device=device)
        process_directory(root / "processed" / "enhanced",
                          root / "processed" / "minutiae", batch_size=batch,
                          device=device)
        res = mrun.main(demo=False,
                        minutiae_base=str(root / "processed" / "minutiae"),
                        logs_dir=str(root / "logs"), device=device)
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    g, imp = res["genuine_scores"], res["impostor_scores"]
    return {"gabor": gabor, "eer": float(res["eer"]),
            "genuine_mean": float(g.mean()), "genuine_std": float(g.std()),
            "impostor_mean": float(imp.mean()),
            "impostor_q99": float(np.quantile(imp, 0.99)),
            "genuine_pairs": int(res["genuine_pairs"]),
            "impostor_pairs": int(res["impostor_pairs"]),
            "seconds": seconds}


def card_line(device) -> str:
    if device is not None and str(device) == "cpu":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--users", type=int, default=32)
    ap.add_argument("--severity", type=float, default=0.35)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "gabor_eer_port.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    import torch
    if args.device is None and not torch.cuda.is_available():
        print("gabor_eer_port: no CUDA device (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return 1
    card = card_line(args.device)
    print(f"card: {card}")
    arms = []
    with tempfile.TemporaryDirectory() as tmp:
        for gabor in (False, True):      # the same files for both arms
            root = Path(tmp) / f"gabor{int(gabor)}"
            write_protocol(root / "sorted" / "cluster_0", args.users,
                           args.severity)
            arms.append(run_arm(root, gabor, args.batch, args.device))
            print(json.dumps(arms[-1]), flush=True)
    out = {"protocol": f"benchmarks/gabor_eer.py's, {args.users} users x 2, "
                       f"second session degraded at severity "
                       f"{args.severity} by the port's degrade_session",
           "device": card, "off": arms[0], "on": arms[1],
           "eer_delta_on_minus_off": arms[1]["eer"] - arms[0]["eer"]}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps({"eer_off": arms[0]["eer"], "eer_on": arms[1]["eer"],
                      "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
