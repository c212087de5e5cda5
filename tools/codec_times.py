#!/usr/bin/env python3
"""Times the port's image codec a file, on the host, for one or more
checkouts of the repository in one process's turn each.

    python3 tools/codec_times.py [--files 160] [CHECKOUT ...]

Each checkout (default: this one) is run in a fresh Python process that
imports its own ``multimodal_biometric_fingerprints_palms_tpu_torch``:
``tools/polyu_set.py``'s 320x240 grey JPEGs (the first ``--files`` of 16
subjects, written once by this checkout) are decoded with
``utils.image_codec.read_gray``, and where the checkout reads them, the
format prints of ``tests/fixtures/formats/prints/`` (this checkout's: a
print an older checkout refuses is left out of its line). Each file is
decoded ``REPS`` times and counts with its median, which a shared
host's slow turns move less than one decode. Prints one JSON line a
checkout: the mean and median over files of each kind, ms a file, and the
card's name and power limit when ``nvidia-smi`` answers (the decode runs
on the host either way). Give the parent first and last (parent, change,
change, parent) to see the spread.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REPS = 5                    # decodes of each file; its median counts

CHILD = r"""
import json, statistics, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from multimodal_biometric_fingerprints_palms_tpu_torch.utils import image_codec
paths = [Path(p) for p in json.loads(sys.argv[2])]
reps = int(sys.argv[3])
kinds = {}
for p in paths:
    kind = "baseline JPEG" if p.parent.name != "prints" else "print " + p.name
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        try:
            image_codec.read_gray(p)
        except image_codec.ImageFormatError:
            break
        ms.append((time.perf_counter() - t0) * 1e3)
    if ms:
        kinds.setdefault(kind, []).append(statistics.median(ms))
print(json.dumps({k: {"files": len(v), "mean_ms": statistics.fmean(v),
                      "median_ms": statistics.median(v)}
                  for k, v in kinds.items()}))
"""


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--files", type=int, default=160)
    ap.add_argument("checkouts", nargs="*", default=[str(ROOT)])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "tools"))
    import polyu_set
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        files = polyu_set.write(Path(tmp), 16)
        jpegs = sorted(str(Path(tmp) / "sorted_dataset" / r) for r in files
                       if r.endswith(".jpg"))[:args.files]
        prints = sorted(str(p) for p in (
            ROOT / "tests" / "fixtures" / "formats" / "prints").glob("*"))
        for checkout in args.checkouts:
            out = subprocess.run(
                [sys.executable, "-c", CHILD, str(Path(checkout).resolve()),
                 json.dumps(jpegs + prints), str(REPS)],
                capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[-1]
            print(json.dumps({"checkout": checkout, "card": card,
                              "ms": json.loads(out)}))


if __name__ == "__main__":
    main()
