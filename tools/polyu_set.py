#!/usr/bin/env python3
"""Writes a PolyU-shaped synthetic dataset for the port's file pipeline.

    python3 tools/polyu_set.py --out <dir> [--subjects 148]

``<dir>/sorted_dataset/cluster_{0,1}/`` receives ``subjects`` x 10 grey
JPEGs of 320x240 (H x W), PolyU's size, named ``<subject>_<impression>_
<session>.jpg`` (impressions 1-5, sessions 1-2), half the subjects in each
cluster directory: one blob-constellation print a subject
(``utils.synthetic.blob_prints``), its ridge phase moved by 0.06 rad from
one impression to the next. Beside them: one NIST-named 8-bit BMP
(``F0001_1.bmp``), one colour PNG (``S0001_1.png``) and one TIFF
(``S0002_1.tif``, which every stage must log as unreadable and skip). Every
file is written by the port's encoders (the JPEGs are byte-equal to what
``cv2.imwrite`` writes). 148 subjects make 1,480 images, PolyU's count.

``--raw`` writes the unsorted tree the SSL front reads instead:
``<dir>/DBII/``, the same JPEGs, flat (``write_raw``; its ``nist`` argument
adds ``<dir>/Nist/``, ``nist`` subjects x 2 impressions as NIST-named PNGs,
``F0501_01.png``, prints of their own seeds).

    python3 tools/polyu_set.py --out <dir> --raw [--subjects 148]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (  # noqa: E402
    encode_bmp, encode_jpeg, encode_png)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (  # noqa: E402
    blob_prints)

H, W = 320, 240
PHASE_STEP = 0.06


def write(root: Path, subjects: int) -> dict:
    """Write the set under ``root/sorted_dataset``; returns {relative
    path: suffix}."""
    out = {}
    for s in range(1, subjects + 1):
        names = [(imp, sess) for imp in range(1, 6) for sess in (1, 2)]
        prints = blob_prints([10 + s] * len(names),
                             [PHASE_STEP * k for k in range(len(names))], H, W)
        for (imp, sess), img in zip(names, prints):
            rel = f"cluster_{(s - 1) * 2 // subjects}/{s}_{imp}_{sess}.jpg"
            out[rel] = encode_jpeg(np.round(img * 255.0).astype(np.uint8))
    extra = np.round(blob_prints([901, 902], None, H, W) * 255.0).astype(np.uint8)
    out["cluster_0/F0001_1.bmp"] = encode_bmp(extra[0])
    tint = np.stack([extra[1], (extra[1] * 0.9).astype(np.uint8),
                     255 - extra[1] // 4], axis=-1)
    out["cluster_1/S0001_1.png"] = encode_png(tint)
    out["cluster_1/S0002_1.tif"] = b"II*\x00" + bytes(64)
    for rel, data in out.items():
        path = root / "sorted_dataset" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    return {rel: Path(rel).suffix for rel in out}


def write_raw(root: Path, subjects: int, nist: int = 0) -> dict:
    """Write ``root/DBII`` (PolyU-named JPEGs, ``subjects`` x 10) and
    ``root/Nist`` (NIST-named PNGs, ``nist`` x 2); returns {relative path:
    suffix}."""
    out = {}
    for s in range(1, subjects + 1):
        names = [(imp, sess) for imp in range(1, 6) for sess in (1, 2)]
        prints = blob_prints([10 + s] * len(names),
                             [PHASE_STEP * k for k in range(len(names))], H, W)
        for (imp, sess), img in zip(names, prints):
            out[f"DBII/{s}_{imp}_{sess}.jpg"] = encode_jpeg(
                np.round(img * 255.0).astype(np.uint8))
    for s in range(1, nist + 1):
        prints = blob_prints([700 + s] * 2, [0.0, PHASE_STEP], H, W)
        for imp, img in enumerate(prints, 1):
            out[f"Nist/F{500 + s:04d}_{imp:02d}.png"] = encode_png(
                np.round(img * 255.0).astype(np.uint8))
    for rel, data in out.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    return {rel: Path(rel).suffix for rel in out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, type=Path)
    ap.add_argument("--subjects", type=int, default=148)
    ap.add_argument("--raw", action="store_true",
                    help="write DBII/ and Nist/ instead of sorted_dataset/")
    args = ap.parse_args()
    if args.raw:
        files = write_raw(args.out, args.subjects)
        print(f"{len(files)} files under {args.out / 'DBII'}")
    else:
        files = write(args.out, args.subjects)
        print(f"{len(files)} files under {args.out / 'sorted_dataset'}")


if __name__ == "__main__":
    main()
