#!/usr/bin/env python3
"""Genuine-pair scores of PolyU-sized prints with and without the runner's
zero padding, with and without the JPEG round trip.

    python3 tools/padded_frame_pairs.py [--seeds 11-26] [--device cpu|cuda]

For each seed, two impressions of ``utils.synthetic.blob_prints`` (ridge
phases 0 and 0.06 rad, the genuine pair of ``tools/polyu_set.py``) at
320 x W go through the port's chain in a 320x256 frame (W = 240: PolyU's
width, zero-padded on the right as ``run_preprocessing`` pads it; W = 256:
no padding), raw or through the port's JPEG encoder and decoder (byte-equal
to OpenCV's), and are matched under the production FRR gates. Prints, per
case, the foreground-mask pixels of both impressions, the valid minutiae
and the genuine score of each seed, and how many pairs score 0.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from multimodal_biometric_fingerprints_palms_tpu_torch.features import (  # noqa: E402
    extract_minutiae, postprocess_minutiae)
from multimodal_biometric_fingerprints_palms_tpu_torch.features.minutiae import (  # noqa: E402
    MinutiaeSet)
from multimodal_biometric_fingerprints_palms_tpu_torch.matching.cuda_match import (  # noqa: E402
    match_pairs_batch)
from multimodal_biometric_fingerprints_palms_tpu_torch.matching.ransac import (  # noqa: E402
    MatchParams)
from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing.runner import (  # noqa: E402
    _device_outputs)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.image_codec import (  # noqa: E402
    decode_gray, encode_jpeg)
from multimodal_biometric_fingerprints_palms_tpu_torch.utils.synthetic import (  # noqa: E402
    blob_prints)

FRR = MatchParams(dist_thresh=30.0, orient_thresh=math.radians(30.0),
                  min_inliers=6, ransac_iter=300, stop_inlier_ratio=0.15,
                  seed=42)


def case(seeds, width, jpeg, device):
    px = np.round(blob_prints([s for s in seeds for _ in (0, 1)],
                              [0.0, 0.06] * len(seeds), 320, width)
                  * 255.0).astype(np.uint8)
    if jpeg:
        px = np.stack([decode_gray(encode_jpeg(img)) for img in px])
    batch = np.zeros((len(px), 320, 256), np.uint8)
    batch[:, :, :width] = px
    out = _device_outputs(torch.from_numpy(batch).to(device), False, None,
                          True)
    skel = out["skeleton"].to(torch.float32)
    ms = postprocess_minutiae(extract_minutiae(skel), skel)
    a = MinutiaeSet(*(f[0::2] for f in ms))
    b = MinutiaeSet(*(f[1::2] for f in ms))
    score = match_pairs_batch(a, b, FRR).final_score.cpu().numpy()
    mask = out["mask"].sum(dim=(1, 2)).cpu().numpy().reshape(-1, 2)
    return mask, ms.count.cpu().numpy().reshape(-1, 2), score


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="11-26")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    lo, hi = (int(v) for v in args.seeds.split("-"))
    seeds = list(range(lo, hi + 1))
    torch.set_num_threads(8)
    for width in (240, 256):
        for jpeg in (False, True):
            mask, count, score = case(seeds, width, jpeg, torch.device(
                args.device))
            print(f"width {width}, {'JPEG' if jpeg else 'raw'}: genuine "
                  f"pairs scoring 0: {int((score == 0).sum())} of "
                  f"{len(seeds)}")
            for s, m, c, v in zip(seeds, mask, count, score):
                print(f"  seed {s}: mask px {m[0]} / {m[1]}, minutiae "
                      f"{c[0]} / {c[1]}, score {v:.3f}")


if __name__ == "__main__":
    main()
