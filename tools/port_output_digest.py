#!/usr/bin/env python3
"""Digests of the port's main-path outputs on one GPU, to compare two
checkouts byte for byte.

    python3 tools/port_output_digest.py --root CHECKOUT          # one tree
    python3 tools/port_output_digest.py --compare PARENT CHANGE  # two trees

With ``--root`` it imports the port from CHECKOUT, runs
``preprocess_fingerprint`` -> ``extract_minutiae`` -> ``postprocess_minutiae``
on ``make_batch(128)`` and on the 16 blob prints (both from this file's own
tree, so two checkouts see the same images), and prints one JSON line of
SHA-256 digests: the denoised image, the binary mask, the skeleton and every
field of the minutiae set. With ``--compare`` it runs itself once per
checkout, each in a process of its own, and exits 1 unless every digest
agrees; for every field that differs it prints how many elements moved and
by how much at most (the tensors themselves pass through ``--save`` files
in a temporary directory). A kernel change that claims bit-equal outputs is
checked this way, the parent commit unpacked beside the change
(``git archive``).

``--rate RUNS`` also times, in each checkout's process after its digest
run, RUNS synchronized runs of the main path on ``make_batch(batch)`` (img/s,
host clock) and five synchronized calls of the binarize stage on the same
run's segmented images (the median, ms), and prints them beside the
digests; they take no part in the comparison. Two ``--compare`` calls in
one session, the checkouts swapped, time the two in turns.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PKG = "multimodal_biometric_fingerprints_palms_tpu_torch"


def _synthetic():
    spec = importlib.util.spec_from_file_location(
        "_synthetic", HERE / PKG / "utils" / "synthetic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timing(x, segmented, runs: int) -> dict:
    """img/s of ``runs`` synchronized main-path runs on ``x``, and the
    median ms of five synchronized binarize-stage calls on ``segmented``."""
    import torch
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        extract_minutiae, postprocess_minutiae)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        enhance, preprocess_fingerprint)

    def path():
        res = preprocess_fingerprint(x)
        postprocess_minutiae(extract_minutiae(res.skeleton), res.skeleton)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    secs = wall(lambda: [path() for _ in range(runs)])
    stage = statistics.median(
        wall(lambda: enhance.binarize(segmented)) for _ in range(5))
    return {"img_s": x.shape[0] * runs / secs, "binarize_ms": stage * 1e3}


def digests(root: Path, batch: int, save: Path | None = None,
            rate: int = 0) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("port_output_digest: needs a GPU")
    sys.path.insert(0, str(root))
    from multimodal_biometric_fingerprints_palms_tpu_torch.features import (
        extract_minutiae, postprocess_minutiae)
    from multimodal_biometric_fingerprints_palms_tpu_torch.preprocessing import (
        preprocess_fingerprint)
    syn = _synthetic()
    out = {"card": torch.cuda.get_device_name(0)}
    kept = {}

    def sha(key, t):
        kept[key] = t.detach().cpu().contiguous()
        return hashlib.sha256(kept[key].numpy().tobytes()).hexdigest()[:24]

    for name, imgs in (("make_batch", syn.make_batch(batch)),
                       ("blob_prints", syn.blob_prints(range(16)))):
        x = torch.from_numpy(imgs).cuda()
        res = preprocess_fingerprint(x)
        ms = postprocess_minutiae(extract_minutiae(res.skeleton), res.skeleton)
        torch.cuda.synchronize()
        for field in ("denoised", "binary", "skeleton"):
            key = f"{name}.{field}"
            out[key] = sha(key, getattr(res, field))
        for field, value in zip(ms._fields, ms):
            key = f"{name}.minutiae.{field}"
            out[key] = sha(key, value)
        if rate and name == "make_batch":
            out["timing"] = timing(x, res.segmented, rate)
    if save is not None:
        torch.save(kept, save)
    return out


def moved(a, b) -> str:
    """How far two tensors of one field are apart."""
    import torch
    if a.shape != b.shape:
        return f"shapes {tuple(a.shape)} and {tuple(b.shape)}"
    ne = a != b
    if a.dtype.is_floating_point:
        ne &= ~(torch.isnan(a) & torch.isnan(b))
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()[ne]
    return (f"{int(ne.sum())} of {a.numel()} elements, max |d| "
            f"{float(d.max()) if d.numel() else 0.0:.6g}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path)
    ap.add_argument("--compare", nargs=2, type=Path, metavar="CHECKOUT")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--save", type=Path,
                    help="with --root: also write the tensors to this file")
    ap.add_argument("--rate", type=int, default=0, metavar="RUNS",
                    help="also time RUNS main-path runs and the binarize stage")
    args = ap.parse_args()
    if args.root:
        print(json.dumps(digests(args.root.resolve(), args.batch, args.save,
                                 args.rate)))
        return
    if not args.compare:
        ap.error("give --root or --compare")
    import torch
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    runs, tensors = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(args.compare):
            res = subprocess.run(
                [sys.executable, __file__, "--root", str(root), "--batch",
                 str(args.batch), "--save", f"{tmp}/{i}.pt", "--rate",
                 str(args.rate)],
                capture_output=True, text=True, check=False)
            if res.returncode:
                raise SystemExit(f"{root}: failed\n{res.stdout}\n{res.stderr}")
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
            tensors.append(torch.load(f"{tmp}/{i}.pt"))
            timed = runs[-1].pop("timing", None)
            print(f"{root}: {runs[-1]}")
            if timed:
                print(f"{root}: {args.rate} main-path runs {timed['img_s']:.1f} "
                      f"img/s, binarize stage {timed['binarize_ms']:.3f} ms "
                      f"(median of 5) on {runs[-1]['card']}")
    differ = [k for k in runs[0] if runs[0][k] != runs[1].get(k)]
    for k in differ:
        if k in tensors[0] and k in tensors[1]:
            print(f"  {k}: {moved(tensors[0][k], tensors[1][k])}")
    n = len(runs[0]) - 1      # the card's name is no tensor
    print(f"tensors compared {n}, tensors that differ: "
          f"{differ if differ else 'none'}")
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
