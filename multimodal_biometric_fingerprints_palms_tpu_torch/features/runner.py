"""Batch minutiae extraction runner of the port (the JAX package's
``features/runner.py``).

Walks ``<input>/<cluster>/*_skeleton.jpg``, reads each skeleton through the
port's codec and ``> 127``, pads the batch to multiples of 32, runs
``extract_minutiae`` -> ``postprocess_minutiae`` on the device, and writes
per image (the reference's schema):

  <out>/<cluster>/<base>_minutiae.json
  <out>/<cluster>/<base>_minutiae.jpg   (overlay: "red" endings and "green"
      bifurcations in OpenCV's BGR order, as the JAX package writes them:
      (255, 0, 0) lands in the blue channel)
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.io import (encode_image, minutiae_to_json, read_image_grayscale,
                        save_minutiae_json)
from ..utils.logging import console_step, get_file_logger
from .minutiae import extract_minutiae
from .quality import postprocess_minutiae

logger = logging.getLogger(__name__)


def _overlay(skel: np.ndarray, records: list[dict]) -> np.ndarray:
    vis = np.stack([(skel > 0.5).astype(np.uint8) * 255] * 3, axis=-1)
    for m in records:
        color = (255, 0, 0) if m["type"] == "ending" else (0, 255, 0)
        y, x = m["y"], m["x"]
        vis[max(0, y - 3):y + 4, max(0, x - 3):x + 4] = color
    return vis


def process_directory(input_base: str | Path = "dataset/processed/enhanced",
                      output_base: str | Path = "dataset/processed/minutiae",
                      batch_size: int = 32,
                      device=None) -> dict:
    """Extract minutiae from every skeleton under ``input_base`` on
    ``device`` (default: the card; pass ``"cpu"`` to run there). Returns
    timing stats; ``seconds`` splits the run into read, device, json
    (records built and written), encode (the overlay) and write."""
    device = resolve_device(device, "process_directory")
    get_file_logger(__name__,
                    "dataset/processed/minutiae/minutiae_extraction.log")
    input_base, output_base = Path(input_base), Path(output_base)
    if not input_base.exists():
        raise FileNotFoundError(f"input base not found: {input_base}")

    skel_paths = sorted(input_base.rglob("*_skeleton.jpg"))
    if not skel_paths:
        logger.warning("no skeleton images under %s", input_base)
        return {"num_images": 0}

    console_step(f"Minutiae extraction: {len(skel_paths)} skeletons")
    seconds = dict(read=0.0, device=0.0, json=0.0, encode=0.0, write=0.0)

    t0 = time.perf_counter()
    images, metas = [], []
    for p in skel_paths:
        try:
            img = read_image_grayscale(p) > 127
        except (OSError, ValueError) as e:
            logger.error("corrupt skeleton %s: %s", p, e)
            continue
        images.append(img)
        metas.append((p, img.shape))
    seconds["read"] = time.perf_counter() - t0
    if not images:
        return {"num_images": 0}

    shape_h = max(m[1][0] for m in metas)
    shape_w = max(m[1][1] for m in metas)
    shape = (shape_h + (-shape_h) % 32, shape_w + (-shape_w) % 32)

    def _enqueue(i):
        chunk = images[i:i + batch_size]
        batch = np.zeros((len(chunk),) + shape, bool)
        for j, img in enumerate(chunk):
            batch[j, :img.shape[0], :img.shape[1]] = img
        skels = torch.from_numpy(batch).to(device).to(torch.float32)
        ms = postprocess_minutiae(extract_minutiae(skels), skels)
        host = [f.to("cpu", non_blocking=True) for f in ms]
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return host, done

    t_start = time.perf_counter()
    n_done = 0
    starts = list(range(0, len(images), batch_size))
    t = time.perf_counter()
    pending = _enqueue(starts[0])
    seconds["device"] += time.perf_counter() - t
    for bi, i in enumerate(starts):
        t = time.perf_counter()
        fields, done = pending
        pending = _enqueue(starts[bi + 1]) if bi + 1 < len(starts) else None
        if done is not None:
            done.synchronize()
        xy, mtype, ori, qual, coh, stab, valid = (f.numpy() for f in fields)
        seconds["device"] += time.perf_counter() - t

        for j in range(len(images[i:i + batch_size])):
            path, _ = metas[i + j]
            rel = path.parent.relative_to(input_base)
            out_dir = output_base / rel
            base = path.name.replace("_skeleton.jpg", "")
            t = time.perf_counter()
            records = minutiae_to_json(xy[j], mtype[j], ori[j], qual[j],
                                       coh[j], stab[j], valid[j])
            save_minutiae_json(out_dir / f"{base}_minutiae.json", records)
            t1 = time.perf_counter()
            overlay_path = out_dir / f"{base}_minutiae.jpg"
            overlay = encode_image(overlay_path, _overlay(images[i + j], records))
            t2 = time.perf_counter()
            overlay_path.write_bytes(overlay)
            seconds["json"] += t1 - t
            seconds["encode"] += t2 - t1
            seconds["write"] += time.perf_counter() - t2
            logger.info("extracted %d minutiae from %s", len(records), path.name)
        n_done += len(images[i:i + batch_size])

    total = time.perf_counter() - t_start
    stats = {"num_images": n_done, "total_seconds": total,
             "images_per_second": n_done / max(total, 1e-9),
             "seconds": seconds}
    console_step(f"Done: {n_done} skeletons in {total:.1f}s")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description="Batch minutiae extraction")
    ap.add_argument("--input", default="dataset/processed/enhanced")
    ap.add_argument("--output", default="dataset/processed/minutiae")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    process_directory(args.input, args.output, batch_size=args.batch_size,
                      device=args.device)


if __name__ == "__main__":
    main()
