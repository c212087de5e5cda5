"""Batch preprocessing runner of the port (the JAX package's
``preprocessing/runner.py``).

Every image under the input directory is read on the host, zero-padded to
one canonical shape (the maximum over the run, rounded up to multiples of
32: the padding is part of each image's input, as in the JAX package),
stacked into batches, and run through ``preprocess_fingerprint`` on the
device: kernels A, B, C, E, F and G on the card, their plain twins on the
CPU. Only what is written leaves the device, as uint8 (images) and bool
(masks).

Outputs per image, preserving the cluster subdirectories:
  <out>/enhanced/<cluster>/<base>_enhanced.jpg   (segmented grey)
  <out>/enhanced/<cluster>/<base>_skeleton.jpg
  <out>/debug/<cluster>/<base>_{normalized,denoised,segmented,binary}.jpg
  <out>/debug/<cluster>/mask/<file name>          (with ``debug``)

Reading goes through the repository's native loader where it builds (it
needs libjpeg), else through the port's codec; a file the native loader
fails on (a PNG, or a frame over 1024 pixels a side) is read through the
codec, and only a file both fail on is logged as unreadable and skipped.
The two read paths differ in one respect, as the JAX package's do: the
codec turns an image by the EXIF orientation its file stores, as
``cv2.imread`` does, and the native loader's C++ decoder, like the JAX
package's, applies no orientation. The card's machine has no libjpeg, so
the card always reads through the codec. Masks written with ``debug`` keep
the input's file name, so a TIFF input's mask is a TIFF (LZW, horizontal
predictor, as ``cv2.imwrite`` writes it).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..config import load_fingerprint_config
from ..ops.cuda_kernels import bin_to_unit
from ..utils.device import resolve_device
from ..utils.io import encode_image, read_image_grayscale
from ..utils.logging import console_step, get_file_logger
from ..utils.transfer import to_u8
from .enhance import preprocess_fingerprint

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}
_STAGING = 1024          # the native loader's staging frame, pixels a side

logger = logging.getLogger(__name__)


def _find_images(input_dir: Path) -> list[Path]:
    out = []
    for p in sorted(input_dir.rglob("*")):
        if (p.is_file() and p.suffix.lower() in _IMAGE_EXTS
                and not p.stem.endswith(("_enhanced", "_skeleton", "_minutiae"))):
            out.append(p)
    return out


def _canonical_shape(shapes, multiple: int = 32) -> tuple[int, int]:
    h = max(s[0] for s in shapes)
    w = max(s[1] for s in shapes)
    return h + (-h) % multiple, w + (-w) % multiple


def _read_codec(path: Path):
    try:
        return read_image_grayscale(path)
    except (OSError, ValueError) as e:
        logger.error("unreadable image %s: %s", path, e)
        return None


def _read_all(paths: list[Path], batch_size: int, native: bool):
    """(images, reader name): one uint8 array per path, None where the
    file is unreadable. Native crops are copied out of the staging batch so
    that no view pins it."""
    if not native:
        return [_read_codec(p) for p in paths], "image_codec"
    from ..utils.native_loader import batch_load_u8
    images = []
    for i0 in range(0, len(paths), batch_size):
        chunk = paths[i0:i0 + batch_size]
        staged, status, ws, hs = batch_load_u8(chunk, _STAGING, _STAGING)
        for j, p in enumerate(chunk):
            images.append(staged[j, :hs[j], :ws[j]].copy() if status[j] == 0
                          else _read_codec(p))
    return images, "native"


def _gabor_setting(gabor: bool | None) -> tuple[bool, dict | None]:
    """(gabor, params): ``preprocessing.gabor`` of the fingerprint config
    decides when ``gabor`` is None; its parameters apply whenever the
    stage is on, without the ``enabled`` gate."""
    if gabor is not None and not gabor:
        return False, None
    gcfg = load_fingerprint_config().get("preprocessing.gabor", {}) or {}
    gcfg = dict(gcfg) if hasattr(gcfg, "get") else {}
    if gabor is None:
        gabor = bool(gcfg.get("enabled", False))
    gcfg.pop("enabled", None)
    return gabor, (gcfg if gabor else None)


def _device_outputs(batch_u8: torch.Tensor, gabor: bool,
                    gabor_params: dict | None, debug: bool) -> dict:
    """What leaves the device for a (B, H, W) uint8 batch on its device:
    the enhanced (segmented) grey as uint8 and the skeleton, and with
    ``debug`` the normalized and denoised greys and the binary and mask
    planes (the JAX package's ``_packed_pipeline_fn``, without bit
    packing)."""
    # a true division by a tensor: on CUDA a division by the Python scalar
    # 255.0 is a multiplication by its reciprocal, one ulp off
    x = bin_to_unit(batch_u8.to(torch.float32))
    res = preprocess_fingerprint(x, gabor=gabor, gabor_params=gabor_params)
    out = {"enhanced": to_u8(res.segmented), "skeleton": res.skeleton}
    if debug:
        out.update(normalized=to_u8(res.normalized),
                   denoised=to_u8(res.denoised),
                   binary=res.binary, mask=res.mask)
    return out


def run_preprocessing(input_dir: str | Path,
                      output_dir: str | Path = "dataset/processed",
                      batch_size: int = 32,
                      debug: bool = True,
                      small: bool = False,
                      use_native_loader: bool | None = None,
                      gabor: bool | None = None,
                      device=None) -> dict:
    """Enhance every image under ``input_dir`` (recursively; cluster_*
    subdirs preserved) on ``device`` (default: the card; pass ``"cpu"``
    to run there). Returns timing stats: ``total_seconds`` and
    ``images_per_second`` cover the device loop and the writes, as in the
    JAX package; ``seconds`` splits the run into read, device (enqueue and
    copy back), encode and write; ``reader`` names the reader used.

    use_native_loader: None = the native loader when the host has more
    than two cores and the library builds, True/False to force.
    """
    device = resolve_device(device, "run_preprocessing")
    get_file_logger(__name__, "data/metadata/preprocessing.log")
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    enhanced_dir = output_dir / "enhanced"
    debug_dir = output_dir / "debug"

    paths = _find_images(input_dir)
    if small:  # the reference's --small: the first 10 images
        paths = paths[:10]
    if not paths:
        logger.warning("no images under %s", input_dir)
        return {"num_images": 0}

    console_step(f"Preprocessing {len(paths)} images from {input_dir}")
    seconds = dict(read=0.0, device=0.0, encode=0.0, write=0.0)

    if use_native_loader is None:
        use_native_loader = (os.cpu_count() or 1) > 2
    native = False
    if use_native_loader:
        from ..utils.native_loader import native_available
        native = native_available()
    t0 = time.perf_counter()
    loaded, reader = _read_all(paths, batch_size, native)
    seconds["read"] = time.perf_counter() - t0
    images = [img for img in loaded if img is not None]
    metas = [(p, img.shape) for p, img in zip(paths, loaded) if img is not None]
    if not images:
        return {"num_images": 0}

    shape = _canonical_shape([m[1] for m in metas])
    gabor, gabor_params = _gabor_setting(gabor)

    def _enqueue(i):
        """Queue batch ``i`` and the copy of its outputs to (pinned) host
        memory; returns the host tensors and the event that marks them
        filled (None on the CPU, where every step is synchronous)."""
        chunk = images[i:i + batch_size]
        batch = np.zeros((len(chunk),) + shape, np.uint8)
        for j, img in enumerate(chunk):
            batch[j, :img.shape[0], :img.shape[1]] = img
        out = _device_outputs(torch.from_numpy(batch).to(device), gabor,
                              gabor_params, debug)
        host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return host, done

    def _write(path: Path, img: np.ndarray):
        t = time.perf_counter()
        data = encode_image(path, img)
        t1 = time.perf_counter()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        seconds["encode"] += t1 - t
        seconds["write"] += time.perf_counter() - t1

    t_start = time.perf_counter()
    n_done = 0
    starts = list(range(0, len(images), batch_size))
    # one-batch look-ahead: batch i + 1 is queued on the device before
    # batch i's outputs are waited for and written
    t = time.perf_counter()
    pending = _enqueue(starts[0])
    seconds["device"] += time.perf_counter() - t
    for bi, i in enumerate(starts):
        t = time.perf_counter()
        res, done = pending
        pending = _enqueue(starts[bi + 1]) if bi + 1 < len(starts) else None
        if done is not None:
            done.synchronize()
        res = {k: v.numpy() for k, v in res.items()}
        seconds["device"] += time.perf_counter() - t

        for j in range(len(images[i:i + batch_size])):
            path, (ih, iw) = metas[i + j]
            rel = path.parent.relative_to(input_dir)
            out_sub = enhanced_dir / rel
            base = path.stem
            _write(out_sub / f"{base}_enhanced.jpg",
                   res["enhanced"][j][:ih, :iw])
            _write(out_sub / f"{base}_skeleton.jpg",
                   res["skeleton"][j][:ih, :iw].astype(np.uint8) * 255)
            if debug:
                dbg = debug_dir / rel
                _write(dbg / f"{base}_normalized.jpg",
                       res["normalized"][j][:ih, :iw])
                _write(dbg / f"{base}_denoised.jpg",
                       res["denoised"][j][:ih, :iw])
                _write(dbg / f"{base}_segmented.jpg",
                       res["enhanced"][j][:ih, :iw])
                _write(dbg / f"{base}_binary.jpg",
                       res["binary"][j][:ih, :iw].astype(np.uint8) * 255)
                _write(dbg / "mask" / path.name,
                       res["mask"][j][:ih, :iw].astype(np.uint8) * 255)
            logger.info("processed %s", path.name)
        n_done += len(images[i:i + batch_size])

    total = time.perf_counter() - t_start
    stats = {
        "num_images": n_done,
        "total_seconds": total,
        "images_per_second": n_done / max(total, 1e-9),
        "canonical_shape": shape,
        "seconds": seconds,
        "reader": reader,
    }
    console_step(f"Done: {n_done} images in {total:.1f}s "
                 f"({stats['images_per_second']:.1f} img/s)")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description="Batch fingerprint preprocessing")
    ap.add_argument("--input", default="dataset/sorted_dataset")
    ap.add_argument("--output", default="dataset/processed")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--no-debug", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    run_preprocessing(args.input, args.output, batch_size=args.batch_size,
                      debug=not args.no_debug, small=args.small,
                      device=args.device)


if __name__ == "__main__":
    main()
