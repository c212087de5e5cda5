"""UNet++ segmentation inference of the port (the JAX package's
``preprocessing/segmentation_infer.py``), on the card unless given
``device="cpu"``.

``load_model`` reads a JAX-format checkpoint (the JAX package's
``train/seg_train.py`` payload ``{"params", "batch_stats", "opt_state",
"epoch"}``, ``utils/checkpoint.py``). ``segment_images`` runs each image of
a directory through it: INTER_AREA resize to the model's side, the grey
image replicated to three channels, the sigmoid, a linear resize back to
the frame, ``> threshold``; then writes ``_mask``, ``_segmented`` and
``_overlay.png`` through the port's codec. The overlay is the JAX
package's (h, w, 3) array ``[gray, gray, gray + 0.4 * mask]``, which
``cv2.imwrite`` takes as B, G, R; the port's PNG encoder takes the same
order (``utils/image_codec.encode_png``), so the mask lands in red.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..config import load_segmentation_config
from ..models.convert import load_jax_variables
from ..models.unetpp import NestedUNet
from ..utils import cvcompat
from ..utils.checkpoint import load_msgpack
from ..utils.device import resolve_device
from ..utils.io import read_image_grayscale, write_image
from ..utils.logging import console_step, get_file_logger

logger = get_file_logger(__name__, "data/metadata/inference.log")


def load_model(cfg, checkpoint: str | Path, device=None):
    """(model on ``device`` in eval mode, its input side) from a JAX-format
    UNet++ checkpoint."""
    device = resolve_device(device, "segmentation load_model")
    model = NestedUNet(filters=tuple(cfg.get("model.filters",
                                             [64, 128, 256, 512, 1024])))
    size = cfg.get("dataset.image_size", 256)
    payload = load_msgpack(checkpoint)
    load_jax_variables(model, {"params": payload["params"],
                               "batch_stats": payload.get("batch_stats", {})})
    return model.to(device).eval(), size


def segment_images(input_dir: str | Path, output_dir: str | Path,
                   checkpoint: str | Path, config_path: str | None = None,
                   threshold: float = 0.5, device=None) -> int:
    device = resolve_device(device, "segment_images")
    cfg = load_segmentation_config(config_path)
    model, size = load_model(cfg, checkpoint, device)

    input_dir, output_dir = Path(input_dir), Path(output_dir)
    n = 0
    for p in sorted(input_dir.glob("*")):
        if p.suffix.lower() not in {".jpg", ".jpeg", ".png", ".bmp"}:
            continue
        gray = read_image_grayscale(p).astype(np.float32) / 255.0
        h, w = gray.shape
        resized = cvcompat.resize(gray, (size, size), cvcompat.INTER_AREA)
        x = torch.from_numpy(np.stack([resized] * 3)[None]).to(device)
        with torch.no_grad():
            prob = torch.sigmoid(model(x))[0, 0].cpu().numpy()
        mask = (cvcompat.resize(prob, (w, h)) > threshold).astype(np.float32)

        write_image(output_dir / f"{p.stem}_mask.png", mask)
        write_image(output_dir / f"{p.stem}_segmented.png", gray * mask)
        overlay = np.stack([gray, gray, np.clip(gray + 0.4 * mask, 0, 1)], -1)
        write_image(output_dir / f"{p.stem}_overlay.png", overlay)
        logger.info("segmented %s", p.name)
        n += 1
    console_step(f"Segmented {n} images")
    return n


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    segment_images(args.input, args.output, args.checkpoint, args.config,
                   device=args.device)
