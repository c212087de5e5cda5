"""SSL data of the port, the inference half (the JAX package's
``classifier/data.py``): image discovery, subject ids and the inference
preprocessing, host numpy over the port's codec (the JAX package's is host
numpy over OpenCV; ``utils/cvcompat.py`` holds the four OpenCV calls).

The contrastive augmentations and two-view batching wait for training
(``ROADMAP.md`` queue 1 item 4).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Sequence

import numpy as np

from ..utils import cvcompat
from ..utils.image_codec import ImageFormatError
from ..utils.io import read_image_grayscale

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def collect_image_paths(dirs: Sequence[str | Path]) -> list[Path]:
    paths: list[Path] = []
    for d in dirs:
        d = Path(d)
        for ext in _EXTS:
            paths.extend(d.rglob(f"*{ext}"))
    return sorted(paths)


def extract_id(fname: str) -> str:
    """Unique subject ID from a filename: NIST 'F0001_01' -> '1'; DBII
    '1_1_1' -> '1'."""
    stem = Path(fname).stem.lower()
    if stem.startswith("f") and re.match(r"f\d{4}_\d{2}$", stem):
        return str(int(stem[1:].split("_")[0]))
    num = stem.split("_")[0]
    return num.lstrip("0") or "0"


def global_id_for(path: str | Path) -> str:
    """Dataset-prefixed ID: ``DBII_<id>``, ``NIST_<id>`` or ``UNK_<id>``."""
    s = str(path)
    if "/DBII/" in s or "\\DBII\\" in s:
        prefix = "DBII"
    elif "/Nist/" in s or "\\Nist\\" in s:
        prefix = "NIST"
    else:
        prefix = "UNK"
    return f"{prefix}_{extract_id(Path(s).name)}"


def local_contrast_normalization(img: np.ndarray, kernel_size: int = 15
                                 ) -> np.ndarray:
    mean_local = cvcompat.blur(img, (kernel_size, kernel_size))
    std_local = cvcompat.blur((img - mean_local) ** 2,
                              (kernel_size, kernel_size)) ** 0.5
    std_local = np.clip(std_local, 1e-6, None)
    out = (img - mean_local) / std_local
    return (out - out.min()) / (out.max() - out.min() + 1e-8)


def estimate_dominant_orientation(img: np.ndarray) -> float:
    gy, gx = np.gradient(img)
    orientation = np.arctan2(gy, gx)
    hist, bins = np.histogram(orientation, bins=180, range=(-np.pi, np.pi))
    return float(bins[np.argmax(hist)])


def _read_or_blank(path: str | Path, resize) -> np.ndarray:
    """The image as uint8, or zeros of ``resize`` where it cannot be read
    (``cv2.imread`` returning None in the JAX package)."""
    try:
        return read_image_grayscale(path)
    except (OSError, ImageFormatError):
        return np.zeros(resize, dtype=np.uint8)


def preprocess_image(img_or_path, resize=(256, 256), local_norm: bool = True,
                     align: bool = True) -> np.ndarray:
    """Inference preprocessing: INTER_AREA resize, [0, 1] scale, local
    contrast normalization, rotation by the dominant gradient orientation."""
    if isinstance(img_or_path, (str, Path)):
        img = _read_or_blank(img_or_path, resize)
    else:
        img = img_or_path
    img = cvcompat.resize(img, resize, cvcompat.INTER_AREA).astype(np.float32)
    img = img / 255.0 if img.max() > 1.0 else img
    if local_norm:
        img = local_contrast_normalization(img)
    if align:
        angle = np.degrees(estimate_dominant_orientation(img))
        h, w = img.shape
        m = cvcompat.rotation_matrix_2d((w // 2, h // 2), angle, 1.0)
        img = cvcompat.warp_affine_linear(img, m, (w, h))
    return img.astype(np.float32)
