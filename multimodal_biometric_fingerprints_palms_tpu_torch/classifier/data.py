"""SSL data of the port (the JAX package's ``classifier/data.py``): image
discovery, subject ids, the contrastive augmentations and two-view
batching of training, and the inference preprocessing, host numpy over the
port's codec (the JAX package's is host numpy over OpenCV;
``utils/cvcompat.py`` holds its OpenCV calls). The same
``np.random.Generator`` draws in the same order give views bit-equal to
the JAX package's.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterator, Sequence

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


class FingerprintAugmentations:
    """Two-view contrastive augmentations: rotation +-15 deg (or a multiple
    of 90, p=0.2), flips, random crop 0.8-1.0 -> INTER_AREA resize,
    brightness/contrast jitter, gaussian noise 0.015."""

    def __init__(self, image_size: int = 224,
                 rng: np.random.Generator | None = None):
        self.image_size = image_size
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        img = img.astype(np.float32)
        if img.max() > 1.0:
            img = img / 255.0
        h, w = img.shape

        if rng.random() < 0.8:
            angle = rng.uniform(-15, 15)
        else:
            angle = float(rng.choice([0, 90, 180, 270]))
        m = cvcompat.rotation_matrix_2d((w // 2, h // 2), angle, 1.0)
        img = cvcompat.warp_affine_linear(img, m, (w, h))

        if rng.random() < 0.5:
            img = np.fliplr(img)
        if rng.random() < 0.3:
            img = np.flipud(img)

        crop_scale = rng.uniform(0.8, 1.0)
        crop_size = int(crop_scale * min(h, w))
        if crop_size < min(h, w):
            x = rng.integers(0, w - crop_size + 1)
            y = rng.integers(0, h - crop_size + 1)
            img = img[y:y + crop_size, x:x + crop_size]
        img = cvcompat.resize(np.ascontiguousarray(img),
                              (self.image_size, self.image_size),
                              cvcompat.INTER_AREA)

        if rng.random() < 0.5:
            alpha = rng.uniform(0.8, 1.2)
            beta = rng.uniform(-0.1, 0.1)
            img = np.clip(alpha * img + beta, 0, 1)
        if rng.random() < 0.5:
            img = np.clip(img + rng.normal(0, 0.015, img.shape), 0, 1)
        return img.astype(np.float32)


def two_view_batches(paths: Sequence[Path], batch_size: int,
                     image_size: int = 224, seed: int = 42,
                     drop_last: bool = True
                     ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Shuffled epoch of two independently augmented views per image; a
    file the codec cannot read is skipped (``cv2.imread`` returning None in
    the JAX package)."""
    rng = np.random.default_rng(seed)
    aug = FingerprintAugmentations(image_size, rng)
    order = rng.permutation(len(paths))
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        xi, xj = [], []
        for p in idx:
            try:
                img = read_image_grayscale(paths[p])
            except (OSError, ImageFormatError):
                continue
            xi.append(aug(img))
            xj.append(aug(img))
        if xi:
            yield np.stack(xi), np.stack(xj)


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
