"""Host-side I/O of the port: images and minutiae JSON (the JAX package's
``utils/io.py``), in numpy, zlib and JSON only.

Images are read and written through the port's own codec
(``utils/image_codec.py``) on every machine: the card's machine has no
libjpeg, and the port imports neither OpenCV nor PIL. Reading gives what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives; writing picks the format
from the suffix (JPEG at quality 95, PNG, BMP), as ``cv2.imwrite`` does.

The minutiae schema is the reference's:

    [{"x": int, "y": int, "type": "ending"|"bifurcation", "orientation": float,
      "quality": float, "coherence": float, "angular_stability": float}, ...]

and the (N, 7) matrix layout is [x, y, type (0 ending / 1 bifurcation),
orientation, quality, coherence, angular_stability].
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .image_codec import encode_for, read_gray

MINUTIA_TYPES = ("ending", "bifurcation")


def read_image_grayscale(path: str | Path) -> np.ndarray:
    """Read an image as a 2-D uint8 array (``ImageFormatError`` for a
    format the codec does not read, ``OSError`` for a missing file)."""
    return read_gray(path)


def encode_image(path: str | Path, img: np.ndarray) -> bytes:
    """The file bytes ``write_image`` writes: a uint8 array as it is; any
    other dtype scaled by 255 if its maximum is at most 1, clipped to
    [0, 255] and truncated to uint8 (the JAX package's rule)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 + 1e-6 else arr, 0, 255)
        arr = arr.astype(np.uint8)
    return encode_for(path, arr)


def write_image(path: str | Path, img: np.ndarray) -> None:
    """Write a uint8 (or float in [0,1]) image; the suffix names the
    format."""
    path = Path(path)
    data = encode_image(path, img)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)


def minutiae_to_json(xy: np.ndarray, types: np.ndarray, orientation: np.ndarray,
                     quality: np.ndarray, coherence: np.ndarray,
                     angular_stability: np.ndarray, valid: np.ndarray) -> list[dict]:
    """Convert padded fixed-K arrays of one template to JSON records."""
    out = []
    for i in np.nonzero(np.asarray(valid))[0]:
        out.append({
            "x": int(xy[i, 0]),
            "y": int(xy[i, 1]),
            "type": MINUTIA_TYPES[int(types[i])],
            "orientation": float(orientation[i]),
            "quality": float(quality[i]),
            "coherence": float(coherence[i]),
            "angular_stability": float(angular_stability[i]),
        })
    return out


def save_minutiae_json(path: str | Path, records: list[dict]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(records, f, indent=2)


def load_minutiae_matrix(path: str | Path) -> np.ndarray:
    """Load minutiae JSON into the (N, 7) float64 matrix."""
    with open(path) as f:
        records = json.load(f)
    if not records:
        return np.zeros((0, 7), dtype=np.float64)
    rows = []
    for r in records:
        rows.append([
            float(r["x"]), float(r["y"]),
            0.0 if r.get("type", "ending") == "ending" else 1.0,
            float(r.get("orientation", 0.0)),
            float(r.get("quality", 0.0)),
            float(r.get("coherence", 0.0)),
            float(r.get("angular_stability", 0.0)),
        ])
    return np.asarray(rows, dtype=np.float64)


def pad_minutiae(mat: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad an (N, 7) matrix to (k, 7) float32 plus a (k,) validity mask;
    rows past ``k`` are dropped."""
    n = min(mat.shape[0], k)
    out = np.zeros((k, 7), dtype=np.float32)
    out[:n] = mat[:n]
    valid = np.zeros((k,), dtype=bool)
    valid[:n] = True
    return out, valid
