"""Embedding extraction with an npz cache (the JAX package's
``classifier/embeddings.py``): a batched no-grad forward of the port's
``SSLModel`` on its device, the predictor's (projection's) output when
``use_projection`` is true, else the backbone embedding, L2-normalised on
the host; cached as ``embeddings`` (N, D) and ``paths`` (object array), the
JAX file's layout.

The model holds its weights, so the JAX function's ``variables`` argument
has no counterpart. The last batch is not padded to the batch size: in
eval mode BatchNorm uses its running statistics, so a row's output does not
depend on the rows beside it (the JAX package pads only to keep one
compiled shape).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..models.ssl_model import SSLModel
from .data import _read_or_blank, preprocess_image


def extract_embeddings(model: SSLModel, paths: Sequence[str | Path],
                       batch_size: int = 32,
                       image_size: int = 256,
                       cache_file: str | Path | None = None,
                       overwrite: bool = False,
                       use_projection: bool = True,
                       l2_normalize: bool = True,
                       seconds: dict | None = None,
                       ) -> tuple[np.ndarray, list[str]]:
    """Returns (embeddings (N, D), paths). Cached to ``cache_file`` npz.
    Runs on the model's device; ``seconds``, if given, receives the host
    time of reading and decoding the files (``read``), of preprocessing
    them (``preprocess``) and of the forward passes with the copy back
    (``forward``)."""
    if cache_file is not None:
        cache_file = Path(cache_file)
        if cache_file.exists() and not overwrite:
            data = np.load(cache_file, allow_pickle=True)
            return data["embeddings"], list(data["paths"])

    device = next(model.parameters()).device
    model.eval()
    out: list[torch.Tensor] = []
    kept_paths: list[str] = []
    batch_buf: list[np.ndarray] = []
    t_read = t_pre = t_fwd = 0.0

    def flush():
        nonlocal t_fwd
        if not batch_buf:
            return
        t0 = time.perf_counter()
        x = torch.from_numpy(np.stack(batch_buf)).to(device)
        with torch.no_grad():
            proj, emb = model(x, return_embedding=True)
        # stays on the device: the next batch's preprocessing overlaps it
        out.append(proj if use_projection else emb)
        batch_buf.clear()
        t_fwd += time.perf_counter() - t0

    for p in paths:
        t0 = time.perf_counter()
        img = _read_or_blank(p, (image_size, image_size))
        t1 = time.perf_counter()
        t_read += t1 - t0
        try:
            img = preprocess_image(img, resize=(image_size, image_size))
        except (OSError, ValueError):
            continue  # per-item fail-soft, as the JAX function
        finally:
            t_pre += time.perf_counter() - t1
        batch_buf.append(img)
        kept_paths.append(str(p))
        if len(batch_buf) == batch_size:
            flush()
    flush()

    t0 = time.perf_counter()
    embeddings = (torch.cat(out).cpu().numpy() if out
                  else np.zeros((0, model.proj_output_dim), np.float32))
    t_fwd += time.perf_counter() - t0
    if l2_normalize and embeddings.size:
        norms = np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True),
                           1e-12)
        embeddings = embeddings / norms

    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache_file, embeddings=embeddings,
                 paths=np.asarray(kept_paths, dtype=object))
    if seconds is not None:
        seconds.update(read=t_read, preprocess=t_pre, forward=t_fwd)
    return embeddings, kept_paths
