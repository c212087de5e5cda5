"""What the kinds of work share: the frame and its canvas, the pinned host
copy of an input, a no-op span, and the seed's draw of what the comparison
samples."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import gen


def frame(config: dict) -> tuple[int, int, int, int]:
    """(h, w, canvas h, canvas w): the configuration's frame as its source
    gives it, and as it reaches the card, zero-padded as the preprocessing
    runner pads it."""
    h, w = config["frame"]["height"], config["frame"]["width"]
    return (h, w) + gen.canvas_shape(h, w)


def host_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host, in pinned memory where a card will read it."""
    h = x.cpu()
    return h.pin_memory() if x.device.type == "cuda" else h


@contextlib.contextmanager
def no_span(name: str):
    yield


def sampler(seed: int, salt: int) -> np.random.Generator:
    """The seed's generator of what a comparison samples."""
    return np.random.default_rng([int(seed) % 2 ** 63, salt])


def free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
