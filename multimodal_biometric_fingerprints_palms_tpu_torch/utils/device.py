"""Where the port's entry points run: the card unless the caller asks for
another device."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None, what: str = "this entry point") -> torch.device:
    """``device`` as a ``torch.device``; None means the card. Raises if a
    CUDA device is asked for, by default or by name, and CUDA is not
    available: nothing falls back to the CPU unless asked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on a CUDA device by default and CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def full_float32():
    """Float32 convolutions and matrix products without TF32 inside the
    block, as the JAX package computes them; restores the settings after.
    cuDNN takes TF32 for float32 convolutions by default on Hopper."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
