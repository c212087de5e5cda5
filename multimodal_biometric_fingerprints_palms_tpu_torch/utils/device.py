"""Where the port's entry points run: the card unless the caller asks for
another device."""

from __future__ import annotations

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
