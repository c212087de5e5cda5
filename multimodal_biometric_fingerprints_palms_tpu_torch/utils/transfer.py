"""What leaves the device for the file runners: float images as uint8.

``to_u8`` quantizes on the device, so a (B, H, W) float32 stage image
crosses PCIe as a quarter of its bytes. Masks cross as ``bool`` (a byte a
pixel); packing them to bits on the device is a choice of layout the JAX
package made for a slow host link, and a batch's masks are a few MB here.
"""

from __future__ import annotations

import torch


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> uint8: ``round(clip(x, 0, 1) * 255)``, half to even
    (the JAX package's ``device_to_u8``)."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
