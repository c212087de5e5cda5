"""Non-local means: the wrapper of kernel E (``csrc/nlm.cu``).

Replaces the TPU kernels ``ops/pallas_kernels.py:nlm_denoise_pallas_sym``
(with ``_nlm_ring_pallas`` and ``_nlm_sym_planes_small``) and
``nlm_denoise_pallas_blocked``. Those split the work to suit the MXU: banded
matmuls for the template sums, each SSD reused for the mirrored offset, the
13-px border ring recomputed apart. On the card every output pixel visits
all search offsets in the plain twin's order, so one wrapper serves every
entry point, shape and precision, bit-equal to the twin. The kernel is bound
by instruction issue (441 offsets of about 20 float operations and an
``expf`` per pixel against 8 bytes of traffic), and what it must keep down
is shared-memory traffic and barriers. For the main path's windows (7, 21)
a 64x64 tile per block keeps the squared differences in registers: a thread
forms 16 vertical 7-sums from 22 differences, then 16 horizontal 7-sums from
22 vertical sums, with its centre pixels and accumulators in registers for
all 441 offsets, one barrier per offset, and bf16 roundings taken two at a
time through one packed conversion. Tiles that this body does not
serve (ragged edges, frames under 64 px, other windows) go to the generic
body, which passes both planes through shared memory (see the source).

The plain twin and the dispatcher live in ``ops/denoise.py``
(``nlm_denoise_plain``, ``nlm_denoise``).
"""

from __future__ import annotations

import torch

from ..kernels import build as _build
from ..utils.profiling import count


def nlm_denoise_cuda(x: torch.Tensor, h: float = 10.0,
                     template_window: int = 7, search_window: int = 21,
                     precision: str = "bf16") -> torch.Tensor:
    """Kernel E on a CUDA (..., H, W) float32 tensor in [0,1]; same contract
    as ``ops.denoise.nlm_denoise_plain``."""
    if x.device.type != "cuda":
        raise ValueError(f"nlm_denoise_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"nlm_denoise_cuda needs float32, got {x.dtype}")
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision must be 'bf16' or 'f32', got {precision!r}")
    if template_window % 2 == 0 or search_window % 2 == 0:
        raise ValueError("template_window and search_window must be odd")
    if x.dim() < 2:
        raise ValueError(f"need (..., H, W), got {tuple(x.shape)}")
    hh, ww = x.shape[-2:]
    if hh < 2 or ww < 2:
        raise ValueError(f"H, W ({hh}, {ww}) must be at least 2")
    flat = x.reshape(-1, hh, ww).contiguous()
    b = flat.shape[0]
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside 1..65535")
    hn = h / 255.0
    inv = -1.0 / (hn * hn) / float(template_window ** 2)
    out = torch.empty_like(flat)
    rc = _build.load_library().mbfp_nlm(
        flat.data_ptr(), out.data_ptr(), b, hh, ww, int(template_window),
        int(search_window), inv, int(precision == "bf16"),
        _build.current_stream(x))
    _build.check(rc, "mbfp_nlm")
    count("kernel.nlm")
    return out.reshape(x.shape)
