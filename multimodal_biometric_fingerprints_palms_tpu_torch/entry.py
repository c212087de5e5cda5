"""Entry point of the port (the JAX package's ``__graft_entry__.entry``):
the flagship SSL forward (EfficientNetV2-S, 756 -> 512 -> 256, predictor
on) on 8 images of 224 x 224, on the card unless given ``device="cpu"``.

The weights are seeded from 0 with flax's initialisers
(``models.seed_weights``), not flax's own draws; the function
is the model, so a caller can load other weights into it
(``models.load_jax_variables``). ``dryrun_multichip`` waits for
``ROADMAP.md`` queue 1 item 5.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import SSLModel, seed_weights
from .utils.device import resolve_device


def entry(device=None):
    """Returns (fn, example_args): ``fn`` the SSL model in eval mode on
    ``device``, ``example_args`` one (8, 224, 224) float32 batch in [0, 1]
    (``np.random.default_rng(0)``, as the JAX entry point draws it)."""
    device = resolve_device(device, "entry")
    model = SSLModel(backbone_name="effnetv2_s", embedding_dim=756,
                     proj_hidden_dim=512, proj_output_dim=256)
    model = seed_weights(model, 0).to(device).eval()
    x = torch.from_numpy(
        np.random.default_rng(0).random((8, 224, 224), np.float32)).to(device)
    return model, (x,)
