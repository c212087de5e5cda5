"""Models of the port: the SSL backbone, head and predictor, UNet++ and
the training losses (the JAX package's ``models/``)."""

from .backbone import (EFFNETV2_S, EFFNETV2_TINY, STAGE_PLANS,
                       FingerprintBackbone, FusedMBConv, MBConv,
                       SqueezeExcite)
from .projection_head import ProjectionHead, WeightNormDense
from .ssl_model import Predictor, SSLModel
from .unetpp import ConvBlock, NestedUNet
from .losses import (dice_coeff, dice_loss, focal_tversky_loss, iou_score,
                     nt_xent_loss)
from .seeding import seed_weights
from .convert import (load_jax_variables, ssl_state_from_jax,
                      ssl_variables_from_state, unet_state_from_jax,
                      unet_variables_from_state)
