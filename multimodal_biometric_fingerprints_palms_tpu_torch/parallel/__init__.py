"""1:N identification and all-pairs gallery scoring of the port, on one
device."""

from .mesh import create_mesh, gallery_sharding, replicated
from .gallery import (all_pairs_scores, all_pairs_unique, identify,
                      identify_batch, pad_gallery, shard_blocks_screen,
                      shard_gallery, shard_pairs_scores, shard_pairs_screen,
                      take_templates, unique_pairs)
