"""1:N identification and all-pairs gallery scoring of the port, on one
device or sharded over the ranks of a process group, and the mesh and
launcher those ranks share."""

from .mesh import Mesh, create_mesh, gallery_sharding, replicated
from .gallery import (GalleryShard, ShardedGallery, all_pairs_scores,
                      all_pairs_unique, identify, identify_batch, pad_gallery,
                      shard_blocks_screen, shard_gallery, shard_pairs_scores,
                      shard_pairs_screen, take_templates, unique_pairs)
from .launch import RankError, RankGroup, run_ranks, start_ranks
