"""SSL front of the port (the JAX package's ``classifier/``): image
discovery, the training views (host and device), preprocessing,
embeddings, the SSL pipeline and the cluster sorter."""

from .data import (FingerprintAugmentations, collect_image_paths, extract_id,
                   global_id_for, preprocess_image, two_view_batches)
from .embeddings import extract_embeddings
