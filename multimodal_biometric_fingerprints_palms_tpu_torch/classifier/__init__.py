"""SSL front of the port (the JAX package's ``classifier/``), inference
half: image discovery and preprocessing, embeddings, the SSL pipeline and
the cluster sorter."""

from .data import (collect_image_paths, extract_id, global_id_for,
                   preprocess_image)
from .embeddings import extract_embeddings
