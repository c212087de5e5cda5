"""Clustering of the port (the JAX package's ``clustering/``): kmeans,
PCA, two-stage agglomerative, quality metrics; on the device of the
input."""

from .kmeans import kmeans, kmeans_plus_plus_init
from .pca import pca_reduce
from .agglomerative import agglomerative_fast
from .metrics import (
    silhouette_score_cosine, davies_bouldin_index, calinski_harabasz_index,
    evaluate_clustering,
)
