"""1:1 RANSAC minutiae matching of the port."""

from .cuda_match import (
    match_minutiae_pair, match_pairs_batch, screen_promote_batch,
)
from .ransac import MatchParams, MatchResult, compute_descriptor_weights
