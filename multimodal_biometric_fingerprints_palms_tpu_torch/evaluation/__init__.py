"""Evaluation metrics of the port."""

from .metrics import (compute_eer, evaluate_far_across_thresholds,
                      evaluate_frr_across_thresholds)
