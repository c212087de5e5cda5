"""Evaluation metrics and reports of the port."""

from .metrics import (compute_eer, compute_minutiae_statistics,
                      evaluate_far_across_thresholds,
                      evaluate_frr_across_thresholds, report_scores)
from .roc import plot_roc
