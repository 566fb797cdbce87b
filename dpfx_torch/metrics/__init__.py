"""The evaluation suite: pairwise CD/EMD matrices, MMD/COV/1-NNA/JSD, and
the AE-reconstruction and generation protocols."""

from dpfx_torch.metrics.generation import (compute_all_metrics, jsd_between_sets, mmd_cov,
                                           one_nna, pairwise_matrix, per_category_mmd_cov)
from dpfx_torch.metrics.protocol import evaluate_generation, evaluate_reconstruction

__all__ = [
    "compute_all_metrics",
    "evaluate_generation",
    "evaluate_reconstruction",
    "jsd_between_sets",
    "mmd_cov",
    "one_nna",
    "pairwise_matrix",
    "per_category_mmd_cov",
]
