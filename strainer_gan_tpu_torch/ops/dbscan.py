"""DBSCAN noise detection on features (counterpart of
`strainer_gan_tpu/ops/dbscan.py`).

The reference runs ``sklearn.cluster.DBSCAN(eps=20, min_samples=3)`` on
StandardScaler-normalised ResNet18 features and keeps only the fraction of
points labelled != -1 as a clean ratio (`# z_score + DBSCAN.py:272-302`).
Cluster identities are never used: a point is non-noise iff it is a core
point or lies within eps of one, which two neighbour-count passes (K3,
``kernels/pairwise.py``) decide.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import pairwise as KP
from ..kernels import zscore as KZ


def standardize(features: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``StandardScaler`` over the valid rows (`ops/dbscan.py:25-36`):
    population std, a zero std replaced by 1.  The column statistics come
    from K2a; the divide is plain, as in the JAX package."""
    mean, std = KZ.column_stats(features, valid, "population")
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    return (features - mean) / std


def dbscan_clean_ratio(features: torch.Tensor, eps: float = 20.0, min_samples: int = 3,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`estimate_ratio_dbscan` (`ops/dbscan.py:120-133`,
    `# z_score + DBSCAN.py:295-300`): the float32 fraction of the (valid)
    points that are non-noise after standardisation, a device scalar.
    Unmasked it is ``jnp.mean``, which XLA computes as the sum times the
    float32 reciprocal of N; masked, sum / max(sum(valid), 1).  Non-noise
    (`ops/dbscan.py:47`) is K3's two passes for CUDA tensors."""
    non_noise = KP.dbscan_non_noise(standardize(features, valid), eps, min_samples, valid)
    kept = non_noise.sum().to(torch.float32)
    if valid is None:
        return kept * torch.tensor(1.0 / features.shape[0], dtype=torch.float32,
                                   device=features.device)
    return kept / torch.clamp_min(valid.sum(), 1).to(torch.float32)
