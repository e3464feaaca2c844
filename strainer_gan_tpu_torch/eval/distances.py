"""Feature-space distances of the eval suite (counterpart of
`strainer_gan_tpu/eval/distances.py`).

* ``mean_feature_distance``: the L2 distance between the mean ResNet50
  features of two sets (`#strainer gan.py:473-489`);
* ``pca_wasserstein_distance``: a PCA fitted on the first set (at most 50
  components, `# strainer gan + concate.py:496`), the second set projected
  on it, and the mean over components of the 1-D Wasserstein distance
  (`#strainer gan.py:491-507`).

The PCA is the SVD of the centred matrix with sklearn's ``svd_flip`` sign
rule (each component's largest-magnitude entry made positive), as the JAX
package applies it (`distances.py:40-43`); W1 is the mean absolute
difference of the sorted samples when the counts are equal, else both
empirical CDFs on the merged grid (``scipy.stats.wasserstein_distance``).
Plain torch calls in float32 with TF32 off (``device.f32_math``): no TPU
kernel sits behind them in the JAX package either.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import f32_math


def mean_feature_distance(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """`calculate_feature_distance` (`#strainer gan.py:488-489`)."""
    return torch.linalg.vector_norm(f1.mean(0) - f2.mean(0))


def pca_fit_transform(x: torch.Tensor, n_components: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sklearn's PCA fit on ``x``: (projections, mean, components)."""
    with f32_math():
        mean = x.mean(0)
        xc = x - mean
        _, _, vt = torch.linalg.svd(xc, full_matrices=False)
        comps = vt[:n_components]
        # svd_flip: the sign of each row's largest-|value| entry
        idx = torch.argmax(comps.abs(), dim=1)
        signs = torch.sign(comps.gather(1, idx[:, None]))
        comps = comps * signs
        return xc @ comps.T, mean, comps


def pca_transform(x: torch.Tensor, mean: torch.Tensor, comps: torch.Tensor) -> torch.Tensor:
    with f32_math():
        return (x - mean) @ comps.T


def wasserstein_1d(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """W1 between the empirical distributions of 1-D samples ``u`` and ``v``
    (equal weights); batched over a leading axis when both are 2-D."""
    u = torch.sort(u, dim=-1).values
    v = torch.sort(v, dim=-1).values
    if u.shape[-1] == v.shape[-1]:
        return (u - v).abs().mean(-1)
    all_v = torch.sort(torch.cat([u, v], dim=-1), dim=-1).values
    deltas = torch.diff(all_v, dim=-1)
    grid = all_v[..., :-1].contiguous()
    # side="right": the count of samples <= each grid value
    u_cdf = torch.searchsorted(u, grid, right=True) / u.shape[-1]
    v_cdf = torch.searchsorted(v, grid, right=True) / v.shape[-1]
    return ((u_cdf - v_cdf).abs() * deltas).sum(-1)


def pca_wasserstein_distance(f1: torch.Tensor, f2: torch.Tensor,
                             n_components: int = 50) -> torch.Tensor:
    """`calculate_wasserstein_distance` (`#strainer gan.py:491-507`): PCA
    fitted on ``f1``, ``f2`` projected, the mean of the per-component W1."""
    f1 = f1.reshape(f1.shape[0], -1)
    f2 = f2.reshape(f2.shape[0], -1)
    k = min(n_components, f1.shape[1], f2.shape[1])
    p1, mean, comps = pca_fit_transform(f1, k)
    p2 = pca_transform(f2, mean, comps)
    return wasserstein_1d(p1.T.contiguous(), p2.T.contiguous()).mean()
