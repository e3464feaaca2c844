"""The device-resident potential-fake pool (counterpart of
`strainer_gan_tpu/strain/pool.py`).

`preprocess_potential_fake_data` (`# strainer gan + concate.py:557-568`):
the z-score outliers are sampled down to ``fraction * N`` images and staged
on the device once, as uint8; every D step of a pool config then gathers a
batch of them and concatenates it onto the generated fakes
(``train/steps.py``, ``pool_concat``).
"""
from __future__ import annotations

import torch

from ..data.pipeline import DeviceDataset


def fake_pool_rows(outlier_mask: torch.Tensor, fraction: float,
                   perm: torch.Tensor) -> torch.Tensor:
    """The dataset indices of the pool's ``max(int(N * fraction), 1)`` rows
    (`strainer_gan_tpu/strain/pool.py:19-40`).

    ``perm``, a random permutation of all N indices (the Trainer draws it
    from its pool generator; the tests hand in JAX's), is stably
    partitioned outliers first; the pool takes its first ``num`` entries,
    wrapping around when there are fewer outliers than ``num`` (the
    reference's ``np.random.choice(..., replace=False)`` would fail there;
    the JAX package resamples, and so does this)."""
    n = outlier_mask.shape[0]
    dev = outlier_mask.device
    num = max(int(n * fraction), 1)
    perm = perm.to(dev)
    inlier = torch.logical_not(outlier_mask[perm]).to(torch.uint8)
    shuffled = perm[torch.argsort(inlier, stable=True)]  # outliers, in random order
    n_out = torch.clamp(outlier_mask.sum(), min=1)
    return shuffled[torch.arange(num, device=dev) % n_out]


def build_fake_pool(dataset: DeviceDataset, outlier_mask: torch.Tensor, fraction: float,
                    perm: torch.Tensor) -> torch.Tensor:
    """The pool's images, uint8 NHWC on the dataset's device: the rows
    ``fake_pool_rows`` picks."""
    return dataset.gather(fake_pool_rows(outlier_mask.to(dataset.device), fraction, perm))
