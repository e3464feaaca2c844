"""Device-resident input pipeline (counterpart of
`strainer_gan_tpu/data/pipeline.py`).

The whole mixture lives on the device as uint8 NHWC; each step gathers its
batch by index and normalises it there.  Strained subsets are never
materialised: the strainer keeps a boolean ``active`` mask over the full
dataset, and the epoch sampler puts the active samples first.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from .mixers import Mixture


def normalize_u8(batch_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC [0,255] -> NCHW ``dtype`` [-1,1]; ToTensor+Normalize(0.5,0.5)
    (`#%basic.py:73`), with the reference's float32 arithmetic."""
    x = batch_u8.to(torch.float32) * (2.0 / 255.0) - 1.0
    return x.permute(0, 3, 1, 2).contiguous().to(dtype)


def epoch_batch_indices(active: torch.Tensor, num: int, batch_size: int,
                        perm: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(num, batch_size) sample indices for one epoch
    (`strainer_gan_tpu/data/pipeline.py:32-78`).

    A random permutation of all N indices is stably partitioned active-first,
    and position ``p`` takes the ``p % n_active``-th shuffled active sample:
    the first ``n_active`` positions cover every active sample once, and the
    positions past it wrap around — the zero-weight padding lanes of the
    drop_last=False partial tail batch.  The permutation comes from ``perm``
    when the caller injects one (parity tests hand both packages the same
    order), else from ``generator``.
    """
    n = active.shape[0]
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=active.device)
    inactive = torch.logical_not(active[perm]).to(torch.uint8)
    order = perm[torch.argsort(inactive, stable=True)]
    n_active = torch.clamp(active.sum(), min=1)
    pos = torch.arange(num * batch_size, device=active.device) % n_active
    return order[pos].reshape(num, batch_size)


def device_full_and_tail(active: torch.Tensor, batch_size: int) -> torch.Tensor:
    """``[n_active // batch, n_active % batch]`` as one int64 device vector,
    with no host read (`strainer_gan_tpu/data/pipeline.py:82-91`): the
    deferred-stats path's full-step count and partial-tail size."""
    n_active = active.sum()
    return torch.stack([torch.div(n_active, batch_size, rounding_mode="floor"),
                        torch.remainder(n_active, batch_size)])


def device_step_count(active: torch.Tensor, batch_size: int,
                      drop_last: bool = True) -> torch.Tensor:
    """The epoch's step count as a 0-d int64 device tensor, with no host
    read (`strainer_gan_tpu/data/pipeline.py:94-104`): full batches, plus
    the partial one unless ``drop_last``."""
    n_active = active.sum()
    if not drop_last:
        n_active = n_active + (batch_size - 1)
    return torch.div(n_active, batch_size, rounding_mode="floor")


class DeviceDataset:
    """uint8 images + source ids resident on ``device`` (default: the card)."""

    def __init__(self, mixture: Mixture, device=None):
        self.device = resolve_device(device)
        self.images = torch.from_numpy(mixture.images).to(self.device)
        self.source_id = torch.from_numpy(mixture.source_id).to(self.device)
        self.n = mixture.images.shape[0]

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        return self.images.index_select(0, idx)

    def head(self, n: int) -> "DeviceDataset":
        """The first ``n`` samples as views of this dataset's tensors on the
        device: nothing is copied or staged again."""
        out = object.__new__(DeviceDataset)
        out.device, out.n = self.device, min(n, self.n)
        out.images, out.source_id = self.images[:out.n], self.source_id[:out.n]
        return out
