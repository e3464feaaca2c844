"""Device-resident input pipeline (counterpart of
`strainer_gan_tpu/data/pipeline.py`).

The whole mixture lives on the device as uint8 NHWC; each step gathers its
batch by index and normalises it there.  Strained subsets are never
materialised: the strainer keeps a boolean ``active`` mask over the full
dataset, and the epoch sampler puts the active samples first.

A run over more than one host stages each rank's contiguous sample shard
only (``DeviceDataset.from_rank_local``, the counterpart of
`strainer_gan_tpu/data/pipeline.py:117-141`): ``gather`` and ``batch``
then take indices that every rank holds alike and bring the rows in
through one sum over ranks (``parallel.mesh.exchange``), which every rank
must enter; the scoring passes read the rank's own block (``local``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..parallel import mesh as M
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
    """uint8 images + source ids resident on ``device`` (default: the card).

    ``sharded``: the tensors hold this rank's rows ``[lo, lo + len)`` of
    ``n`` only."""

    sharded = False
    lo = 0

    def __init__(self, mixture: Mixture, device=None):
        self.device = resolve_device(device)
        self.images = torch.from_numpy(mixture.images).to(self.device)
        self.source_id = torch.from_numpy(mixture.source_id).to(self.device)
        self.n = mixture.images.shape[0]

    @classmethod
    def from_tensors(cls, images: torch.Tensor, source_id: torch.Tensor,
                     device=None) -> "DeviceDataset":
        """A dataset over tensors already on the device (views: nothing is
        copied)."""
        out = object.__new__(cls)
        out.device = images.device if device is None else device
        out.n = images.shape[0]
        out.images, out.source_id = images, source_id
        return out

    @classmethod
    def from_rank_local(cls, local: Mixture, n_global: int, device=None,
                        rank: Optional[int] = None) -> "DeviceDataset":
        """Stage this rank's shard only: ``local`` holds rows ``[rank * len,
        (rank + 1) * len)`` of ``n_global`` samples cut in equal shards
        (``parallel.multihost.shard_bounds``); ``rank`` defaults to the
        process group's.  Labels are not staged (the port reads none)."""
        out = cls(local, device)
        n_local = out.images.shape[0]
        if n_global % n_local:
            raise ValueError(f"{n_global} samples do not cut into shards of {n_local}")
        out.sharded, out.n = True, n_global
        out.lo = (M.rank() if rank is None else rank) * n_local
        return out

    def local(self) -> "DeviceDataset":
        """This rank's block as a dataset of its own (the whole dataset when
        it is not sharded)."""
        if not self.sharded:
            return self
        return DeviceDataset.from_tensors(self.images, self.source_id, self.device)

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """The images of ``idx``; on a sharded dataset every rank passes the
        same ``idx`` and gets every row."""
        if not self.sharded:
            return self.images.index_select(0, idx)
        return self._exchange(idx, lanes_only=False)[0]

    def batch(self, idx: torch.Tensor):
        """(images, source ids) of the rank's lanes of a global batch's
        sample indices ``idx`` (all of them without a process group); on a
        sharded dataset every rank passes the same ``idx``."""
        if not self.sharded:
            ids = M.lanes(idx)
            return self.images.index_select(0, ids), self.source_id[ids]
        return self._exchange(idx, lanes_only=True)

    def exchange_bytes(self, rows: int) -> int:
        """The bytes one exchange of ``rows`` rows sums over ranks."""
        return rows * (self.images[0].numel() + self.source_id.element_size())

    def _exchange(self, idx: torch.Tensor, lanes_only: bool):
        """Every rank writes the rows of ``idx`` it owns (image bytes, then
        the source id's bytes) and zeros elsewhere; one sum over ranks
        (``parallel.mesh.exchange``) leaves each row's owner's bytes."""
        b, n_local = idx.shape[0], self.images.shape[0]
        own = (idx >= self.lo) & (idx < self.lo + n_local)
        rows = torch.where(own, idx - self.lo, 0)
        src = self.source_id.index_select(0, rows)
        packed = torch.cat([self.images.index_select(0, rows).reshape(b, -1),
                            src.view(torch.uint8).reshape(b, -1)], 1)
        packed = M.exchange(torch.where(own.view(b, 1), packed, 0), lanes_only)
        width = src.element_size()
        images = packed[:, :-width].reshape((-1,) + tuple(self.images.shape[1:]))
        return images, packed[:, -width:].contiguous().view(src.dtype).reshape(-1)

    def all_source_ids(self) -> torch.Tensor:
        """The source ids of all ``n`` samples (gathered from every rank of a
        sharded dataset: a collective)."""
        return M.all_gather(self.source_id) if self.sharded else self.source_id

    def head(self, n: int) -> "DeviceDataset":
        """The first ``n`` samples as views of this dataset's tensors on the
        device: nothing is copied or staged again."""
        if self.sharded:
            raise ValueError("head of a sample-sharded dataset")
        n = min(n, self.n)
        return DeviceDataset.from_tensors(self.images[:n], self.source_id[:n], self.device)
