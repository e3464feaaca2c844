"""Scoring passes over the dataset (counterpart of
`strainer_gan_tpu/strain/score.py`).

Both passes gather uint8 batches from the device-resident dataset,
normalise them there, and run an eval-mode float32 forward (TF32 off, see
``device.f32_math``): strain decisions carry float32 rounding, as in the
reference.  Eval mode makes every score independent of its batch, so
batching by ``batch_size`` changes nothing but speed.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..data.pipeline import DeviceDataset, normalize_u8
from ..device import f32_math
from ..kernels.bce import bce_scores

FEATURE_DIM = 512  # the ResNet18 trunk's width


def _batched(fn: Callable[[torch.Tensor], torch.Tensor], dataset: DeviceDataset,
             out: torch.Tensor, batch_size: int,
             subset: Optional[torch.Tensor]) -> torch.Tensor:
    n = out.shape[0]
    with torch.no_grad(), f32_math():
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            if subset is None:
                batch = dataset.images[lo:hi]
            else:
                batch = dataset.gather(subset[lo:hi])
            out[lo:hi] = fn(normalize_u8(batch, torch.float32))
    return out


def score_d_losses(disc: torch.nn.Module, dataset: DeviceDataset,
                   real_label: float = 1.0, batch_size: int = 512,
                   subset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample BCE(D(x), real_label) with D in eval mode (`score.py:78-143`,
    `# final.py:343-356`).

    ``subset``: optional int64 indices; scores only those samples (the
    reference scores the prefiltered Subset, `# final.py:440-443`) and
    returns scores aligned with it.  The D forward writes its logits into
    one buffer, and ONE launch of the K1 kernel turns the whole buffer
    into losses in place (nothing reads the logits afterwards).
    """
    n = dataset.n if subset is None else subset.shape[0]
    logits = torch.empty((n,), dtype=torch.float32, device=dataset.device)
    _batched(lambda x: disc(x, train=False), dataset, logits, batch_size, subset)
    return bce_scores(logits, real_label, out=logits)


def score_features(feature_fn: Callable[[torch.Tensor], torch.Tensor],
                   dataset: DeviceDataset, batch_size: int = 512) -> torch.Tensor:
    """(N, 512) float32 ResNet18 features of every sample (`score.py:148-165`,
    `#z_score.py:276-283`)."""
    feats = torch.empty((dataset.n, FEATURE_DIM), dtype=torch.float32,
                        device=dataset.device)
    return _batched(feature_fn, dataset, feats, batch_size, None)
