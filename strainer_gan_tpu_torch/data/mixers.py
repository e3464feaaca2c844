"""Contamination mixers (counterpart of `strainer_gan_tpu/data/mixers.py`).

A mixture is ``images`` + per-sample ``source_id`` (0 = primary/clean) in
mixer order; ``shuffled_combined`` is one seeded shuffle of the
concatenation (`#z_score.py:98-114`), the other mixers keep it in order.
The images are gathered into that order by the host-staging library
(``native.gather_u8``; ``gather_plain`` is its plain version).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import native
from ..config import DataConfig
from .datasets import ArrayDataset, load_source


@dataclass
class Mixture:
    images: np.ndarray  # uint8 NHWC, already in mixer order
    source_id: np.ndarray  # int32 (N,), 0 = primary/clean
    labels: np.ndarray

    def __len__(self):
        return self.images.shape[0]

    @property
    def contaminated(self) -> np.ndarray:
        return self.source_id != 0


def build_mixture(cfg: DataConfig, max_synth: Optional[int] = None) -> Mixture:
    """`strainer_gan_tpu/data/mixers.py:45-80`, byte for byte."""
    rng = np.random.default_rng(cfg.seed)
    datasets = []
    primary_len = None
    for i, spec in enumerate(cfg.sources):
        ds = load_source(spec, cfg.image_size, cfg.channels, cfg.seed + i,
                         max_synth=max_synth)
        if i == 0:
            primary_len = len(ds)
        if spec.fraction_of_primary is not None:
            k = int(primary_len * spec.fraction_of_primary)
            idx = rng.choice(len(ds), size=min(k, len(ds)), replace=False)
            ds = ArrayDataset(ds.images[idx], ds.labels[idx])
        datasets.append(ds)

    images = np.concatenate([d.images for d in datasets], axis=0)
    labels = np.concatenate([d.labels for d in datasets], axis=0)
    source_id = np.concatenate(
        [np.full(len(d), i, np.int32) for i, d in enumerate(datasets)]
    )
    order = np.arange(len(images))
    if cfg.mixer == "shuffled_combined":
        rng.shuffle(order)
    elif cfg.mixer not in ("combined", "labeled", "concat"):
        raise ValueError(f"unknown mixer {cfg.mixer!r}")
    return Mixture(native.gather_u8(images, order), source_id[order], labels[order])


def gather_plain(images: np.ndarray, order: np.ndarray) -> np.ndarray:
    """The plain version of the mixture's gather (``native.gather_u8``)."""
    return images[order]
