"""Models (counterpart of `strainer_gan_tpu/models/__init__.py`)."""
from __future__ import annotations

import torch

from ..config import ModelConfig
from .dcgan import Discriminator64, Generator64  # noqa: F401
from .layers import MaskedBatchNorm2d, init_dcgan_weights  # noqa: F401


def build_models(cfg: ModelConfig, seed: int = 0):
    """(generator, discriminator) for a config, initialised by
    ``weights_init`` from a CPU generator seeded with ``seed``."""
    if cfg.arch != "dcgan64":
        raise ValueError(f"arch {cfg.arch!r} is not ported yet")
    gen = Generator64(nz=cfg.nz, ngf=cfg.ngf, nc=cfg.nc)
    disc = Discriminator64(ndf=cfg.ndf, nc=cfg.nc)
    rng = torch.Generator().manual_seed(seed)
    init_dcgan_weights(gen, rng)
    init_dcgan_weights(disc, rng)
    return gen, disc
