"""Models (counterpart of `strainer_gan_tpu/models/__init__.py`)."""
from __future__ import annotations

import torch

from ..config import ModelConfig
from .dcgan import Discriminator64, Generator64  # noqa: F401
from .layers import MaskedBatchNorm, init_dcgan_weights  # noqa: F401
from .mlp_gan import MLPDiscriminator, MLPGenerator  # noqa: F401


def build_models(cfg: ModelConfig, seed: int = 0):
    """(generator, discriminator) for a config, initialised from a CPU
    generator seeded with ``seed``: ``weights_init`` for the DCGAN, the
    ``DenseTorch`` uniform for the MLP (G's draws first, then D's)."""
    rng = torch.Generator().manual_seed(seed)
    if cfg.arch == "dcgan64":
        gen = Generator64(nz=cfg.nz, ngf=cfg.ngf, nc=cfg.nc)
        disc = Discriminator64(ndf=cfg.ndf, nc=cfg.nc)
        init_dcgan_weights(gen, rng)
        init_dcgan_weights(disc, rng)
    elif cfg.arch == "mlp":
        gen = MLPGenerator(rng, noise_size=cfg.nz, hidden=cfg.hidden, img_size=cfg.img_size,
                           batchnorm=cfg.g_batchnorm)
        disc = MLPDiscriminator(rng, img_size=cfg.img_size, hidden=cfg.hidden,
                                dropout=cfg.d_dropout)
    else:
        raise ValueError(f"unknown arch {cfg.arch!r}")
    return gen, disc
