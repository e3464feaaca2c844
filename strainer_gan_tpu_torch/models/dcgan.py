"""DCGAN 64x64 generator/discriminator (counterpart of
`strainer_gan_tpu/models/dcgan.py`, reference `#%basic.py:106-182`).

NCHW, bias-free convs with kernel 4, BatchNorm placement, ReLU /
LeakyReLU(0.2) and Tanh as the reference.  D returns float32 LOGITS; the
sigmoid lives in the loss.  Every BatchNorm takes per-sample weights, and
D keeps the reference port's stem/head split (`dcgan.py:100-121`): the
stem (conv0 -> LeakyReLU -> conv1) has no BatchNorm, the head starts at
the first one.  ``train`` chooses batch or running statistics per call.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MaskedBatchNorm


class Generator64(nn.Module):
    """z (N, nz) -> image (N, nc, 64, 64) in [-1, 1]."""

    def __init__(self, nz: int = 100, ngf: int = 64, nc: int = 3):
        super().__init__()
        self.nz = nz
        g = ngf
        specs = [(nz, g * 8, 1, 0), (g * 8, g * 4, 2, 1), (g * 4, g * 2, 2, 1),
                 (g * 2, g, 2, 1), (g, nc, 2, 1)]
        self.convs = nn.ModuleList(
            nn.ConvTranspose2d(cin, cout, 4, s, p, bias=False) for cin, cout, s, p in specs
        )
        self.bns = nn.ModuleList(MaskedBatchNorm(cout) for _, cout, _, _ in specs[:-1])

    def forward(self, z: torch.Tensor, sample_weights: Optional[torch.Tensor] = None,
                train: Optional[bool] = None) -> torch.Tensor:
        x = z.reshape(z.shape[0], self.nz, 1, 1)
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x), sample_weights, train))
        x = self.convs[-1](x)
        return torch.tanh(x.to(torch.float32)).to(x.dtype)


class Discriminator64(nn.Module):
    """image (N, nc, 64, 64) -> logits (N,) float32."""

    def __init__(self, ndf: int = 64, nc: int = 3):
        super().__init__()
        d = ndf
        specs = [(nc, d, 2, 1), (d, d * 2, 2, 1), (d * 2, d * 4, 2, 1),
                 (d * 4, d * 8, 2, 1), (d * 8, 1, 1, 0)]
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 4, s, p, bias=False) for cin, cout, s, p in specs
        )
        self.bns = nn.ModuleList(MaskedBatchNorm(c) for c in (d * 2, d * 4, d * 8))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv0 -> LeakyReLU -> conv1 (raw, pre-BN): mask-independent."""
        return self.convs[1](F.leaky_relu(self.convs[0](x), 0.2))

    def head(self, h: torch.Tensor, sample_weights: Optional[torch.Tensor] = None,
             train: Optional[bool] = None) -> torch.Tensor:
        x = h  # BN_i -> LeakyReLU -> conv_{i+2}, the last conv giving (N,1,1,1)
        for conv, bn in zip(self.convs[2:], self.bns):
            x = conv(F.leaky_relu(bn(x, sample_weights, train), 0.2))
        return x.reshape(x.shape[0]).to(torch.float32)

    def forward(self, x: torch.Tensor, sample_weights: Optional[torch.Tensor] = None,
                train: Optional[bool] = None) -> torch.Tensor:
        return self.head(self.stem(x), sample_weights, train)
