"""Shared layers (counterpart of `strainer_gan_tpu/models/layers.py`).

Convolutions are ``nn.Conv2d`` / ``nn.ConvTranspose2d`` as the reference
scripts use them (`#%basic.py:106-182`).  ``MaskedBatchNorm`` is
``nn.BatchNorm2d`` on (N, C, H, W) and ``nn.BatchNorm1d`` on (N, C) (eps
1e-5, momentum 0.1, biased batch variance to normalise, unbiased variance
for the running update; statistics over every axis but the channel's)
extended with per-sample weights, which torch's BatchNorms do not take:
zero-weight lanes (the padding of a partial tail batch) influence neither
the batch statistics nor the running ones (`layers.py:147-220`).  Inside
a sharded train step (``parallel.mesh.batch_sharded``) the statistics are
the global batch's: the weight sum, the weighted sum and the centred square
sum are summed over ranks (two passes, as on one rank), and without weights
the ranks' means and centred variances are merged; with no process group
the arithmetic is exactly the single-rank one.

The MLP's layers: ``Linear`` is ``nn.Linear`` with the JAX package's
``DenseTorch`` initialisation drawn from the caller's generator
(`layers.py:223-251`), and ``leaky_relu`` selects with ``x >= 0`` as
`layers.py:254-255` does.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel import mesh as M


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, sample_weights: Optional[torch.Tensor] = None,
                train: Optional[bool] = None) -> torch.Tensor:
        if train is None:
            train = self.training
        dims = (0,) + tuple(range(2, x.dim()))  # all but the channel axis
        per_channel = (1, -1) + (1,) * (x.dim() - 2)
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.to(torch.float32)
            # under a sharded step the statistics are the global batch's
            # (parallel/mesh.py); R is the identity otherwise
            R = M.all_reduce_sum if M.sharded() else (lambda t: t)
            if sample_weights is None:
                n = float(x.numel() // x.shape[1])
                var, mean = torch.var_mean(xf, dim=dims, unbiased=False)
                if M.sharded():
                    # every rank holds n lanes' values: merge the ranks' means
                    # and centred variances (exact at world size 1: f = 1)
                    f = 1.0 / M.dp_world()
                    n *= M.dp_world()
                    mean_l = mean
                    mean = R(mean_l * f)
                    var = R((var + (mean_l - mean) ** 2) * f)
                denom = max(n - 1.0, 1.0)
            else:
                w = sample_weights.to(torch.float32).view((-1,) + (1,) * (x.dim() - 1))
                # a rank whose lanes are all padding adds 0 to each sum
                n = torch.clamp(R(w.sum()) * (x.numel() // (x.shape[0] * x.shape[1])),
                                min=1.0)
                denom = torch.clamp(n - 1.0, min=1.0)
                mean = R((xf * w).sum(dim=dims)) / n
                var = R((w * (xf - mean.view(per_channel)) ** 2).sum(dim=dims)) / n
            with torch.no_grad():
                m = self.momentum
                unbiased = var.detach() * n / denom
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean.detach())
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        # one multiply-add per element, per-channel coefficients in float32
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        return x * a.to(x.dtype).view(per_channel) + b.to(x.dtype).view(per_channel)



class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias start U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), drawn from ``generator`` on the CPU (weight, then
    bias)."""

    def __init__(self, fan_in: int, features: int, generator: torch.Generator):
        super().__init__(fan_in, features)
        bound = 1.0 / fan_in ** 0.5
        with torch.no_grad():
            for p in (self.weight, self.bias):
                p.copy_((torch.rand(p.shape, generator=generator) * 2.0 - 1.0) * bound)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def init_dcgan_weights(module: nn.Module, generator: torch.Generator) -> None:
    """``weights_init`` (`#%basic.py:93-99`): conv weights ~ N(0, 0.02),
    BN scale ~ N(1, 0.02), BN bias 0; drawn from ``generator`` on the CPU."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
            elif isinstance(m, MaskedBatchNorm):
                m.weight.copy_(1.0 + torch.randn(m.weight.shape, generator=generator) * 0.02)
                m.bias.zero_()
