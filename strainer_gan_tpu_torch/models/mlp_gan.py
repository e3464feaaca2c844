"""MNIST MLP GAN (counterpart of `strainer_gan_tpu/models/mlp_gan.py:21-67`).

Two variants, as the reference family has them:

* plain (`#8.py:62-95`): G 100-256-512-1024-784 with ReLU and Tanh; D
  784-1024-512-256-1 with LeakyReLU(0.2), the sigmoid folded into the loss;
* full pipeline (`# 1,2,8.py:90-128`): G puts LeakyReLU(0.2) and then a
  BatchNorm1d after each hidden Linear; D adds Dropout(0.3) after each
  hidden activation.

G returns (N, 784) rows: tanh in float32, cast back to the compute type.
D flattens its input and returns float32 logits (N,).  D's dropout draws
nothing itself: a training forward takes its keep masks, one (N, width)
bool tensor per hidden layer, from the caller (``drop_masks``), so that a
CUDA graph replays fresh masks that were filled before each replay, and a
test can hand the port the JAX package's masks.  Kept activations are
scaled by 1 / (1 - p), as ``flax.linen.Dropout`` does.  On a tp-sharded D
(``parallel.mesh.put_state_tp``) a hidden layer's output holds the rank's
features only, and each full-width mask is cut to the same columns
(``parallel.mesh.tp_slice``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as M
from .layers import Linear, MaskedBatchNorm, leaky_relu


class MLPGenerator(nn.Module):
    """z (N, nz) -> (N, img_size) in [-1, 1]."""

    def __init__(self, generator: torch.Generator, noise_size: int = 100,
                 hidden: Tuple[int, ...] = (256, 512, 1024), img_size: int = 784,
                 batchnorm: bool = False):
        super().__init__()
        widths = (noise_size,) + tuple(hidden) + (img_size,)
        self.linears = nn.ModuleList(Linear(a, b, generator)
                                     for a, b in zip(widths[:-1], widths[1:]))
        self.bns = nn.ModuleList(MaskedBatchNorm(h) for h in hidden) if batchnorm else None

    def forward(self, z: torch.Tensor, sample_weights: Optional[torch.Tensor] = None,
                train: Optional[bool] = None) -> torch.Tensor:
        x = z
        for i, lin in enumerate(self.linears[:-1]):
            x = lin(x)
            if self.bns is not None:
                # `# 1,2,8.py`: LeakyReLU, then BatchNorm1d
                x = self.bns[i](leaky_relu(x), sample_weights, train)
            else:
                x = F.relu(x)
        x = self.linears[-1](x)
        return torch.tanh(x.to(torch.float32)).to(x.dtype)


class MLPDiscriminator(nn.Module):
    """image (N, ...) -> logits (N,) float32."""

    def __init__(self, generator: torch.Generator, img_size: int = 784,
                 hidden: Tuple[int, ...] = (256, 512, 1024), dropout: float = 0.0):
        super().__init__()
        widths = (img_size,) + tuple(reversed(hidden)) + (1,)
        self.linears = nn.ModuleList(Linear(a, b, generator)
                                     for a, b in zip(widths[:-1], widths[1:]))
        self.dropout = dropout

    def forward(self, x: torch.Tensor, sample_weights: Optional[torch.Tensor] = None,
                train: Optional[bool] = None,
                drop_masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``sample_weights`` is accepted for the step's interface and unused
        (D has no BatchNorm).  With dropout, a training forward needs
        ``drop_masks``; an eval forward (``train=False``) drops nothing."""
        if train is None:
            train = self.training
        drop = self.dropout > 0 and train
        hidden = len(self.linears) - 1
        if drop and (drop_masks is None or len(drop_masks) != hidden):
            raise ValueError(f"a training forward of D with dropout needs {hidden} keep masks")
        keep = 1.0 - self.dropout
        x = x.reshape(x.shape[0], -1)
        for i, lin in enumerate(self.linears[:-1]):
            x = leaky_relu(lin(x))
            if drop:
                m = M.tp_slice(drop_masks[i], x.shape[-1])
                x = torch.where(m, x / keep, torch.zeros_like(x))
        x = self.linears[-1](x)
        return x.reshape(x.shape[0]).to(torch.float32)
