"""The autoencoder strainer's network (counterpart of
`strainer_gan_tpu/models/autoencoder.py`, reference `#autoencoder.py:269-291`).

encoder Conv(3,16,3,s2,p1) - ReLU - Conv(16,32,3,s2,p1) - ReLU - Conv(32,64,7);
decoder ConvT(64,32,7) - ReLU - ConvT(32,16,3,s2,p1,op1) - ReLU -
ConvT(16,3,3,s2,p1,op1) - Tanh; every layer with a bias.  NCHW, 64x64 ->
64x10x10 -> 64x64.  Trained with MSE; the per-sample reconstruction error
feeds the mean + 2 sigma strainer (`#autoencoder.py:307-322`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ConvAutoEncoder(nn.Module):
    def __init__(self, nc: int = 3):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(nc, 16, 3, 2, 1), nn.Conv2d(16, 32, 3, 2, 1), nn.Conv2d(32, 64, 7)])
        self.deconvs = nn.ModuleList([
            nn.ConvTranspose2d(64, 32, 7),
            nn.ConvTranspose2d(32, 16, 3, 2, 1, output_padding=1),
            nn.ConvTranspose2d(16, nc, 3, 2, 1, output_padding=1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.convs[0](x))
        x = F.relu(self.convs[1](x))
        x = F.relu(self.deconvs[0](self.convs[2](x)))
        x = F.relu(self.deconvs[1](x))
        return torch.tanh(self.deconvs[2](x))


def init_ae_weights(ae: ConvAutoEncoder, generator: torch.Generator) -> None:
    """The JAX package's initialisation (`models/layers.py` ``dcgan_conv_init``
    and zero biases): kernels ~ N(0, 0.02) drawn from ``generator`` on the
    CPU, biases 0."""
    with torch.no_grad():
        for m in ae.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
                m.bias.zero_()


def reconstruction_errors(recon: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error (`#autoencoder.py:315`): (N, ...) -> (N,)."""
    diff = (recon.to(torch.float32) - x.to(torch.float32)) ** 2
    return diff.reshape(diff.shape[0], -1).mean(dim=1)
