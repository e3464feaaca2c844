"""Feature extractors for the strainers (counterpart of
`strainer_gan_tpu/models/features.py`).

``build_feature_fn`` returns ``f(normalised NCHW batch) -> (N, 512)`` for
the eval-mode ResNet18 trunk with the synthetic weights of
``synth_weights.py`` (the slice's only extractor).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from .resnet import ResNet18Features
from .synth_weights import load_synth_weights


def build_feature_fn(name: str = "resnet18", channels: int = 3,
                     device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    if name != "resnet18" or channels != 3:
        raise ValueError(f"feature extractor {name!r} ({channels} ch) is not ported yet")
    model = load_synth_weights(ResNet18Features(channels)).eval()
    model = model.to(resolve_device(device))

    @torch.no_grad()
    def f(x: torch.Tensor) -> torch.Tensor:
        return model(x)

    return f
