"""Feature extractors for the strainers (counterpart of
`strainer_gan_tpu/models/features.py`).

``build_feature_fn`` returns ``f(normalised NCHW batch) -> (N, 512)`` for
the eval-mode ResNet18 trunk.  Its weights come from a staged torchvision
``resnet18.pt`` where there is one, found as the JAX package finds it
(`strainer_gan_tpu/models/resnet.py:239-253`): in ``$STRAINER_WEIGHTS_DIR``,
then in ``./weights``.  Otherwise the trunk takes the synthetic weights of
``synth_weights.py`` and warns (once per calling line, Python's default).  (With nothing staged the
JAX package's default is instead a flax initialisation from
``PRNGKey(0)``, which torch cannot reproduce.)
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Mapping, Optional

import torch

from ..device import resolve_device
from .resnet import ResNet18Features, load_staged_weights
from .synth_weights import load_synth_weights

def weights_roots():
    return [os.environ.get("STRAINER_WEIGHTS_DIR", ""), "./weights"]


def try_load_pretrained(name: str) -> Optional[Mapping]:
    """The staged torchvision ``state_dict`` ``<root>/<name>.pt`` of the
    first root that has one, or None (there is no download)."""
    for root in weights_roots():
        if not root:
            continue
        p = os.path.join(root, f"{name}.pt")
        if os.path.exists(p):
            return torch.load(p, map_location="cpu")
    return None


def build_feature_fn(name: str = "resnet18", channels: int = 3,
                     device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    if name != "resnet18" or channels != 3:
        raise ValueError(f"feature extractor {name!r} ({channels} ch) is not ported yet")
    model = ResNet18Features(channels)
    staged = try_load_pretrained(name)
    if staged is not None:
        load_staged_weights(model, staged)
    else:
        load_synth_weights(model)
        warnings.warn(f"no staged {name}.pt in $STRAINER_WEIGHTS_DIR or ./weights: the "
                      "feature trunk uses the synthetic weights of "
                      "models/synth_weights.py", stacklevel=2)
    model = model.eval().to(resolve_device(device))

    @torch.no_grad()
    def f(x: torch.Tensor) -> torch.Tensor:
        return model(x)

    return f
