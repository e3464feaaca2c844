"""Feature extractors for the strainers and the eval suite (counterpart of
`strainer_gan_tpu/models/features.py`).

``build_feature_fn`` returns ``f(normalised NCHW batch) -> (N, 512)`` for
the eval-mode ResNet18 trunk, ``(N, 2048)`` for the eval suite's ResNet50
(``resnet50``, `#strainer gan.py:474-486`; built once per (name,
channels, device) and reused, as the JAX package's ``_build`` caches it,
since the suite asks for it at each eval), or for ``resnet18_1ch`` its
1-channel variant (`# 1,2,8.py:141-151`, ``mnist_full``'s prefilter),
which also takes flattened (N, H*W) MLP rows when given
``flatten_input_hw`` (`strainer_gan_tpu/models/features.py:72-101`).  The
3-channel trunks' weights come from a staged torchvision ``resnet18.pt``
or ``resnet50.pt`` where there is one, found as the JAX package finds it (`strainer_gan_tpu/models/resnet.py:239-253`):
in ``$STRAINER_WEIGHTS_DIR``, then in ``./weights``.  The 1-channel trunk
never loads staged weights, as in the JAX package (`features.py:57-60`).
Otherwise the trunk takes the synthetic weights of ``synth_weights.py`` and
warns (once per calling line, Python's default).  (With nothing staged
the JAX package's default is instead a flax initialisation from
``PRNGKey(0)``, which torch cannot reproduce; a test bridges those
weights with ``bridge.resnet18_state_dict_from_flax``.)  The trunk runs in
float32 with TF32 off (``device.f32_math``): its features decide the
strain.
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Mapping, Optional, Tuple

import torch

from ..device import f32_math, resolve_device
from .resnet import STAGES, ResNetFeatures, load_staged_weights
from .synth_weights import load_synth_weights

_TRUNKS = {}  # (name, channels, device) -> the built ResNet50 feature function


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


def build_feature_fn(name: str = "resnet18", channels: int = 3, device=None,
                     flatten_input_hw: Optional[Tuple[int, int]] = None,
                     state_dict: Optional[Mapping] = None
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``state_dict``: torchvision-named weights to use instead of the
    staged or synthetic ones (a test's bridged weights)."""
    if name not in ("resnet18", "resnet18_1ch", "resnet50"):
        raise ValueError(f"unknown feature extractor {name!r}")
    in_ch = 1 if name.endswith("_1ch") else channels
    dev = resolve_device(device)
    key = (name, in_ch, dev, flatten_input_hw)
    cached = name == "resnet50" and state_dict is None
    if cached and key in _TRUNKS:
        return _TRUNKS[key]
    arch = name.removesuffix("_1ch")
    model = ResNetFeatures(*STAGES[arch], in_channels=in_ch)
    staged = state_dict
    if staged is None and in_ch == 3:
        staged = try_load_pretrained(arch)
    if staged is not None:
        load_staged_weights(model, staged)
    else:
        load_synth_weights(model)
        why = (f"no staged {arch}.pt in $STRAINER_WEIGHTS_DIR or ./weights" if in_ch == 3
               else f"a {in_ch}-channel trunk never loads staged weights")
        warnings.warn(f"{why}: the feature trunk uses the synthetic weights of "
                      "models/synth_weights.py", stacklevel=2)
    model = model.eval().to(dev)

    @torch.no_grad()
    def f(x: torch.Tensor) -> torch.Tensor:
        if flatten_input_hw is not None and x.dim() == 2:
            h, w = flatten_input_hw  # NHWC rows, as the JAX package flattens them
            x = x.reshape(x.shape[0], h, w, in_ch).permute(0, 3, 1, 2)
        with f32_math():
            return model(x)

    if cached:
        _TRUNKS[key] = f
    return f
