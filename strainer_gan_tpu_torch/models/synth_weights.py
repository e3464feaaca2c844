"""Deterministic synthetic torchvision-named weights (counterpart of
`strainer_gan_tpu/models/synth_weights.py:26-76`).

The reference runs its feature strainer on pretrained torchvision weights
(`#z_score.py:270-274`), which cannot be downloaded here.  Each value is a
pure function of the parameter's torchvision name (crc32-seeded numpy), so
both packages build the same backbone with no file at all.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn


def synth_value(name: str, shape) -> np.ndarray:
    """Deterministic value for torchvision parameter ``name`` of ``shape``."""
    rng = np.random.default_rng(zlib.crc32(name.encode()) & 0xFFFFFFFF)
    shape = tuple(int(s) for s in shape)
    if name.endswith("running_var"):
        v = rng.uniform(0.5, 1.5, shape)
    elif name.endswith("running_mean"):
        v = rng.normal(0.0, 0.1, shape)
    elif name.endswith(".bias"):
        v = rng.normal(0.0, 0.05, shape)
    elif len(shape) == 1:  # BN weight (scale)
        v = rng.normal(1.0, 0.1, shape)
    else:  # conv kernel (out, in, kh, kw): He in fan_in
        fan_in = int(np.prod(shape[1:]))
        v = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
    return np.asarray(v, np.float32)


def load_synth_weights(module: nn.Module) -> nn.Module:
    """Fill every parameter and BN statistic of a torchvision-named module
    with its synthetic value (``num_batches_tracked`` is left alone)."""
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            t.copy_(torch.from_numpy(synth_value(name, t.shape)))
    return module
