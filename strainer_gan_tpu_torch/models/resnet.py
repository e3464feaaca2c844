"""ResNet18 feature trunk (counterpart of `strainer_gan_tpu/models/resnet.py`).

torchvision's resnet18 with ``fc`` removed, as the z-score strainer uses
it (`#z_score.py:270-274`): 7x7 stem, max-pool, four stages of two
BasicBlocks, global average pool -> (N, 512).  Parameter names are
torchvision's, so a torchvision ``state_dict`` or the synthetic one of
``models/synth_weights.py`` loads as it is.  The trunk is eval-only.

``load_staged_weights`` copies a staged torchvision ``state_dict`` into the
trunk entry by entry along ``bridge.resnet18_name_map`` (the classifier
``fc`` and the BN batch counters are not read), as
`strainer_gan_tpu/models/resnet.py:160-200` loads it into the flax trunk.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout)
            )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class ResNet18Features(nn.Module):
    """(N, C, H, W) normalised images -> (N, 512) float32 features."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        widths = (64, 128, 256, 512)
        cin = 64
        for i, w in enumerate(widths):
            stride = 1 if i == 0 else 2
            setattr(self, f"layer{i + 1}",
                    nn.Sequential(BasicBlock(cin, w, stride), BasicBlock(w, w)))
            cin = w

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return x.mean(dim=(2, 3)).to(torch.float32)


def load_staged_weights(model: ResNet18Features, state_dict: Mapping) -> ResNet18Features:
    """Copy the trunk's convolutions and BatchNorms from a torchvision-named
    ``state_dict`` (tensors or arrays) into ``model``."""
    from ..bridge import resnet18_name_map

    own = model.state_dict()
    with torch.no_grad():
        for _, conv, bn in resnet18_name_map():
            names = [conv + ".weight"] + [f"{bn}.{k}" for k in
                                          ("weight", "bias", "running_mean", "running_var")]
            for name in names:
                value = np.asarray(state_dict[name], np.float32)
                own[name].copy_(torch.from_numpy(value).reshape(own[name].shape))
    return model
