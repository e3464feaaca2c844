"""ResNet feature trunks (counterpart of `strainer_gan_tpu/models/resnet.py`).

torchvision's resnet18 and resnet50 with ``fc`` removed: 7x7 stem,
max-pool, four stages, global average pool.  ResNet18 (two BasicBlocks a
stage, -> (N, 512)) is the z-score strainer's trunk (`#z_score.py:270-274`);
ResNet50 (3-4-6-3 Bottlenecks, -> (N, 2048)) the eval suite's
(`#strainer gan.py:474-486`, `resnet.py:74-94, 104-130`), its 3x3
convolution carrying the stride as in torchvision v1.5.  Parameter names
are torchvision's, so a torchvision ``state_dict`` or the synthetic one of
``models/synth_weights.py`` loads as it is.  The trunks are eval-only.

``load_staged_weights`` copies a staged torchvision ``state_dict`` into a
trunk entry by entry along ``bridge.resnet_name_map`` (the classifier
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
    expansion = 1

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


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, 1, 0, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, 1, 0, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout)
            )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}
STAGES = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet50": ("bottleneck", (3, 4, 6, 3))}


class ResNetFeatures(nn.Module):
    """(N, C, H, W) normalised images -> (N, 512 * expansion) float32
    features; ``block`` "basic" or "bottleneck", ``stages`` the blocks a
    stage."""

    def __init__(self, block: str = "basic", stages=(2, 2, 2, 2), in_channels: int = 3):
        super().__init__()
        self.block, self.stages = block, tuple(stages)
        blk = BLOCKS[block]
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for i, (w, n) in enumerate(zip((64, 128, 256, 512), self.stages)):
            stride = 1 if i == 0 else 2
            blocks = [blk(cin, w, stride)] + [blk(w * blk.expansion, w) for _ in range(n - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            cin = w * blk.expansion

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return x.mean(dim=(2, 3)).to(torch.float32)


class ResNet18Features(ResNetFeatures):
    """The z-score strainer's trunk: (N, C, H, W) -> (N, 512)."""

    def __init__(self, in_channels: int = 3):
        super().__init__("basic", (2, 2, 2, 2), in_channels)


def load_staged_weights(model: ResNetFeatures, state_dict: Mapping) -> ResNetFeatures:
    """Copy the trunk's convolutions and BatchNorms from a torchvision-named
    ``state_dict`` (tensors or arrays) into ``model``."""
    from ..bridge import resnet_name_map

    own = model.state_dict()
    with torch.no_grad():
        for _, conv, bn in resnet_name_map(model.block, model.stages):
            names = [conv + ".weight"] + [f"{bn}.{k}" for k in
                                          ("weight", "bias", "running_mean", "running_var")]
            for name in names:
                value = np.asarray(state_dict[name], np.float32)
                own[name].copy_(torch.from_numpy(value).reshape(own[name].shape))
    return model
