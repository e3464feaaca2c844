"""torchvision's ResNet18 trunk without ``fc`` (7x7 stem, max-pool, four
stages of two BasicBlocks, global average pool -> 512 features) in
evaluation mode, in plain PyTorch over a dict of torchvision-named
weights; and the z-score strain of `#z_score.py:276-294` on its features
(per-column mean and Bessel-corrected std over all rows, max |z| a row,
kept where it is below the threshold).

``tf32`` runs the convolutions in TF32: the control, one precision below
the float32 (TF32 off) that the strain decisions are stated in.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _bn(x, w: Dict, pre: str):
    return F.batch_norm(x, w[pre + ".running_mean"], w[pre + ".running_var"],
                        w[pre + ".weight"], w[pre + ".bias"], False, 0.0, 1e-5)


def features(w: Dict, x: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) normalised images -> (N, 512) float32 features."""
    h = F.relu(_bn(F.conv2d(x, w["conv1.weight"], stride=2, padding=3), w, "bn1"))
    h = F.max_pool2d(h, 3, 2, 1)
    for stage in range(4):
        for i in range(2):
            p = f"layer{stage + 1}.{i}"
            stride = 2 if (stage > 0 and i == 0) else 1
            idn = h
            if p + ".downsample.0.weight" in w:
                idn = _bn(F.conv2d(h, w[p + ".downsample.0.weight"], stride=stride), w,
                          p + ".downsample.1")
            out = F.relu(_bn(F.conv2d(h, w[p + ".conv1.weight"], stride=stride, padding=1),
                             w, p + ".bn1"))
            out = _bn(F.conv2d(out, w[p + ".conv2.weight"], padding=1), w, p + ".bn2")
            h = F.relu(out + idn)
    return h.mean(dim=(2, 3)).float()


def normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW in [-1, 1] (ToTensor + Normalize(0.5, 0.5))."""
    return (u8.float() / 255.0 - 0.5).div(0.5).permute(0, 3, 1, 2).contiguous()


def all_features(w: Dict, images: torch.Tensor, batch: int = 1024,
                 tf32: bool = False) -> torch.Tensor:
    n = images.shape[0]
    out = torch.empty((n, 512), dtype=torch.float32, device=images.device)
    with torch.no_grad(), matmul_precision(tf32):
        for lo in range(0, n, batch):
            out[lo:lo + batch] = features(w, normalize(images[lo:lo + batch]))
    return out


def max_abs_z(feats: torch.Tensor) -> torch.Tensor:
    """max over columns of |f - mean| / std (Bessel), z = 0 where a column's
    std is 0; the statistics in float64."""
    f = feats.double()
    mean = f.mean(dim=0)
    std = f.std(dim=0, unbiased=True)
    z = (f - mean).abs() / torch.where(std == 0, torch.ones_like(std), std)
    z = torch.where(std[None, :] == 0, torch.zeros_like(z), z)
    return z.amax(dim=1).float()


def zscore_mask(feats: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kept mask, max-|z| scores): kept where max |z| < threshold."""
    z = max_abs_z(feats)
    return z < threshold, z
