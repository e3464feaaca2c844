"""FID (counterpart of `strainer_gan_tpu/eval/fid.py:28-113`).

The reference's pipeline (`#strainer gan.py:396-468`, `# 1,2,8.py:173-223`):
a 299x299 bilinear resize (align_corners=False), grayscale repeated to
three channels, InceptionV3 pool-2048 activations (optionally
L2-normalised, the `# 1,2,8.py:205` variant), their mean and covariance,
and the Frechet distance with 1e-6 I added to both covariances
(`#strainer gan.py:459-461`).  Images are NCHW float in [-1, 1] (or MLP
rows already reshaped to images by the caller).  The activations and the
distance run in float32 with TF32 off (``device.f32_math``).  Each
``calculate_fid`` appends to ``calls`` the host seconds of its two
activation passes and of its distance (each synchronised on the card) and
the square root's branch (``ops.sqrtm.last_branch``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from ..device import f32_math
from ..models.inception import build_inception, resize_bilinear_299
from ..ops import sqrtm

_INCEPTION: Dict[torch.device, torch.nn.Module] = {}
calls: List[Dict] = []


def inception_fn(device: torch.device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The eval-mode InceptionV3 trunk on ``device``, built once."""
    if device not in _INCEPTION:
        _INCEPTION[device] = build_inception(device)
    return _INCEPTION[device]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batched_feature_pass(images: torch.Tensor, feature_fn: Callable, batch_size: int,
                         normalize: bool = False, resize_299: bool = False,
                         keep_all: bool = False) -> torch.Tensor:
    """``feature_fn`` over ``images`` in batches of ``batch_size``: full
    batches only, N // batch_size * batch_size images (the reference's FID
    truncation, `#strainer gan.py:398-400`), unless ``keep_all``, which
    pads the tail batch with copies of the last image and drops their rows."""
    n = images.shape[0]
    full = n // batch_size * batch_size
    acts = []
    with torch.no_grad(), f32_math():
        for lo in range(0, full if not keep_all else n, batch_size):
            batch = images[lo:lo + batch_size]
            rows = batch.shape[0]
            if rows < batch_size:
                batch = torch.cat([batch, batch[-1:].expand((batch_size - rows,)
                                                            + batch.shape[1:])])
            if resize_299:
                batch = resize_bilinear_299(batch)
            act = feature_fn(batch)
            if normalize:  # the L2-normalised variant (`# 1,2,8.py:205`)
                act = act / torch.linalg.vector_norm(act, dim=1, keepdim=True)
            acts.append(act[:rows])
    return torch.cat(acts)


def get_activations(images: torch.Tensor, feature_fn: Optional[Callable] = None,
                    batch_size: int = 50, normalize: bool = False) -> torch.Tensor:
    """(N, C, H, W) float in [-1, 1] -> (N // batch_size * batch_size, 2048)."""
    if feature_fn is None:
        feature_fn = inception_fn(images.device)
    if images.shape[1] == 1:  # grayscale -> 3 channels (`# 1,2,8.py:200`)
        images = images.repeat(1, 3, 1, 1)
    return batched_feature_pass(images, feature_fn, batch_size, normalize, resize_299=True)


def fid_from_activations(act1: torch.Tensor, act2: torch.Tensor,
                         eps_reg: float = 1e-6) -> torch.Tensor:
    """Means, covariances (+ eps_reg I) and the Frechet distance."""
    with f32_math():
        eye = torch.eye(act1.shape[1], dtype=act1.dtype, device=act1.device)
        c1 = torch.cov(act1.T) + eye * eps_reg
        c2 = torch.cov(act2.T) + eye * eps_reg
        return sqrtm.frechet_distance(act1.mean(0), c1, act2.mean(0), c2)


def calculate_fid(real_images: torch.Tensor, fake_images: torch.Tensor,
                  feature_fn: Optional[Callable] = None, batch_size: int = 50,
                  normalize: bool = False) -> float:
    dev = real_images.device
    t0 = time.perf_counter()
    a1 = get_activations(real_images, feature_fn, batch_size, normalize)
    a2 = get_activations(fake_images, feature_fn, batch_size, normalize)
    _sync(dev)
    t1 = time.perf_counter()
    fid = float(fid_from_activations(a1, a2))
    calls.append(dict(activations_s=t1 - t0, distance_s=time.perf_counter() - t1,
                      branch=sqrtm.last_branch, n=a1.shape[0], fid=fid))
    return fid
