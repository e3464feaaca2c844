"""K1: per-sample BCE scores (replaces `strainer_gan_tpu/kernels/bce.py:22`
``bce_scores_pallas``; CUDA source ``csrc/bce.cu``).

``bce_scores`` launches the kernel for a CUDA tensor and takes the plain
version, ``ops.losses.bce_from_logits``, only for a CPU tensor.
``bce_scores.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from ..ops.losses import bce_from_logits
from . import _build


def check_tensor(t: torch.Tensor, name: str, ndim: int,
                 dtype: torch.dtype = torch.float32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on unsupported device {t.device}")


def bce_scores_plain(logits: torch.Tensor, target: float) -> torch.Tensor:
    return bce_from_logits(logits, target)


def bce_scores(logits: torch.Tensor, target: float) -> torch.Tensor:
    """(N,) float32 logits -> (N,) float32 BCE(sigmoid(logits), target)."""
    check_tensor(logits, "logits", 1)
    if logits.device.type == "cpu":
        return bce_scores_plain(logits, target)
    lib = _build.load_library()
    out = torch.empty_like(logits)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = lib.sg_bce_scores(logits.device.index or 0, logits.data_ptr(), out.data_ptr(),
                           logits.numel(), float(target), stream)
    _build.check(rc, "bce_scores")
    bce_scores.launches += 1
    return out


bce_scores.launches = 0
