"""K1: per-sample BCE scores (replaces `strainer_gan_tpu/kernels/bce.py:22`
``bce_scores_pallas``; CUDA source ``csrc/bce.cu``).

``bce_scores`` launches the kernel for a CUDA tensor and takes the plain
version, ``ops.losses.bce_from_logits``, only for a CPU tensor.
``bce_scores.launches`` counts kernel launches.  The launch is one
``ctypes`` call on PyTorch's current stream that allocates nothing when
``out`` is given and never synchronises, so it can be captured in a CUDA
graph.
"""
from __future__ import annotations

import functools
from typing import Optional

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


@functools.cache
def _launcher():
    """``sg_bce_scores`` of the kernel library, resolved once."""
    return _build.load_library().sg_bce_scores


def _check_vector(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be 1-D and contiguous, got shape {tuple(t.shape)}")


def bce_scores(logits: torch.Tensor, target: float,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) float32 logits -> (N,) float32 BCE(sigmoid(logits), target),
    written into ``out`` (which may be ``logits`` itself) when given.

    It checks only what the kernel needs: at the path's N the host's cost
    per call is most of the kernel's cost."""
    _check_vector(logits, "logits")
    if out is not None and out is not logits:
        _check_vector(out, "out")
        if out.shape != logits.shape or out.get_device() != logits.get_device():
            raise ValueError("out must have the logits' shape and device")
    if not logits.is_cuda:
        scores = bce_scores_plain(logits, target)
        return scores if out is None else out.copy_(scores)
    if out is None:
        out = torch.empty_like(logits)
    device = logits.get_device()
    rc = _launcher()(device, logits.data_ptr(), out.data_ptr(), logits.numel(),
                     float(target), _build.current_stream(device))
    _build.check(rc, "bce_scores")
    bce_scores.launches += 1
    return out


bce_scores.launches = 0
