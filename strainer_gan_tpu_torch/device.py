"""Device choice and float32 numerics for the port.

``resolve_device`` is the one place that turns a caller's ``device``
argument into a ``torch.device``: ``None`` means the card, and asking for
the card where there is none raises instead of carrying on on the CPU.

``f32_math`` turns TF32 off for the passes whose results are strain
DECISIONS (the scoring and feature passes): cuDNN runs float32 convolutions
in TF32 by default, which keeps about three decimal digits and would move
per-sample scores across thresholds.  The JAX reference scores in float32
(`strainer_gan_tpu/strain/score.py:94-98`).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def f32_math():
    """Full-float32 convolutions and matmuls inside the block."""
    cudnn_prev = torch.backends.cudnn.allow_tf32
    matmul_prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_prev
        torch.backends.cuda.matmul.allow_tf32 = matmul_prev
