"""K3: weighted neighbour counts within eps (replaces
`strainer_gan_tpu/kernels/pairwise.py:25` ``neighbor_counts_pallas`` and the
two-pass :93 ``dbscan_non_noise_pallas``; CUDA source ``csrc/pairwise.cu``).

``counts[i] = sum_j w_j * [||x_i - x_j||^2 <= eps^2]`` (self included) for
valid rows; an invalid row counts nothing and is counted by nothing.  ``w``
defaults to ``valid``.  ``dbscan_non_noise`` is DBSCAN's noise test from two
passes: core = (counts >= min_samples) and valid, then non-noise = core or
within eps of a core point.

``neighbor_counts`` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor; ``neighbor_counts.launches`` counts
kernel launches.  The plain version is a row-blocked PyTorch copy of the
JAX package's default, `ops/dbscan.py:215-256` ``_dbscan_non_noise_jnp``
(the expansion ``a2 - 2ab + b2`` clamped at 0, never an N x N matrix); on
the card it runs under ``device.f32_math`` so no product is taken in TF32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import f32_math
from . import _build
from .bce import check_tensor

PLAIN_BLOCK = 4096  # rows per step of the plain version (`ops/dbscan.py:191`)


def eps_squared(eps: float, dtype: torch.dtype = torch.float32) -> float:
    """eps^2 as the JAX package compares against it: ``float32(eps) ** 2``
    rounded to float32 (`ops/dbscan.py:227`); in float64 for float64 input."""
    if dtype == torch.float64:
        return float(eps) ** 2
    e = np.float32(eps)
    return float(np.float32(e * e))


def _check_mask(t: Optional[torch.Tensor], name: str, features: torch.Tensor) -> None:
    if t is None:
        return
    check_tensor(t, name, 1, torch.bool)
    if t.shape[0] != features.shape[0] or t.device != features.device:
        raise ValueError(f"{name} must be (N,) bool on the features' device")


def _weights(features: torch.Tensor, valid: Optional[torch.Tensor],
             col_weights: Optional[torch.Tensor]) -> torch.Tensor:
    n = features.shape[0]
    w = torch.ones((n,), dtype=torch.bool, device=features.device) if valid is None else valid
    return w if col_weights is None else torch.logical_and(w, col_weights)


def neighbor_counts_plain(features: torch.Tensor, eps: float,
                          valid: Optional[torch.Tensor] = None,
                          col_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K3, in the features' dtype (float32, or float64 for
    a reference): (N,) float32 counts."""
    n = features.shape[0]
    x = features
    eps2 = eps_squared(eps, x.dtype)
    w = _weights(features, valid, col_weights).to(x.dtype)
    x2 = torch.sum(x * x, dim=1)
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    with f32_math():
        for lo in range(0, n, PLAIN_BLOCK):
            hi = lo + PLAIN_BLOCK
            d2 = torch.clamp_min(x2[lo:hi, None] - 2.0 * (x[lo:hi] @ x.T) + x2[None, :], 0.0)
            out[lo:hi] = ((d2 <= eps2).to(x.dtype) @ w).to(torch.float32)
    if valid is not None:
        out = torch.where(valid, out, torch.zeros_like(out))
    return out


def neighbor_counts(features: torch.Tensor, eps: float,
                    valid: Optional[torch.Tensor] = None,
                    col_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: (N, D) float32 features [+ (N,) bool valid, (N,) bool weights]
    -> (N,) float32 counts."""
    check_tensor(features, "features", 2)
    _check_mask(valid, "valid", features)
    _check_mask(col_weights, "col_weights", features)
    if features.device.type == "cpu":
        return neighbor_counts_plain(features, eps, valid, col_weights)
    lib = _build.load_library()
    n, d = features.shape
    step = lib.sg_pairwise_feature_step()
    x = features
    if d % step or x.data_ptr() % 16:  # zero features change no distance
        x = torch.nn.functional.pad(features, (0, -d % step))
    w = _weights(features, valid, col_weights).to(torch.uint8)
    counts = torch.zeros((n,), dtype=torch.int32, device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    rc = lib.sg_neighbor_counts(
        features.device.index or 0, x.data_ptr(),
        None if valid is None else valid.data_ptr(), w.data_ptr(), n, x.shape[1],
        eps_squared(eps), counts.data_ptr(), stream,
    )
    _build.check(rc, "neighbor_counts")
    neighbor_counts.launches += 1
    return counts.to(torch.float32)


neighbor_counts.launches = 0


def _non_noise(count_fn, features: torch.Tensor, eps: float, min_samples: int,
               valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        valid = torch.ones((features.shape[0],), dtype=torch.bool, device=features.device)
    counts = count_fn(features, eps, valid)
    core = torch.logical_and(counts >= min_samples, valid)
    near_core = count_fn(features, eps, valid, col_weights=core)
    return torch.logical_and(torch.logical_or(core, near_core > 0), valid)


def dbscan_non_noise_plain(features: torch.Tensor, eps: float, min_samples: int,
                           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the two-pass noise test (float32, or float64)."""
    return _non_noise(neighbor_counts_plain, features, eps, min_samples, valid)


def dbscan_non_noise(features: torch.Tensor, eps: float, min_samples: int,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) bool: True where DBSCAN(eps, min_samples) labels the point != -1
    (two K3 launches for CUDA tensors)."""
    return _non_noise(neighbor_counts, features, eps, min_samples, valid)
