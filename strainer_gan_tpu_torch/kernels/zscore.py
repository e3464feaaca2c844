"""K2: masked z-score statistic (replaces `strainer_gan_tpu/kernels/zscore.py`
``column_stats`` at :30 (K2a) and ``max_abs_zscores_pallas`` at :78 (K2b);
CUDA source ``csrc/zscore.cu``).

Held to `strainer_gan_tpu/strain/thresholds.py:25-48` ``_masked_max_abs_z``
(a ``valid`` row mask, a two-pass centred variance, z = 0 on zero-std
columns), not to the Pallas template, which has none of the three.  Each
wrapper launches its kernel for CUDA tensors and takes its plain version
only for CPU tensors; ``.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _build
from .bce import check_tensor


def _std_mode(std_mode: str) -> Tuple[bool, float]:
    if std_mode == "torch":  # Bessel (`#z_score.py:288`)
        return True, 0.0
    if std_mode == "numpy_eps":  # population + 1e-7 (`# 1,2,8.py:166`)
        return False, 1e-7
    if std_mode == "population":  # StandardScaler (`ops/dbscan.py:25-36`)
        return False, 0.0
    raise ValueError(f"unknown std_mode {std_mode!r}")


def _check_valid(valid: Optional[torch.Tensor], features: torch.Tensor) -> None:
    if valid is None:
        return
    check_tensor(valid, "valid", 1, torch.bool)
    if valid.shape[0] != features.shape[0] or valid.device != features.device:
        raise ValueError("valid must be (N,) bool on the features' device")


def column_stats_plain(features: torch.Tensor, valid: Optional[torch.Tensor] = None,
                       std_mode: str = "torch") -> Tuple[torch.Tensor, torch.Tensor]:
    bessel, eps = _std_mode(std_mode)
    if valid is None:
        w = torch.ones((features.shape[0], 1), dtype=torch.float32, device=features.device)
    else:
        w = valid.to(torch.float32)[:, None]
    n = torch.clamp_min(w.sum(), 1.0)
    mean = (features * w).sum(dim=0) / n
    sq = (w * (features - mean) ** 2).sum(dim=0)
    var = sq / torch.clamp_min(n - 1.0, 1.0) if bessel else sq / n
    return mean, torch.sqrt(var) + eps


def row_max_abs_z_plain(features: torch.Tensor, mean: torch.Tensor,
                        std: torch.Tensor) -> torch.Tensor:
    z = torch.abs(features - mean) / torch.where(std == 0, 1.0, std)
    z = torch.where(std[None, :] == 0, 0.0, z)
    return torch.amax(z, dim=1)


@functools.lru_cache(maxsize=64)
def _stats_chunks(device: int, n: int, d: int) -> int:
    """Row chunks of K2a's column pass (about two waves of its blocks)."""
    return _build.load_library().sg_zscore_stats_chunks(device, n, d)


def column_stats(features: torch.Tensor, valid: Optional[torch.Tensor] = None,
                 std_mode: str = "torch") -> Tuple[torch.Tensor, torch.Tensor]:
    """K2a: (N, D) float32 [+ (N,) bool valid] -> (mean (D,), std (D,))."""
    check_tensor(features, "features", 2)
    _check_valid(valid, features)
    bessel, eps = _std_mode(std_mode)
    if features.device.type == "cpu":
        return column_stats_plain(features, valid, std_mode)
    lib = _build.load_library()
    n, d = features.shape
    dev = features.device
    chunks = _stats_chunks(dev.index or 0, n, d)
    # scratch: (chunks, d) partial means, then M2s, then (chunks,) int32 counts
    scratch = torch.empty((2 * chunks * d + chunks,), dtype=torch.float32, device=dev)
    out = torch.empty((2, d), dtype=torch.float32, device=dev)
    mean, std = out[0], out[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = scratch.data_ptr()
    rc = lib.sg_zscore_column_stats(
        dev.index or 0, features.data_ptr(),
        None if valid is None else valid.data_ptr(), n, d, int(bessel), eps, chunks,
        p, p + 4 * chunks * d, p + 8 * chunks * d, mean.data_ptr(), std.data_ptr(), stream,
    )
    _build.check(rc, "zscore_column_stats")
    column_stats.launches += 1
    return mean, std


def row_max_abs_z(features: torch.Tensor, mean: torch.Tensor,
                  std: torch.Tensor) -> torch.Tensor:
    """K2b: (N, D) features, (D,) mean/std -> (N,) max_d |z|."""
    check_tensor(features, "features", 2)
    for t, name in ((mean, "mean"), (std, "std")):
        check_tensor(t, name, 1)
        if t.shape[0] != features.shape[1] or t.device != features.device:
            raise ValueError(f"{name} must be (D,) on the features' device")
    if features.device.type == "cpu":
        return row_max_abs_z_plain(features, mean, std)
    lib = _build.load_library()
    n, d = features.shape
    out = torch.empty((n,), dtype=torch.float32, device=features.device)
    stream = torch.cuda.current_stream(features.device).cuda_stream
    rc = lib.sg_zscore_row_max(features.device.index or 0, features.data_ptr(),
                               mean.data_ptr(), std.data_ptr(), n, d, out.data_ptr(),
                               stream)
    _build.check(rc, "zscore_row_max")
    row_max_abs_z.launches += 1
    return out


column_stats.launches = 0
row_max_abs_z.launches = 0


def masked_max_abs_z(features: torch.Tensor, valid: Optional[torch.Tensor] = None,
                     std_mode: str = "torch") -> torch.Tensor:
    """max-|z| per row with statistics over the valid rows (K2a then K2b)."""
    mean, std = column_stats(features, valid, std_mode)
    return row_max_abs_z(features, mean, std)
