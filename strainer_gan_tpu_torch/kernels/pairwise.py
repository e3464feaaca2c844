"""K3: weighted neighbour counts within eps (replaces
`strainer_gan_tpu/kernels/pairwise.py:25` ``neighbor_counts_pallas`` and the
two-pass :93 ``dbscan_non_noise_pallas``; CUDA source ``csrc/pairwise.cu``).

``counts[i] = sum_j w_j * [||x_i - x_j||^2 <= eps^2]`` (self included) for
valid rows; an invalid row counts nothing and is counted by nothing.  ``w``
defaults to ``valid``.  ``dbscan_non_noise`` is DBSCAN's noise test from two
passes: core = (counts >= min_samples) and valid, then non-noise = core or
within eps of a core point.

On the card, pass 1 takes the Gram matrix of the upper triangle of pairs
once, on the tensor cores in 3xTF32, and redecides the pairs within a
worst-case error band of eps^2 by the direct form (``band_tau_coef``); it
keeps its decisions as a packed bitmask, which pass 2 reads without any
product.  ``neighbor_counts.launches`` counts K3's passes launched on the
card: one for each neighbour-count pass, one for each near-core pass.
``last_band_pairs`` is the number of pairs the last pass 1 redecided.
Wrappers launch for CUDA tensors and take the plain versions only for CPU
tensors.  The plain version is a row-blocked PyTorch copy of the JAX
package's default, `ops/dbscan.py:77-117` ``_dbscan_non_noise_jnp`` (the
expansion ``a2 - 2ab + b2`` clamped at 0, never an N x N matrix); on the
card it runs under ``device.f32_math`` so no product is taken in TF32.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..device import f32_math
from . import _build
from .bce import check_tensor

PLAIN_BLOCK = 4096  # rows per step of the plain version (`ops/dbscan.py:82`)


def eps_squared(eps: float, dtype: torch.dtype = torch.float32) -> float:
    """eps^2 as the JAX package compares against it: ``float32(eps) ** 2``
    rounded to float32 (`ops/dbscan.py:89`); in float64 for float64 input."""
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


TILE = 128  # rows of a K3 tile pair, both ways (``csrc/pairwise.cu`` kTile)
FEATURE_STEP = 32  # K3 pads D to a multiple of this (kBK)
TILE_WORDS = TILE * TILE // 32  # packed adjacency words per tile pair
last_band_pairs = 0


def band_tau_coef(dp: int) -> float:
    """K3's band half-width per unit of sq_i + sq_j at padded depth ``dp``:
    a worst-case bound on the 3xTF32 error of d2 (derived in
    ``csrc/pairwise.cu``), valid for dp <= 4096."""
    if dp > 4096:
        raise ValueError(f"K3's error band is derived for D' <= 4096, got {dp}")
    return (dp / 8 + 16) * 2.0 ** -22


def _band_cap(n: int) -> int:
    return max(1 << 16, 16 * n)


def _counts_cuda(features: torch.Tensor, eps: float, valid: Optional[torch.Tensor],
                 w: torch.Tensor, want_adjacency: bool, sample_tiles: int = 0):
    """Pass 1 on the card: (counts int32, packed adjacency or None, d2 of
    the first ``sample_tiles`` tiles or None)."""
    global last_band_pairs
    lib = _build.load_library()
    if (lib.sg_pairwise_tile(), lib.sg_pairwise_feature_step()) != (TILE, FEATURE_STEP):
        raise RuntimeError("csrc/pairwise.cu's tile shape differs from kernels/pairwise.py's")
    n, d = features.shape
    dev = features.device
    dp = -(-d // FEATURE_STEP) * FEATURE_STEP
    t1 = -(-n // TILE)
    tiles = t1 * (t1 + 1) // 2
    split = torch.empty((2, n, dp), dtype=torch.float32, device=dev)  # X_hi, X_lo
    sq = torch.empty((n,), dtype=torch.float32, device=dev)
    adj = (torch.empty((tiles * TILE_WORDS,), dtype=torch.int32, device=dev)
           if want_adjacency else None)
    sample = (torch.empty((sample_tiles, TILE, TILE), dtype=torch.float32, device=dev)
              if sample_tiles else None)
    w8 = w.to(torch.uint8)
    cap = _band_cap(n)
    stream = torch.cuda.current_stream(dev).cuda_stream
    while True:
        buf = torch.zeros((n + 1,), dtype=torch.int32, device=dev)  # counts, band count
        band = torch.empty((cap, 2), dtype=torch.int32, device=dev)
        rc = lib.sg_pairwise_counts(
            dev.index or 0, features.data_ptr(), n, d, dp, split[0].data_ptr(),
            split[1].data_ptr(), sq.data_ptr(),
            None if valid is None else valid.data_ptr(),
            w8.data_ptr(), eps_squared(eps), band_tau_coef(dp), buf.data_ptr(),
            None if adj is None else adj.data_ptr(), band.data_ptr(), buf[n:].data_ptr(), cap,
            None if sample is None else sample.data_ptr(), sample_tiles, stream,
        )
        _build.check(rc, "neighbor_counts")
        neighbor_counts.launches += 1
        n_band = int(buf[n])  # one host read per pass 1
        if n_band <= cap:
            break
        warnings.warn(f"K3's band list overflowed ({n_band} pairs > {cap}); "
                      "running the pass again with room for all of them")
        cap = n_band
    last_band_pairs = n_band
    return buf[:n], adj, sample


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
    counts, _, _ = _counts_cuda(features, eps, valid, _weights(features, valid, col_weights),
                                want_adjacency=False)
    return counts.to(torch.float32)


neighbor_counts.launches = 0


def near_core(adjacency: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """K3's pass 2 on the card: (N,) bool, True where a core point lies
    within eps, read from pass 1's packed adjacency (no products)."""
    n = core.shape[0]
    t1 = -(-n // TILE)
    if adjacency.shape != (t1 * (t1 + 1) // 2 * TILE_WORDS,) or adjacency.dtype != torch.int32:
        raise ValueError("adjacency must be pass 1's packed int32 words for N rows")
    check_tensor(core, "core", 1, torch.bool)
    if core.device.type != "cuda" or adjacency.device != core.device:
        raise ValueError("near_core runs on the card, on pass 1's adjacency")
    lib = _build.load_library()
    near = torch.zeros((n,), dtype=torch.bool, device=core.device)
    rc = lib.sg_dbscan_near_core(core.device.index or 0, adjacency.data_ptr(), core.data_ptr(),
                                 n, near.data_ptr(),
                                 torch.cuda.current_stream(core.device).cuda_stream)
    _build.check(rc, "dbscan_near_core")
    neighbor_counts.launches += 1
    return near


def dbscan_non_noise_plain(features: torch.Tensor, eps: float, min_samples: int,
                           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the two-pass noise test (float32, or float64)."""
    if valid is None:
        valid = torch.ones((features.shape[0],), dtype=torch.bool, device=features.device)
    counts = neighbor_counts_plain(features, eps, valid)
    core = torch.logical_and(counts >= min_samples, valid)
    near = neighbor_counts_plain(features, eps, valid, col_weights=core)
    return torch.logical_and(torch.logical_or(core, near > 0), valid)


def dbscan_non_noise(features: torch.Tensor, eps: float, min_samples: int,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) bool: True where DBSCAN(eps, min_samples) labels the point != -1.
    For CUDA tensors: pass 1 (counts and the adjacency bitmask), then pass 2
    from the bitmask; two K3 launches."""
    check_tensor(features, "features", 2)
    _check_mask(valid, "valid", features)
    if features.device.type == "cpu":
        return dbscan_non_noise_plain(features, eps, min_samples, valid)
    if valid is None:
        valid = torch.ones((features.shape[0],), dtype=torch.bool, device=features.device)
    counts, adj, _ = _counts_cuda(features, eps, valid, valid, want_adjacency=True)
    core = torch.logical_and(counts >= min_samples, valid)
    return torch.logical_and(torch.logical_or(core, near_core(adj, core)), valid)
