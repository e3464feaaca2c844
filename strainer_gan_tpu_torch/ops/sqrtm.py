"""Matrix square-root pieces of the Frechet (FID) distance (counterpart of
`strainer_gan_tpu/ops/sqrtm.py:24-122`).

The reference takes ``trace(scipy.linalg.sqrtm(sigma1 @ sigma2))``
(`#strainer gan.py:424-445`).  ``sigma1 @ sigma2`` is similar to the
symmetric PSD ``S = L2^T sigma1 L2`` (``L2`` the Cholesky factor of
sigma2), so the traces of their square roots agree.  Two paths:

* ``trace_sqrtm_product_ns``: the Cholesky similarity, 24 power steps for
  S's spectral norm, then 48 coupled Newton-Schulz steps, all matrix
  products (cuBLAS on the card);
* ``trace_sqrtm_product``: two symmetric eigendecompositions, the
  exactness reference.

``frechet_distance`` takes the Newton-Schulz path and falls back to eigh
when its trace is not finite (a rank-deficient covariance, fewer samples
than dimensions, can overflow the Z iterate), as the JAX package's
``lax.cond`` does; here the test of ``isfinite`` is one host read.
``last_branch`` records which path gave the last distance.  Every
function runs in float32 with TF32 off (``device.f32_math``): TF32's ten
mantissa bits would wreck the Newton-Schulz iterate.
"""
from __future__ import annotations

import torch

from ..device import f32_math

NS_POWER_STEPS = 24
NS_ITERS = 48
last_branch = None  # "ns" or "eigh": the path of the last frechet_distance


def psd_sqrt(a: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root by eigendecomposition."""
    with f32_math():
        a = (a + a.T) / 2.0
        w, v = torch.linalg.eigh(a)
        return (v * torch.sqrt(torch.clamp_min(w, 0.0))[None, :]) @ v.T


def trace_sqrtm_product(sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """trace(sqrtm(sigma1 @ sigma2)) for PSD sigma1, sigma2 (eigh path)."""
    with f32_math():
        s1h = psd_sqrt(sigma1)
        inner = s1h @ sigma2 @ s1h
        inner = (inner + inner.T) / 2.0
        w = torch.linalg.eigvalsh(inner)
        return torch.sqrt(torch.clamp_min(w, 0.0)).sum()


def trace_sqrtm_product_ns(sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """trace(sqrtm(sigma1 @ sigma2)) by Cholesky similarity and the coupled
    Newton-Schulz iteration on A = S / c, c 1.05 times S's spectral norm
    from ``NS_POWER_STEPS`` power steps: Y0 = A, Z0 = I, T = (3I - ZY) / 2,
    Y <- YT, Z <- TZ; Y -> A^(1/2).  NaN when sigma2 has no Cholesky
    factor in float32 (where jnp.linalg.cholesky gives NaNs)."""
    with f32_math():
        l2, info = torch.linalg.cholesky_ex(sigma2)
        s = l2.T @ sigma1 @ l2
        s = (s + s.T) / 2.0
        d = s.shape[0]
        v = torch.full((d,), 1.0 / float(d) ** 0.5, dtype=s.dtype, device=s.device)
        for _ in range(NS_POWER_STEPS):
            w = s @ v
            v = w / torch.linalg.vector_norm(w)
        c = torch.linalg.vector_norm(s @ v) * 1.05
        y = s / c
        eye = torch.eye(d, dtype=s.dtype, device=s.device)
        z = eye
        for _ in range(NS_ITERS):
            t = 0.5 * (3.0 * eye - z @ y)
            y, z = y @ t, t @ z
        tr = torch.sqrt(c) * torch.trace(y)
        return torch.where(info == 0, tr, torch.full_like(tr, float("nan")))


def frechet_distance(mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor,
                     sigma2: torch.Tensor, method: str = "ns") -> torch.Tensor:
    """||mu1 - mu2||^2 + tr(sigma1) + tr(sigma2) - 2 tr(sqrtm(sigma1 sigma2))
    (`#strainer gan.py:424-445`); ``method`` "ns" (with the eigh fallback)
    or "eigh"."""
    global last_branch
    with f32_math():
        diff = mu1 - mu2
        tr = None
        if method == "ns":
            tr = trace_sqrtm_product_ns(sigma1, sigma2)
            last_branch = "ns"
            if not bool(torch.isfinite(tr)):
                tr = None
        elif method != "eigh":
            raise ValueError(f"unknown method {method!r}")
        if tr is None:
            tr = trace_sqrtm_product(sigma1, sigma2)
            last_branch = "eigh"
        return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * tr
