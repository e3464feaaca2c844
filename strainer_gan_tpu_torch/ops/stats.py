"""Statistical primitives of the z-score strainers (counterpart of
`strainer_gan_tpu/ops/stats.py`).

Each function repeats the float32 arithmetic that the JAX function
compiles to, not the nearest torch built-in: the strain masks compare
scores against these thresholds with ``<`` or ``<=``, so one ulp in a
threshold moves a sample.  ``torch.quantile``, for one, interpolates with
a lerp whose rounding differs from ``jnp.quantile``'s weighted sum.

Two of the JAX functions run inside a jit (``jnp.quantile`` and
``jnp.linspace``), where XLA rewrites their arithmetic: it contracts a
multiply and an add into one fused multiply-add (one rounding), turns a
division by a constant into a multiplication by its float32 reciprocal,
and folds products of constants.  ``fma_f32`` gives the fused
multiply-add's single rounding on any device, so the port reproduces
those values bit for bit (tests/test_torch_dbscan.py holds it to the JAX
package).  The JAX functions that run op by op (``masked_percentile``,
the rest of ``histogram_density``) are repeated op by op.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


def _f32(q: Scalar, device: torch.device) -> torch.Tensor:
    """``q`` as a 0-d float32 tensor on ``device``; a Python number by a fill
    there, not a copy from the host, so the in-step quantile stays capturable
    in a CUDA graph."""
    if isinstance(q, torch.Tensor):
        return q.to(dtype=torch.float32, device=device)
    return torch.full((), q, dtype=torch.float32, device=device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` of float32 tensors with one rounding, as a fused
    multiply-add gives it.  The product of two float32 values is exact in
    float64; the sum is taken in float64 and rounded to odd (TwoSum gives
    its error), and float64 rounded to odd then rounded to float32 is the
    correctly rounded float32 result (53 >= 24 + 2 bits)."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def quantile(x: torch.Tensor, q: Scalar) -> torch.Tensor:
    """``jnp.quantile(x, q, method="linear")`` of a 1-D float32 tensor
    (`ops/stats.py:58`; `# z_score + DBSCAN.py:324`): in float32,
    ``pos = q*(n-1)``, ``lo = floor(pos)``, ``hi = ceil(pos)``,
    ``w = pos - lo`` and ``x_lo*(1-w) + x_hi*w``, the last sum fused by
    XLA into ``fma(x_hi, w, x_lo*(1-w))``.  A NaN in ``x`` gives NaN, as in
    JAX."""
    dev = x.device
    xs = torch.sort(x).values
    n = _f32(x.shape[0], dev)
    pos = _f32(q, dev) * (n - 1.0)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    lo = torch.clamp(lo, torch.zeros_like(n), n - 1.0).to(torch.int64)
    hi = torch.clamp(hi, torch.zeros_like(n), n - 1.0).to(torch.int64)
    # take(), not xs[t]: indexing by a 0-d tensor reads it back to the host
    out = fma_f32(torch.take(xs, hi), w_hi, torch.take(xs, lo) * w_lo)
    return torch.where(torch.isnan(x).any(), torch.full_like(out, float("nan")), out)


def percentile(x: torch.Tensor, q: Scalar) -> torch.Tensor:
    """``jnp.percentile(x, q, method="linear")`` (`ops/stats.py:52`,
    `# final.py:361`): the quantile at ``q / 100`` (exact for the 25 and 75
    the strainers ask for)."""
    return quantile(x, q / 100.0)


def interpolate_sorted(xs: torch.Tensor, n_valid: torch.Tensor,
                       q_percent: torch.Tensor) -> torch.Tensor:
    """The percentile of the ``n_valid`` smallest entries of the sorted
    ``xs`` (the rest sorted to the end), as `ops/stats.py:80-97`
    interpolates it: ``pos = q/100 * max(n_valid-1, 0)`` in float32 and
    ``x_lo + (x_hi - x_lo) * frac``."""
    n = xs.shape[0]
    pos = q_percent / 100.0 * torch.clamp_min(n_valid - 1, 0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo
    x_lo = torch.take(xs, torch.clamp(lo, 0, n - 1))
    x_hi = torch.take(xs, torch.clamp(hi, 0, n - 1))
    return x_lo + (x_hi - x_lo) * frac


def masked_percentile(x: torch.Tensor, valid: torch.Tensor, q: Scalar) -> torch.Tensor:
    """``np.percentile(x[valid], q)`` with static shapes (`ops/stats.py:80`):
    invalid lanes sort last at +float32 max."""
    # a fill, not a copy from the host: the gated tail captures this
    big = torch.full((), torch.finfo(x.dtype).max, dtype=x.dtype, device=x.device)
    xs = torch.sort(torch.where(valid, x, big)).values
    return interpolate_sorted(xs, valid.sum(), _f32(q, x.device))


def masked_quantile(x: torch.Tensor, valid: torch.Tensor, q: Scalar) -> torch.Tensor:
    """``torch.quantile(x[valid], q)`` as the JAX package computes it
    (`ops/stats.py:95`): the percentile at ``q * 100``, in float32 where
    ``q`` is a tensor."""
    return masked_percentile(x, valid, q * 100.0)


def iqr_threshold(x: torch.Tensor, valid=None) -> torch.Tensor:
    """Q3 + 1.5 * IQR outlier fence (`ops/stats.py:99`, `# 종합 loss.py:290-294`),
    over the ``valid`` entries when given."""
    if valid is None:
        q1, q3 = percentile(x, 25.0), percentile(x, 75.0)
    else:
        q1, q3 = masked_percentile(x, valid, 25.0), masked_percentile(x, valid, 75.0)
    return q3 + 1.5 * (q3 - q1)


def masked_mean_std(x: torch.Tensor, valid: torch.Tensor, bessel: bool = True):
    """Mean and std over the ``valid`` entries (`ops/stats.py:159`);
    ``bessel=True`` divides by n - 1, as ``torch.std`` does
    (`#autoencoder.py:318`)."""
    w = valid.to(x.dtype)
    n = w.sum()
    mean = (x * w).sum() / torch.clamp_min(n, 1.0)
    denom = torch.clamp_min(n - 1.0, 1.0) if bessel else torch.clamp_min(n, 1.0)
    var = (w * (x - mean) ** 2).sum() / denom
    return mean, torch.sqrt(var)


def histogram_density(x: torch.Tensor, bins: int = 100
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``np.histogram(x, bins, density=True)`` as `ops/stats.py:110-139`
    computes it in float32: (density (bins,), edges (bins + 1,))."""
    dev = x.device
    lo = torch.min(x)
    hi = torch.max(x)
    same = hi <= lo  # numpy widens a zero-width range to [lo-0.5, hi+0.5]
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    # jnp.linspace(lo, hi, bins + 1) as XLA compiles it: lo*(1 - i*c) +
    # i*(hi*c) with c = float32(1/bins), the sum fused, then hi
    i = torch.arange(bins, dtype=torch.float32, device=dev)
    c = torch.tensor(1.0 / bins, dtype=torch.float32, device=dev)
    edges = torch.cat([fma_f32(i, hi * c, lo * (1.0 - i * c)), hi[None]])
    width = (hi - lo) / bins
    idx = torch.clamp(((x - lo) / width).to(torch.int32), 0, bins - 1).to(torch.int64)
    # numpy corrects the float-division index against the edge values so
    # that edges[i] <= x < edges[i+1] holds exactly
    idx = idx - (x < edges[idx]).to(torch.int64)
    upper = edges[torch.clamp_max(idx + 1, bins)]
    idx = idx + torch.logical_and(x >= upper, idx < bins - 1).to(torch.int64)
    idx = torch.clamp(idx, 0, bins - 1)
    counts = torch.zeros((bins,), dtype=x.dtype, device=dev).index_add_(
        0, idx, torch.ones_like(x))
    density = counts / (counts.sum() * torch.diff(edges))
    return density, edges


def elbow_threshold(max_z: torch.Tensor, bins: int = 100):
    """Histogram-elbow threshold (`ops/stats.py:142-156`,
    `#z_score + 엘보우 threshold.py:268-284`): the peak bin, then the first
    bin at or right of it whose density is nearest 0.01; the threshold is
    the midpoint of the two bin centres.  Returns (thr, centers, density)."""
    hist, edges = histogram_density(max_z, bins)
    centers = (edges[:-1] + edges[1:]) / 2.0
    peak = torch.argmax(hist)
    idx = torch.arange(bins, device=max_z.device)
    masked = torch.where(idx >= peak, torch.abs(hist - 0.01),
                         torch.tensor(float("inf"), device=max_z.device))
    target = torch.argmin(masked)
    thr = (centers[peak] + centers[target]) / 2.0
    return thr, centers, hist
