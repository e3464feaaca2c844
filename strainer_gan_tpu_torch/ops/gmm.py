"""Two-component 1-D Gaussian mixture by EM, and the analytic intersection
threshold (counterpart of `strainer_gan_tpu/ops/gmm.py:45-141`).

The reference fits ``sklearn.mixture.GaussianMixture(n_components=2,
max_iter=10, tol=1e-2, reg_covar=5e-4)`` on per-sample D losses and cuts at
the intersection of the two fitted Gaussians (`#clean 분포...py:289-316`,
`# 종합 loss.py:270-285`).  As the JAX package, the fit is deterministic:
20 Lloyd iterations in 1-D seeded at the valid P25/P75, then sklearn's
initialisation from the hard labels, then at most ``max_iter`` EM
iterations that stop once the mean log-likelihood moves less than ``tol``.

The loop never reads the device: it runs all ``max_iter`` iterations and,
once the flag is set, freezes the parameters of the iteration that set it
(``torch.where``), which is what the JAX ``lax.while_loop`` returns.  The
sums run in torch's order, not XLA's, so the fitted parameters differ from
the JAX package's in the last bits (tests/test_torch_loss_strainers.py
states the tolerance).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import stats

LLOYD_ITERS = 20
_EPS10 = 10.0 * torch.finfo(torch.float32).eps


class GMM1D(NamedTuple):
    means: torch.Tensor  # (2,)
    vars: torch.Tensor  # (2,)
    weights: torch.Tensor  # (2,)


def _log_gauss(x, mean, var):
    return -0.5 * (torch.log(2.0 * math.pi * var) + (x - mean) ** 2 / var)


def _m_step(resp: torch.Tensor, x: torch.Tensor, n: torch.Tensor, reg_covar: float) -> GMM1D:
    nk = resp.sum(0) + _EPS10
    means = (resp * x[:, None]).sum(0) / nk
    vars_ = (resp * (x[:, None] - means[None, :]) ** 2).sum(0) / nk + reg_covar
    return GMM1D(means, vars_, nk / n)


def fit_gmm2(x: torch.Tensor, valid: Optional[torch.Tensor] = None, max_iter: int = 10,
             tol: float = 1e-2, reg_covar: float = 5e-4) -> GMM1D:
    """The mixture of the ``valid`` entries of ``x`` (all when None)."""
    x = x.to(torch.float32)
    if valid is None:
        valid = torch.ones_like(x, dtype=torch.bool)
    w = valid.to(torch.float32)
    n = torch.clamp_min(w.sum(), 1.0)

    # Lloyd in 1-D: the nearer of two means is a cut at their midpoint
    a = stats.masked_percentile(x, valid, 25.0)
    b = stats.masked_percentile(x, valid, 75.0)
    for _ in range(LLOYD_ITERS):
        w_r = w * (x >= (a + b) / 2.0)
        w_l = w - w_r
        n_l, n_r = w_l.sum(), w_r.sum()
        a, b = (torch.where(n_l > 0, (x * w_l).sum() / torch.clamp_min(n_l, 1.0), a),
                torch.where(n_r > 0, (x * w_r).sum() / torch.clamp_min(n_r, 1.0), b))
    # sklearn's GaussianMixture._initialize from one-hot responsibilities
    right = (x >= (a + b) / 2.0).to(torch.float32)
    gmm = _m_step(torch.stack([(1.0 - right) * w, right * w], dim=1), x, n, reg_covar)

    prev_ll = torch.tensor(float("-inf"), device=x.device)
    converged = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(max_iter):
        log_w = _log_gauss(x[:, None], gmm.means[None, :], gmm.vars[None, :]) \
            + torch.log(gmm.weights)[None, :]
        log_norm = torch.logsumexp(log_w, dim=1)
        resp = torch.exp(log_w - log_norm[:, None]) * w[:, None]
        ll = (log_norm * w).sum() / n
        new = _m_step(resp, x, n, reg_covar)
        gmm = GMM1D(*(torch.where(converged, old, upd) for old, upd in zip(gmm, new)))
        done = torch.abs(ll - prev_ll) < tol
        prev_ll = torch.where(converged, prev_ll, ll)
        converged = converged | done
    return gmm


def gaussian_intersection_threshold(gmm: GMM1D) -> torch.Tensor:
    """The ``(-b + sqrt(b^2 - 4ac)) / 2a`` root of the two (unweighted)
    Gaussians' equal log-densities (`#clean 분포...py:300-307`); their
    midpoint when the variances are equal (a = 0)."""
    stds = torch.sqrt(gmm.vars)
    ci = torch.argmin(gmm.means)
    ni = 1 - ci
    mc, mn = gmm.means[ci], gmm.means[ni]
    sc, sn = stds[ci], stds[ni]
    a = 1.0 / (2.0 * sc ** 2) - 1.0 / (2.0 * sn ** 2)
    b = mn / sn ** 2 - mc / sc ** 2
    c = mc ** 2 / (2.0 * sc ** 2) - mn ** 2 / (2.0 * sn ** 2) - torch.log(sn / sc)
    disc = b ** 2 - 4.0 * a * c
    mid = torch.where(torch.abs(b) > 0, -c / torch.where(b == 0, torch.ones_like(b), b),
                      (mc + mn) / 2)
    root = (-b + torch.sqrt(torch.clamp_min(disc, 0.0))) / (2.0 * a)
    return torch.where(torch.abs(a) < 1e-12, mid, root)


def gmm_threshold(x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fit and intersect (`# 종합 loss.py:270-285`)."""
    return gaussian_intersection_threshold(fit_gmm2(x, valid))
