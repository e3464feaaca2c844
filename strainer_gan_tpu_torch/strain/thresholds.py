"""Threshold selectors -> boolean keep-masks (counterpart of
`strainer_gan_tpu/strain/thresholds.py`): the z-score, loss-percentile,
loss-space (GMM, ensemble) and autoencoder strainers'.

Every function maps scores over the FULL dataset (plus an optional
``valid`` mask restricting the statistics to the active subset) to a keep
mask; entries outside ``valid`` always come back False.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import zscore as KZ
from ..ops import gmm as GM
from ..ops import stats as S


def _and_valid(mask: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    return mask if valid is None else torch.logical_and(mask, valid)


def _masked_max_abs_z(features: torch.Tensor, valid: Optional[torch.Tensor],
                      std_mode: str) -> torch.Tensor:
    """Plain version of K2 (`thresholds.py:25-48`): max-|z| per row with the
    statistics over the valid rows only, z = 0 on zero-std columns."""
    mean, std = KZ.column_stats_plain(features, valid, std_mode)
    return KZ.row_max_abs_z_plain(features, mean, std)


def masked_max_abs_z(features: torch.Tensor, valid: Optional[torch.Tensor],
                     std_mode: str) -> torch.Tensor:
    """The same statistic through the K2 kernels (plain on the CPU)."""
    return KZ.masked_max_abs_z(features, valid, std_mode)


def zscore_threshold_mask(max_z: torch.Tensor, threshold: float, strict: bool = True,
                          valid: Optional[torch.Tensor] = None):
    """Keep ``max_z < thr`` (or ``<=``) on precomputed max-|z| scores."""
    thr = torch.tensor(threshold, dtype=torch.float32, device=max_z.device)
    mask = max_z < thr if strict else max_z <= thr
    return _and_valid(mask, valid), thr


def zscore_fixed_mask(features: torch.Tensor, threshold: float, std_mode: str = "torch",
                      strict: bool = True, valid: Optional[torch.Tensor] = None):
    """`detect_outliers` with a fixed threshold (`#z_score.py:276-294`)."""
    return zscore_threshold_mask(masked_max_abs_z(features, valid, std_mode),
                                 threshold, strict, valid)


def zscore_elbow_mask(max_z: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """Keep ``max_z < thr`` with the histogram-elbow threshold
    (`thresholds.py:63-78`, `#z_score + 엘보우 threshold.py:268-331`); with
    ``valid``, invalid lanes enter the histogram at the valid maximum.
    Takes the max-|z| scores, which the engine computes once through K2
    (the JAX function takes the features and computes them itself)."""
    if valid is None:
        thr, _, _ = S.elbow_threshold(max_z)
    else:
        big = torch.max(torch.where(valid, max_z, torch.full_like(max_z, float("-inf"))))
        thr, _, _ = S.elbow_threshold(torch.where(valid, max_z, big))
    return _and_valid(max_z < thr, valid), thr


def zscore_quantile_mask(max_z: torch.Tensor, clean_ratio,
                         valid: Optional[torch.Tensor] = None):
    """Keep ``max_z <= quantile(max_z, clean_ratio)``, inclusive
    (`thresholds.py:81-93`, `# z_score + DBSCAN.py:305-326`); on max-|z|
    scores, as ``zscore_elbow_mask``."""
    if valid is None:
        thr = S.quantile(max_z, clean_ratio)
    else:
        thr = S.masked_quantile(max_z, valid, clean_ratio)
    return _and_valid(max_z <= thr, valid), thr


def percentile_refine_mask(losses: torch.Tensor, loss_ratio: float,
                           valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`refine_dataset_by_loss` (`# final.py:343-374`; `thresholds.py:121-163`).

    thr = percentile(losses of valid, (1 - loss_ratio) * 100); keep loss < thr;
    if nothing is kept, keep the bottom half by rank (>= 1 sample).  One
    stable argsort (as ``jnp.argsort``) serves the percentile and the
    fallback ranks; invalid lanes sort last at +float32 max; the
    interpolation position is computed in float32 as the reference does.
    """
    dev = losses.device
    ratio = torch.tensor(loss_ratio, dtype=torch.float32, device=dev)
    q = (1.0 - ratio) * 100.0
    if valid is None:
        valid = torch.ones(losses.shape, dtype=torch.bool, device=dev)
    n = losses.shape[0]
    big = torch.tensor(torch.finfo(torch.float32).max, dtype=torch.float32, device=dev)
    masked = torch.where(valid, losses, big)
    order = torch.argsort(masked, stable=True)
    n_valid = valid.sum()
    thr = S.interpolate_sorted(masked[order], n_valid, q)
    mask = torch.logical_and(losses < thr, valid)

    n_kept = mask.sum()
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    half = torch.clamp_min(n_valid // 2, 1)
    fallback = torch.logical_and(rank < half, valid)
    mask = torch.where(n_kept == 0, fallback, mask)
    return mask, thr


def gmm_mask(losses: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """Keep ``loss < thr`` at the GMM intersection (`thresholds.py:101-106`,
    `#clean 분포...py:289-316`)."""
    thr = GM.gmm_threshold(losses, valid)
    return _and_valid(losses < thr, valid), thr


def ensemble_mask(losses: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """Keep ``loss < thr`` at the median of {GMM, P75, Q3 + 1.5 IQR}
    (`thresholds.py:109-119`, `# 종합 loss.py:296-301`)."""
    gmm_thr = GM.gmm_threshold(losses, valid)
    if valid is None:
        p75 = S.percentile(losses, 75.0)
    else:
        p75 = S.masked_percentile(losses, valid, 75.0)
    thr = torch.median(torch.stack([gmm_thr, p75, S.iqr_threshold(losses, valid)]))
    return _and_valid(losses < thr, valid), thr


def ae_error_mask(errors: torch.Tensor, sigma: float = 2.0,
                  valid: Optional[torch.Tensor] = None):
    """Keep ``error < mean + sigma * std``, the std Bessel-corrected as
    ``torch.std`` (`thresholds.py:166-175`, `#autoencoder.py:317-321`)."""
    if valid is None:
        valid = torch.ones(errors.shape, dtype=torch.bool, device=errors.device)
    mean, std = S.masked_mean_std(errors, valid, bessel=True)
    thr = mean + sigma * std
    return _and_valid(errors < thr, valid), thr
