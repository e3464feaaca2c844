"""Runtime filter-mask agreement report (counterpart of
`strainer_gan_tpu/parity/agreement.py`).

Given a live trainer, recompute its latest strain decision with the numpy
oracle (the reference's host-side conventions, ``parity/oracle.py``) from
the scores the engine decided on, and report the share of samples on which
the two masks agree.  ``python -m strainer_gan_tpu_torch.cli ...
--parity-check`` prints it.  Covers the methods the port runs; for any
other method, and before the first strain event, the report is ``{}``.
For ``batch_quantile_mask`` it recomputes the last step's in-step keep mask
from the scores it was taken from, over that step's valid lanes.  The
``loss_gmm`` and ``loss_ensemble`` oracles import sklearn.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..train.schedules import clean_ratio_at
from . import oracle


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def agreement_report(trainer, epoch: Optional[int] = None) -> Dict:
    """The engine's last mask against the oracle's on the same scores
    (`strainer_gan_tpu/parity/agreement.py:18-123`)."""
    eng = trainer.engine
    sc = trainer.cfg.strain
    method = sc.method
    if method == "batch_quantile_mask":
        # `# 상위 10%...X.py:283-284`: torch.quantile over the ACTUAL batch,
        # which on a partial tail is its first ``last_batch_valid`` lanes
        if eng.last_batch_scores is None or eng.last_batch_mask is None:
            return {}
        scores = _host(eng.last_batch_scores).astype(np.float64)
        ours = _host(eng.last_batch_mask)
        nv = eng.last_batch_valid
        if nv is not None and nv < len(ours):
            scores, ours = scores[:nv], ours[:nv]
        want, _ = oracle.batch_quantile_keep(scores, sc.mask_quantile)
        return dict(method=method, agreement=oracle.mask_agreement(ours, want),
                    ours_kept=int(ours.sum()), oracle_kept=int(np.asarray(want).sum()),
                    n=len(ours))
    if eng.last_scores is None or eng.last_mask is None or method == "none":
        return {}

    scores = _host(eng.last_scores).astype(np.float64).astype(np.float32)
    ours = _host(eng.last_mask)  # the mask at strain time
    extra = {}
    if method == "zscore_fixed":
        want = scores < sc.z_threshold if sc.strict_less else scores <= sc.z_threshold
    elif method == "zscore_elbow":
        thr, _, _ = oracle.find_elbow_threshold(scores)
        want = scores < thr
    elif method == "zscore_dbscan":
        # the independent chain: sklearn StandardScaler + DBSCAN on the
        # cached features for the clean ratio, then numpy's quantile of
        # max-|z| (`# z_score + DBSCAN.py:272-326`)
        if eng._features is None:
            return {}
        feats = _host(eng._features).astype(np.float32)
        ratio = oracle.dbscan_clean_ratio(feats, sc.dbscan_eps, sc.dbscan_min_samples)
        want, _ = oracle.zscore_quantile_mask(feats, ratio, sc.z_std_mode)
        # zero-variance feature columns make the oracle's z NaN (0/0) and
        # drop every sample, where the port sets z = 0 there: tag the report
        n_dead = int((feats.std(axis=0, ddof=1) == 0.0).sum())
        if n_dead:
            extra = {"degenerate_dims": n_dead}
    elif method == "loss_percentile":
        base = _host(eng.base_active)
        lr_ = sc.loss_ratio
        if sc.final_py_ratio_inversion:
            lr_ = clean_ratio_at(
                epoch if epoch is not None else trainer.cfg.train.epochs - 1,
                sc.clean_ratio_schedule)
        sub_mask, _ = oracle.percentile_refine_mask(scores[base], lr_)
        want = np.zeros_like(ours)
        want[np.nonzero(base)[0][sub_mask]] = True
    elif method == "loss_gmm":
        want, _ = oracle.gmm_mask(scores, seed=0)
    elif method == "loss_ensemble":
        ratio = clean_ratio_at(epoch if epoch is not None else trainer.cfg.train.epochs - 1,
                               sc.clean_ratio_schedule)
        idx, _ = oracle.ensemble_truncated_indices(scores, ratio, seed=0)
        want = np.zeros_like(ours)
        want[idx] = True
    elif method == "autoencoder":
        want, _ = oracle.ae_error_mask(scores, sc.ae_sigma)
    else:
        return {}
    return dict(
        method=method,
        agreement=oracle.mask_agreement(ours, want),
        ours_kept=int(ours.sum()),
        oracle_kept=int(np.asarray(want).sum()),
        n=len(ours),
        **extra,
    )
