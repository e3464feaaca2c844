"""Numpy/sklearn parity oracles for every reference strainer (a copy of
`strainer_gan_tpu/parity/oracle.py`, which imports no JAX; the port keeps
its own so it never imports the JAX package).

Each re-implements a strain formula with the reference's exact host-side
semantics (torch-vs-numpy std conventions, `<` vs `<=`, sklearn calls —
SURVEY §2.4 items 5-6): given identical scores, the port's device masks
must reproduce these.  The DBSCAN and GMM oracles import sklearn when
called, as the JAX module does.

Everything here is plain numpy (+sklearn where the reference used it).
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# z-score family


def max_abs_zscores_torch(features: np.ndarray) -> np.ndarray:
    """`#z_score.py:283-289`: torch mean/std(dim=0) (Bessel), |z|, max dim=1."""
    mean = features.mean(axis=0)
    std = features.std(axis=0, ddof=1)
    z = np.abs((features - mean) / std)
    return z.max(axis=1)


def max_abs_zscores_numpy(features: np.ndarray) -> np.ndarray:
    """`# 1,2,8.py:160-167`: np.std (population) + 1e-7 eps."""
    mean = features.mean(axis=0)
    std = features.std(axis=0)
    z = np.abs((features - mean) / (std + 1e-7))
    return z.max(axis=1)


def zscore_fixed_mask(features, threshold=5.0, std_mode="torch", strict=True):
    mz = (max_abs_zscores_torch if std_mode == "torch" else max_abs_zscores_numpy)(
        features
    )
    return (mz < threshold) if strict else (mz <= threshold)


def find_elbow_threshold(z_scores: np.ndarray, bins: int = 100):
    """`#z_score + 엘보우 threshold.py:268-284` verbatim semantics."""
    hist, bin_edges = np.histogram(z_scores, bins=bins, density=True)
    bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    peak_index = int(np.argmax(hist))
    right_side_hist = hist[peak_index:]
    right_side_bins = bin_centers[peak_index:]
    target_index = int(np.argmin(np.abs(right_side_hist - 0.01)))
    target_z_score = right_side_bins[target_index]
    threshold = (bin_centers[peak_index] + target_z_score) / 2
    return threshold, bin_centers, hist


def zscore_elbow_mask(features, std_mode="torch"):
    mz = (max_abs_zscores_torch if std_mode == "torch" else max_abs_zscores_numpy)(
        features
    )
    thr, _, _ = find_elbow_threshold(mz)
    return mz < thr, thr


def dbscan_clean_ratio(features: np.ndarray, eps=20.0, min_samples=3) -> float:
    """`estimate_ratio_dbscan` (`# z_score + DBSCAN.py:272-302`)."""
    from sklearn.cluster import DBSCAN
    from sklearn.preprocessing import StandardScaler

    scaled = StandardScaler().fit_transform(features)
    labels = DBSCAN(eps=eps, min_samples=min_samples).fit_predict(scaled)
    return float(np.sum(labels != -1) / len(labels))


def zscore_quantile_mask(features, clean_ratio, std_mode="torch"):
    """`# z_score + DBSCAN.py:305-326`: torch.quantile + inclusive <=."""
    mz = (max_abs_zscores_torch if std_mode == "torch" else max_abs_zscores_numpy)(
        features
    )
    thr = np.quantile(mz, clean_ratio)  # linear interp == torch.quantile
    return mz <= thr, thr


# ---------------------------------------------------------------------------
# loss family


def bce_losses(probs: np.ndarray, target: float) -> np.ndarray:
    """torch nn.BCELoss(reduction='none') incl. the -100 log clamp."""
    log_p = np.maximum(np.log(np.clip(probs, 1e-45, None)), -100.0)
    log_1mp = np.maximum(np.log1p(np.clip(-probs, -1.0, None)), -100.0)
    return -(target * log_p + (1.0 - target) * log_1mp)


def gmm_threshold_sklearn(losses: np.ndarray, seed: int | None = 0) -> float:
    """`#clean 분포...py:289-307`: sklearn GMM(2, max_iter=10, tol=1e-2,
    reg_covar=5e-4) + analytic Gaussian intersection (the ``-b + sqrt`` root).
    ``seed`` pins sklearn's otherwise-unseeded kmeans init for testability."""
    from sklearn.mixture import GaussianMixture

    gmm = GaussianMixture(
        n_components=2, max_iter=10, tol=1e-2, reg_covar=5e-4, random_state=seed
    )
    gmm.fit(losses.reshape(-1, 1))
    means = gmm.means_.flatten()
    stds = np.sqrt(gmm.covariances_.flatten())
    ci = int(np.argmin(means))
    ni = 1 - ci
    a = 1 / (2 * stds[ci] ** 2) - 1 / (2 * stds[ni] ** 2)
    b = means[ni] / (stds[ni] ** 2) - means[ci] / (stds[ci] ** 2)
    c = (
        means[ci] ** 2 / (2 * stds[ci] ** 2)
        - means[ni] ** 2 / (2 * stds[ni] ** 2)
        - np.log(stds[ni] / stds[ci])
    )
    return float((-b + np.sqrt(b**2 - 4 * a * c)) / (2 * a))


def gmm_mask(losses, seed: int | None = 0):
    thr = gmm_threshold_sklearn(losses, seed)
    return losses < thr, thr


def ensemble_threshold(losses: np.ndarray, seed: int | None = 0) -> float:
    """`# 종합 loss.py:296-301`: median{GMM, P75, Q3+1.5IQR}."""
    gmm_thr = gmm_threshold_sklearn(losses, seed)
    percentile_thr = np.percentile(losses, 75)
    q1, q3 = np.percentile(losses, 25), np.percentile(losses, 75)
    iqr_thr = q3 + 1.5 * (q3 - q1)
    return float(np.median([gmm_thr, percentile_thr, iqr_thr]))


def ensemble_mask(losses, seed: int | None = 0):
    thr = ensemble_threshold(losses, seed)
    return losses < thr, thr


def ensemble_truncated_indices(losses, clean_ratio, seed: int | None = 0):
    """Full `# 종합 loss.py:360-372` flow: mask -> clean indices in dataset
    order -> first int(len*ratio) of them."""
    mask, thr = ensemble_mask(losses, seed)
    clean_idx = np.where(mask)[0]
    num_clean = int(len(clean_idx) * clean_ratio)
    return clean_idx[:num_clean], thr


def percentile_refine_mask(losses: np.ndarray, loss_ratio: float):
    """`refine_dataset_by_loss` (`# final.py:343-374`) on the full score set."""
    threshold = np.percentile(losses, (1 - loss_ratio) * 100)
    clean = losses < threshold
    if not clean.any():
        order = np.argsort(losses, kind="stable")
        keep = order[: max(len(losses) // 2, 1)]
        clean = np.zeros(len(losses), bool)
        clean[keep] = True
    return clean, float(threshold)


def batch_quantile_keep(scores: np.ndarray, q: float = 0.1):
    """`# 상위 10%...X.py:283-284`: thr = torch.quantile(scores, q);
    keep scores >= thr."""
    thr = np.quantile(scores, q)
    return scores >= thr, float(thr)


def ae_error_mask(errors: np.ndarray, sigma: float = 2.0):
    """`#autoencoder.py:317-321`: thr = mean + sigma*std (torch std: Bessel)."""
    thr = errors.mean() + sigma * errors.std(ddof=1)
    return errors < thr, float(thr)


def mask_agreement(mask_a: np.ndarray, mask_b: np.ndarray) -> float:
    """The headline metric: fraction of per-sample filtering decisions that
    agree (BASELINE.json: >= 0.99 required)."""
    mask_a = np.asarray(mask_a, bool)
    mask_b = np.asarray(mask_b, bool)
    return float(np.mean(mask_a == mask_b))
