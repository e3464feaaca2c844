"""Diagnostic plots (a copy of `strainer_gan_tpu/obs/plots.py`, which
imports no JAX).

File-writing equivalents of the reference's interactive matplotlib output:
z-score histograms with the threshold line (`#z_score + 엘보우
threshold.py:286-304`), loss curves (`#%basic.py` closing cells).  Headless
(Agg backend), no-op gracefully if matplotlib is unavailable.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:  # pragma: no cover
        return None


def save_score_histogram(
    scores: np.ndarray, threshold: Optional[float], path: str,
    bins: int = 100, title: str = "Distribution of Z-Scores with Threshold",
    xlabel: str = "Z-Score",
) -> bool:
    """Histogram + density + threshold line (`#z_score + 엘보우...py:288-304`)."""
    plt = _plt()
    if plt is None:
        return False
    # drop non-finite lanes: compacted scoring scatters +inf into
    # permanently-dropped samples (strain/engine._losses) and np.histogram
    # raises on an infinite range
    scores = np.asarray(scores)
    scores = scores[np.isfinite(scores)]
    if scores.size == 0:
        return False
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.hist(scores, bins=bins, density=True, alpha=0.7, label="Distribution")
    hist, edges = np.histogram(scores, bins=bins, density=True)
    centers = (edges[:-1] + edges[1:]) / 2
    ax.plot(centers, hist, label="Density")
    if threshold is not None:
        ax.axvline(x=float(threshold), linestyle="--", color="r",
                   label=f"Threshold: {float(threshold):.2f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Density")
    ax.set_title(title)
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def save_loss_curves(g_losses: Sequence[float], d_losses: Sequence[float],
                     path: str) -> bool:
    """G/D loss-vs-iteration curves (the reference's closing plot cells)."""
    plt = _plt()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(g_losses, label="G")
    ax.plot(d_losses, label="D")
    ax.set_xlabel("iterations")
    ax.set_ylabel("loss")
    ax.set_title("Generator and Discriminator Loss During Training")
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True
