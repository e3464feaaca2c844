"""Hand-written CUDA kernels for Hopper, one per TPU kernel on the port's path.

| wrapper | replaces (JAX package) | source |
|---|---|---|
| ``bce.bce_scores`` (K1) | `kernels/bce.py:22` bce_scores_pallas | ``csrc/bce.cu`` |
| ``zscore.column_stats`` (K2a) | `kernels/zscore.py:30` column_stats | ``csrc/zscore.cu`` |
| ``zscore.row_max_abs_z`` (K2b) | `kernels/zscore.py:78` max_abs_zscores_pallas | ``csrc/zscore.cu`` |
| ``pairwise.neighbor_counts`` (K3) | `kernels/pairwise.py:25` neighbor_counts_pallas | ``csrc/pairwise.cu`` |

Each wrapper counts its launches in a plain integer attribute,
``wrapper.launches``; ``launch_counts`` reads them all.
"""
from __future__ import annotations

from typing import Dict

from .bce import bce_scores
from .pairwise import neighbor_counts
from .zscore import column_stats, row_max_abs_z

WRAPPERS = {
    "bce_scores": bce_scores,
    "zscore_column_stats": column_stats,
    "zscore_row_max": row_max_abs_z,
    "neighbor_counts": neighbor_counts,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
