"""Epoch-level schedules (counterpart of `strainer_gan_tpu/train/schedules.py`)."""
from __future__ import annotations

from typing import Optional, Tuple

from ..config import TrainConfig


def clean_ratio_at(epoch: int, schedule: Optional[Tuple[Tuple[int, float], ...]]) -> float:
    """Piecewise-constant keep-ratio schedule (`# final.py:383-390`)."""
    if schedule is None:
        return 1.0
    ratio = schedule[0][1]
    for start, r in schedule:
        if epoch >= start:
            ratio = r
    return ratio


def lr_at(base_lr: float, epoch: int, cfg: TrainConfig) -> float:
    """`adjust_learning_rate` (`# final.py:377-380`): a flat lr*factor cut
    from ``lr_decay_epoch`` on."""
    if cfg.lr_decay_epoch is not None and epoch >= cfg.lr_decay_epoch:
        return base_lr * cfg.lr_decay_factor
    return base_lr
