"""Optimizers (counterpart of `strainer_gan_tpu/train/state.py`).

Adam with betas (0.5, 0.999) (`#%basic.py:211-216`), or torch's defaults
(0.9, 0.999) where the preset asks; eps 1e-8.  G and D get separate rates
(TTUR, `# final.py:265`), and the step writes the epoch's rate into the
param group, as the reference mutates ``param_group['lr']``
(`# final.py:377-380`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import ExperimentConfig


def adam_betas(cfg: ExperimentConfig) -> Tuple[float, float]:
    if cfg.train.adam_defaults:
        return 0.9, 0.999
    return cfg.train.beta1, cfg.train.beta2


def make_optimizers(cfg: ExperimentConfig, gen: torch.nn.Module,
                    disc: torch.nn.Module) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    betas = adam_betas(cfg)
    opt_g = torch.optim.Adam(gen.parameters(), lr=cfg.train.lr_g, betas=betas, eps=1e-8)
    opt_d = torch.optim.Adam(disc.parameters(), lr=cfg.train.lr_d, betas=betas, eps=1e-8)
    return opt_g, opt_d


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
