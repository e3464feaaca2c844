"""Optimizers (counterpart of `strainer_gan_tpu/train/state.py`).

Adam with betas (0.5, 0.999) (`#%basic.py:211-216`), or torch's defaults
(0.9, 0.999) where the preset asks; eps 1e-8.  G and D get separate rates
(TTUR, `# final.py:265`), and the step writes the epoch's rate into the
param group, as the reference mutates ``param_group['lr']``
(`# final.py:377-380`).

On the card both run with ``capturable=True``: the step count is a device
tensor and the bias correction is computed there, and the rate is a 0-d
device tensor that ``set_lr`` fills in place.  A CUDA graph that captured
``opt.step()`` (``train/steps.py::ChunkedStep``) then reads the count and
the rate at each replay, and the eager step runs the same arithmetic, so
the two agree bit for bit.  The CPU keeps torch's default Adam (host-side
bias correction, a Python float rate).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import ExperimentConfig


def adam_betas(cfg: ExperimentConfig) -> Tuple[float, float]:
    if cfg.train.adam_defaults:
        return 0.9, 0.999
    return cfg.train.beta1, cfg.train.beta2


def _lr_on_device(opt: torch.optim.Optimizer) -> None:
    """The rate as a 0-d float32 tensor on the parameters' device again
    after a ``load_state_dict`` (a checkpoint written on the CPU holds a
    float, which a capture would bake in and ``set_lr`` would replace)."""
    for group in opt.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            dev = group["params"][0].device
            group["lr"] = torch.full((), group["lr"], dtype=torch.float32, device=dev)


def make_adam(module: torch.nn.Module, lr: float,
              betas: Tuple[float, float]) -> torch.optim.Adam:
    dev = next(module.parameters()).device
    if dev.type != "cuda":
        return torch.optim.Adam(module.parameters(), lr=lr, betas=betas, eps=1e-8)
    opt = torch.optim.Adam(module.parameters(),
                           lr=torch.full((), lr, dtype=torch.float32, device=dev),
                           betas=betas, eps=1e-8, capturable=True)
    # eager steps (a chunk's warm-up step, remainders, partial tails) are
    # intended: no warning that a capturable Adam runs uncaptured
    opt._warned_capturable_if_run_uncaptured = True
    opt.register_load_state_dict_post_hook(_lr_on_device)
    return opt


def make_optimizers(cfg: ExperimentConfig, gen: torch.nn.Module,
                    disc: torch.nn.Module) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    betas = adam_betas(cfg)
    return make_adam(gen, cfg.train.lr_g, betas), make_adam(disc, cfg.train.lr_d, betas)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)  # in place: a captured step reads this tensor
        else:
            group["lr"] = lr


def get_lr(opt: torch.optim.Optimizer) -> float:
    """The first group's rate as a Python float (a host read on the card)."""
    return float(opt.param_groups[0]["lr"])
