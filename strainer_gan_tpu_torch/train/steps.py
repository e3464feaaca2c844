"""The D-first GAN train step (counterpart of
`strainer_gan_tpu/train/steps.py:61-363`, ``_build_step_body``).

Faithful to the reference's update algebra (`#%basic.py:237-288`): ONE G
forward whose autograd graph the G step reuses; D sees the real batch, then
the detached fakes (two BN statistic updates), D's Adam step applies, and
then the G loss re-scores the same fakes through the UPDATED D (a third D
statistic update, in train mode).  BN statistics thus thread through in
the reference order (`steps.py:315-321`).

``lane_count`` gives the partial tail batch of a drop_last=False epoch
(`steps.py:116-128`): lanes >= lane_count carry weight 0 in every loss mean
and every BatchNorm statistic, G's and D's — the same numbers torch gets
from the smaller batch.  ``z`` is an argument so a test can hand both
packages the same noise; the Trainer draws it from a ``torch.Generator``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch

from ..ops import losses as L
from .state import set_lr


class StepConfig(NamedTuple):
    d_loss_reduction: str = "sum"  # 'sum' | 'half_mean'
    real_label: float = 1.0
    fake_label: float = 0.0
    nz: int = 100
    # "bfloat16" runs the forwards under autocast on the card; parameters,
    # BN statistics, losses and Adam stay float32
    compute_dtype: str = "float32"


def step_config_from(cfg) -> StepConfig:
    t = cfg.train
    if t.g_before_d or cfg.strain.method == "batch_quantile_mask" \
            or cfg.strain.fake_concat != "none" or cfg.model.d_dropout > 0:
        raise ValueError("only the plain D-first step is ported yet")
    return StepConfig(d_loss_reduction=t.d_loss_reduction, real_label=t.real_label,
                      fake_label=t.fake_label, nz=cfg.model.nz,
                      compute_dtype=cfg.model.compute_dtype)


def autocast(x: torch.Tensor, compute_dtype: str):
    """bfloat16 autocast on the card when ``compute_dtype`` asks for it;
    float32 elsewhere."""
    if compute_dtype == "bfloat16" and x.device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return contextlib.nullcontext()


def train_step(gen: torch.nn.Module, disc: torch.nn.Module,
               opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer,
               x: torch.Tensor, source_id: torch.Tensor, z: torch.Tensor,
               lr_g: float, lr_d: float, scfg: StepConfig, d_train: bool = True,
               lane_count: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One D-first step on a normalised NCHW batch ``x``; updates the modules
    and optimizers in place and returns the metrics of `steps.py:347-360`.

    ``d_train=False`` is the bn_eval_after_score quirk: D's BatchNorms use
    (and keep) their running statistics."""
    b = x.shape[0]
    dev = x.device
    valid = None
    valid_w = None
    if lane_count is not None:
        valid = torch.arange(b, device=dev) < lane_count
        valid_w = valid.to(torch.float32)
    real_t, fake_t = scfg.real_label, scfg.fake_label
    amp = autocast(x, scfg.compute_dtype)
    set_lr(opt_g, lr_g)
    set_lr(opt_d, lr_d)

    # ---- G forward, once; its graph serves the G step below
    with amp:
        fake = gen(z, valid_w, train=True)

    # ---- D update: real, then detached fakes
    opt_d.zero_grad(set_to_none=True)
    with amp:
        out_r = disc(x, valid_w, train=d_train)
        out_f = disc(fake.detach(), valid_w, train=d_train)
    per_real = L.bce_from_logits(out_r, real_t)
    per_fake = L.bce_from_logits(out_f, fake_t)
    err_d = L.d_loss(per_real, per_fake, scfg.d_loss_reduction, valid_w, valid_w)
    err_d.backward()
    opt_d.step()

    # ---- G update through the updated D
    opt_g.zero_grad(set_to_none=True)
    with amp:
        out_g = disc(fake, valid_w, train=d_train)
    err_g = L.weighted_mean(L.bce_from_logits(out_g, real_t), valid_w)
    err_g.backward(inputs=list(gen.parameters()))
    opt_g.step()

    with torch.no_grad():
        contam = source_id != 0
        keep = torch.ones((b,), dtype=torch.bool, device=dev) if valid is None else valid
        if valid is not None:
            contam = torch.logical_and(contam, valid)
        metrics = dict(
            errD=err_d.detach(), errG=err_g.detach(),
            errD_real=L.weighted_mean(per_real, valid_w).detach(),
            errD_fake=L.weighted_mean(per_fake, valid_w).detach(),
            D_x=L.weighted_mean(torch.sigmoid(out_r), valid_w),
            D_G_z1=L.weighted_mean(torch.sigmoid(out_f), valid_w),
            D_G_z2=L.weighted_mean(torch.sigmoid(out_g), valid_w),
            real_loss_per_sample=per_real.detach(),
            keep_mask=keep,
            score_probs=torch.zeros((b,), dtype=torch.float32, device=dev),
            n_contam=contam.sum(),
            n_filtered_contam=torch.zeros((), dtype=torch.int64, device=dev),
        )
    return metrics
