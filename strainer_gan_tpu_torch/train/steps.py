"""The D-first GAN train step, with the in-step quantile mask (counterpart
of `strainer_gan_tpu/train/steps.py:61-363`, ``_build_step_body``).

Faithful to the reference's update algebra (`#%basic.py:237-288`): ONE G
forward whose autograd graph the G step reuses; D sees the real batch, then
the detached fakes (two BN statistic updates), D's Adam step applies, and
then the G loss re-scores the same fakes through the UPDATED D (a third D
statistic update, in train mode).  BN statistics thus thread through in
the reference order (`steps.py:315-321`).

The per-batch quantile mask (``batch_mask`` with ``mask_on``, `# 상위
10%...X.py:280-318`, `steps.py:130-190`): a no-grad scoring forward of the
real batch, in D's training mode (torch updates BN running statistics under
no_grad too, so this pass comes first in the statistics' order), keeps the
samples whose ``sigmoid`` score is at or above the batch's ``mask_quantile``;
the real AND the fake side then train at the kept size, expressed as
per-sample weights on full-shape batches (weighted loss means and weighted
BatchNorm), which is torch's smaller batch exactly.  With ``stem_share``
D's BatchNorm-free stem runs once: the scoring pass and the training real
forward both start from its output, and autograd carries the real side's
gradient back through it (the JAX step's captured ``stem_vjp``,
`steps.py:298-307`).

``lane_count`` gives the partial tail batch of a drop_last=False epoch
(`steps.py:116-128`): lanes >= lane_count carry weight 0 in every loss mean,
every BatchNorm statistic (G's and D's), the in-step quantile and the
contamination counts — the same numbers torch gets from the smaller batch.
``z`` is an argument so a test can hand both packages the same noise; the
Trainer draws it from a ``torch.Generator``.  The step reads nothing back
to the host.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch

from ..ops import losses as L
from ..ops import stats as S
from .state import set_lr


class StepConfig(NamedTuple):
    d_loss_reduction: str = "sum"  # 'sum' | 'half_mean'
    real_label: float = 1.0
    fake_label: float = 0.0
    batch_mask: bool = False  # the in-step quantile mask (batch_quantile_mask)
    mask_quantile: float = 0.1
    nz: int = 100
    # "bfloat16" runs the forwards under autocast on the card; parameters,
    # BN statistics, losses and Adam stay float32
    compute_dtype: str = "float32"


def step_config_from(cfg) -> StepConfig:
    t, s = cfg.train, cfg.strain
    if t.g_before_d or s.fake_concat != "none" or cfg.model.d_dropout > 0:
        raise ValueError("the G-first step, fake concatenation and D dropout "
                         "are not ported yet")
    return StepConfig(d_loss_reduction=t.d_loss_reduction, real_label=t.real_label,
                      fake_label=t.fake_label, batch_mask=s.method == "batch_quantile_mask",
                      mask_quantile=s.mask_quantile, nz=cfg.model.nz,
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
               lane_count: Optional[int] = None, mask_on: bool = False,
               stem_share: bool = True) -> Dict[str, torch.Tensor]:
    """One D-first step on a normalised NCHW batch ``x``; updates the modules
    and optimizers in place and returns the metrics of `steps.py:347-360`.

    ``d_train=False`` is the bn_eval_after_score quirk: D's BatchNorms use
    (and keep) their running statistics.  ``mask_on`` gates the in-step
    mask of a ``batch_mask`` config (the epoch has reached
    ``mask_start_epoch``); ``stem_share=False`` runs the scoring and the
    real forward through the whole of D each, for the A/B test only."""
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

    # ---- in-step strain: score the real batch, keep the top 1 - q
    masked = scfg.batch_mask and mask_on
    keep = torch.ones((b,), dtype=torch.bool, device=dev) if valid is None else valid
    h_real = None
    if masked:
        with amp:
            if stem_share:
                h_real = disc.stem(x)  # with its graph: the real forward reuses it
            with torch.no_grad():
                logits_s = (disc.head(h_real, valid_w, train=d_train) if stem_share
                            else disc(x, valid_w, train=d_train))
        probs_s = L.sigmoid_ftz(logits_s)  # as XLA computes jax.nn.sigmoid
        if valid is None:
            keep = probs_s >= S.quantile(probs_s, scfg.mask_quantile)
        else:
            # a partial tail: the quantile of the valid lanes only, which is
            # torch.quantile on the smaller batch
            keep = (probs_s >= S.masked_quantile(probs_s, valid, scfg.mask_quantile)) & valid
    w_real = w_fake = keep.to(torch.float32) if masked else valid_w

    # ---- G forward, once; its graph serves the G step below.  G's BN
    # statistics cover the kept slots only: the reference draws its noise
    # at the masked size
    with amp:
        fake = gen(z, w_fake, train=True)

    # ---- D update: real, then detached fakes
    opt_d.zero_grad(set_to_none=True)
    with amp:
        out_r = (disc.head(h_real, w_real, train=d_train) if h_real is not None
                 else disc(x, w_real, train=d_train))
        out_f = disc(fake.detach(), w_fake, train=d_train)
    per_real = L.bce_from_logits(out_r, real_t)
    per_fake = L.bce_from_logits(out_f, fake_t)
    err_d = L.d_loss(per_real, per_fake, scfg.d_loss_reduction, w_real, w_fake)
    err_d.backward()
    opt_d.step()

    # ---- G update through the updated D
    opt_g.zero_grad(set_to_none=True)
    with amp:
        out_g = disc(fake, w_fake, train=d_train)
    err_g = L.weighted_mean(L.bce_from_logits(out_g, real_t), w_fake)
    err_g.backward(inputs=list(gen.parameters()))
    opt_g.step()

    with torch.no_grad():
        contam = source_id != 0
        if valid is not None:
            contam = torch.logical_and(contam, valid)  # pads never count
        filtered = (torch.logical_and(contam, torch.logical_not(keep)).sum() if masked
                    else torch.zeros((), dtype=torch.int64, device=dev))
        metrics = dict(
            errD=err_d.detach(), errG=err_g.detach(),
            errD_real=L.weighted_mean(per_real, w_real).detach(),
            errD_fake=L.weighted_mean(per_fake, w_fake).detach(),
            D_x=L.weighted_mean(torch.sigmoid(out_r), w_real),
            D_G_z1=L.weighted_mean(torch.sigmoid(out_f), w_fake),
            D_G_z2=L.weighted_mean(torch.sigmoid(out_g), w_fake),
            real_loss_per_sample=per_real.detach(),
            keep_mask=keep,
            # the scores the mask came from, for the parity report
            score_probs=(probs_s if masked
                         else torch.zeros((b,), dtype=torch.float32, device=dev)),
            n_contam=contam.sum(),
            n_filtered_contam=filtered,
        )
    return metrics
