"""Strainer orchestration for the ``final`` path and the feature-space
z-score strainers (counterpart of `strainer_gan_tpu/strain/engine.py`).

| method          | when                                   | reference flow                  |
|-----------------|----------------------------------------|---------------------------------|
| none            | never                                  | `#%basic.py`                    |
| zscore_fixed    | once at ``start_epoch`` (or prefilter) | `#z_score.py:309-321`           |
| zscore_elbow    | prefilter once                         | `#z_score + 엘보우...:350-359`  |
| zscore_dbscan   | prefilter once                         | `# z_score + DBSCAN.py:339-358` |
| loss_percentile | every epoch >= 3, from the prefiltered | `# final.py:440-448`            |
|                 | base                                   |                                 |

``prefilter`` runs the z-score strain once before training and makes its
mask the permanent base; ``on_epoch_start`` runs the one-shot z-score
strain or the ``loss_percentile`` refinement (per-sample D losses over the
base subset, then the percentile mask within the base; scored in bfloat16
with a float32 band under ``score_precision="band_bf16"``, or all in
float32).  The strain state is boolean masks over the full device-resident
dataset; ``last_mask`` is the mask of the last strain event.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import ExperimentConfig
from ..data.pipeline import DeviceDataset
from ..ops import dbscan as DB
from ..train.schedules import clean_ratio_at
from . import score as SC
from . import thresholds as TH


ZSCORE_METHODS = ("zscore_fixed", "zscore_elbow", "zscore_dbscan")


class StrainerEngine:
    """Holds the strain state (base mask, active mask) across epochs."""

    def __init__(self, cfg: ExperimentConfig, disc: torch.nn.Module,
                 dataset: DeviceDataset,
                 feature_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 score_batch: int = 512):
        sc = cfg.strain
        if sc.method not in ("none", "loss_percentile") + ZSCORE_METHODS:
            raise ValueError(f"strain method {sc.method!r} is not ported yet")
        if sc.fake_concat != "none":
            raise ValueError("fake_concat is not ported yet")
        self.cfg = cfg
        self.sc = sc
        self.disc = disc
        self.dataset = dataset
        self.feature_fn = feature_fn
        self.score_batch = score_batch
        n = dataset.n
        dev = dataset.device
        self.base_active = torch.ones((n,), dtype=torch.bool, device=dev)
        self.active = self.base_active
        self.d_bn_eval = False  # quirk: eval mode sticks after scoring
        self.last_threshold = None
        self.last_scores = None  # max-|z| or per-sample losses of the last strain
        self.last_mask = None  # the mask of the last strain event
        self.last_band_stats = None  # [n_rescored, fell_back_to_f32, max_drift] (band path)
        # after the band path overflows (a weakly separating D puts most
        # scores in the band, and the pass then pays bf16 bulk + full f32),
        # the Trainer sets this many strain events of plain f32 scoring
        self.band_cooloff = 0
        self.last_score_path = None  # "band" | "f32" (the last loss_percentile strain)
        self.last_clean_ratio = None  # DBSCAN clean ratio of the last zscore_dbscan strain
        self._features = None  # cached features for the z-score strainers
        self._base_subset = None  # int64 indices of base_active, when it shrank

    def _features_full(self) -> torch.Tensor:
        if self._features is None:
            if self.feature_fn is None:
                raise ValueError(f"strainer {self.sc.method!r} needs a feature extractor")
            self._features = SC.score_features(self.feature_fn, self.dataset,
                                               self.score_batch)
        return self._features

    def _set_base(self, mask: torch.Tensor) -> None:
        """Record a new permanent base and its compacted index list (one host
        fetch per strain event), so loss scoring skips the dropped samples."""
        self.base_active = mask
        idx = torch.nonzero(mask).flatten()
        self._base_subset = idx if idx.shape[0] < self.dataset.n else None

    def _losses(self) -> torch.Tensor:
        subset = self._base_subset
        losses = SC.score_d_losses(self.disc, self.dataset,
                                   real_label=self.cfg.train.real_label,
                                   batch_size=self.score_batch, subset=subset)
        if subset is not None:
            # scatter back to full size; dropped lanes +inf sort last
            full = torch.full((self.dataset.n,), float("inf"), dtype=torch.float32,
                              device=losses.device)
            full[subset] = losses
            losses = full
        if self.sc.bn_eval_after_score:
            self.d_bn_eval = True  # SURVEY §2.4 item 4
        self.last_scores = losses
        return losses

    def _zscore_mask(self) -> torch.Tensor:
        """The z-score strain over the whole dataset, in the reference's arm
        order (`engine.py:148-171`).  max-|z| is computed once (K2) and
        serves the mask and ``last_scores``; the reference computes it
        twice."""
        feats = self._features_full()
        sc = self.sc
        scores = TH.masked_max_abs_z(feats, None, sc.z_std_mode)
        if sc.method == "zscore_fixed" or (
            sc.method == "loss_percentile" and sc.z_threshold is not None
        ):
            mask, thr = TH.zscore_threshold_mask(scores, sc.z_threshold, sc.strict_less)
        elif sc.method == "zscore_elbow" or sc.z_threshold is None:
            mask, thr = TH.zscore_elbow_mask(scores)
        elif sc.method == "zscore_dbscan":
            ratio = DB.dbscan_clean_ratio(feats, sc.dbscan_eps, sc.dbscan_min_samples)
            self.last_clean_ratio = ratio
            mask, thr = TH.zscore_quantile_mask(scores, ratio)
        else:
            raise AssertionError(sc.method)
        self.last_threshold = thr
        self.last_scores = scores
        return mask

    def _strain_base(self) -> torch.Tensor:
        mask = self._zscore_mask()
        self._set_base(mask)
        self.active = mask
        self.last_mask = mask
        return self.active

    def prefilter(self) -> torch.Tensor:
        """Once-before-training z-score strain (`# final.py:414-427`; the
        elbow and DBSCAN variants)."""
        if not self.sc.prefilter or self.sc.method == "none":
            return self.active
        return self._strain_base()

    def _refine(self, loss_ratio: float):
        """The percentile mask over the base, by the band path or in f32
        (`engine.py:229-262`)."""
        sc = self.sc
        use_band = sc.score_precision == "band_bf16"
        if use_band and self.band_cooloff > 0:
            self.band_cooloff -= 1
            use_band = False
        if not use_band:
            mask, thr = TH.percentile_refine_mask(self._losses(), loss_ratio,
                                                  valid=self.base_active)
            self.last_band_stats = None  # the stats describe the band path only
            self.last_score_path = "f32"
            return mask, thr
        mask, thr, losses, stats = SC.fused_percentile_refine(
            self.disc, self.dataset, loss_ratio, self.base_active,
            real_label=self.cfg.train.real_label, batch_size=self.score_batch,
            subset=self._base_subset, band_eps=sc.band_eps,
            band_capacity_frac=sc.band_capacity_frac)
        if sc.bn_eval_after_score:
            self.d_bn_eval = True  # SURVEY §2.4 item 4
        self.last_scores = losses
        self.last_band_stats = stats
        self.last_score_path = "band"
        return mask, thr

    def on_epoch_start(self, epoch: int) -> torch.Tensor:
        sc = self.sc
        if sc.method == "none":
            return self.active
        if sc.method in ZSCORE_METHODS:
            if sc.prefilter or sc.every_epoch:
                return self.active
            if epoch == sc.start_epoch:  # `#z_score.py:309-321`: once, at 3
                return self._strain_base()
            return self.active
        if epoch < sc.start_epoch:
            return self.active
        if sc.final_py_ratio_inversion:
            # quirk #1 (`# final.py:443`): clean_ratio passed AS loss_ratio
            loss_ratio = clean_ratio_at(epoch, sc.clean_ratio_schedule)
        else:
            loss_ratio = sc.loss_ratio
        mask, thr = self._refine(loss_ratio)
        self.last_threshold = thr
        self.active = mask
        self.last_mask = mask
        return self.active

    def on_epoch_end(self, epoch: int) -> torch.Tensor:
        if self.sc.reset_each_epoch:
            self.active = self.base_active
        return self.active
