"""Strainer orchestration (counterpart of `strainer_gan_tpu/strain/engine.py`).

| method              | when                                   | reference flow                  |
|---------------------|----------------------------------------|---------------------------------|
| none                | never                                  | `#%basic.py`                    |
| zscore_fixed        | once at ``start_epoch`` (or prefilter) | `#z_score.py:309-321`           |
| zscore_elbow        | prefilter once                         | `#z_score + 엘보우...:350-359`  |
| zscore_dbscan       | prefilter once                         | `# z_score + DBSCAN.py:339-358` |
| loss_gmm            | every epoch (reset at its end)         | `#clean 분포...py:330-339,414`  |
| loss_ensemble       | every epoch >= 3, truncated in dataset | `# 종합 loss.py:360-377,456`    |
|                     | order by the clean-ratio schedule      |                                 |
| loss_percentile     | every epoch >= 3, from the prefiltered | `# final.py:440-448`            |
|                     | base                                   |                                 |
| autoencoder         | AE trained at epoch 3, strain every    | `#autoencoder.py:339-357`       |
|                     | epoch >= 3 from the full set           |                                 |
| batch_quantile_mask | inside the train step                  | `# 상위 10%...X.py:280-291`     |

``prefilter`` runs the z-score strain once before training and makes its
mask the permanent base; ``outlier_mask`` gives the fake pool's source
(the z-score outliers, ``fake_concat="pool"``); ``on_epoch_start`` runs the one-shot z-score
strain, the ``loss_percentile`` refinement (per-sample D losses over the
base subset, then the percentile mask within the base; scored in bfloat16
with a float32 band under ``score_precision="band_bf16"``, or all in
float32), the loss-space masks (per-sample D losses of the whole set, K1
at their tail, then the GMM or ensemble threshold), or the autoencoder's.
The strain state is boolean masks over the full device-resident dataset;
``last_mask`` is the mask of the last strain event.  Spans
(``obs.profiler``): ``prefilter.features`` (the trunk's pass),
``prefilter.zscore`` (K2a, K2b and the mask), ``strain.f32`` (the
percentile strain scored in float32) and ``host_read.base`` (the base's
index list); ``score.py`` spans the band path.  For
``batch_quantile_mask`` the Trainer records the last step's scores and
keep mask here (``last_batch_*``) for the parity report.

Under a process group (``parallel``) the D-loss passes are sharded by rows
and gathered (``score.py``), so every rank holds the same losses and
computes the same percentile, IQR and z-score masks; the decisions that
fit something (the GMM of ``loss_gmm`` and ``loss_ensemble``, the
autoencoder's training) are made on rank 0 and broadcast.  On a
sample-sharded dataset every rank trains the autoencoder (its batches come
in through the dataset's exchange, which every rank must enter) and rank
0's weights are broadcast all the same.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..config import ExperimentConfig
from ..data.pipeline import DeviceDataset, epoch_batch_indices, normalize_u8
from ..device import f32_math
from ..models.autoencoder import ConvAutoEncoder, init_ae_weights
from ..obs.profiler import host_read, span
from ..ops import dbscan as DB
from ..parallel import mesh as M
from ..train.schedules import clean_ratio_at
from . import score as SC
from . import thresholds as TH


ZSCORE_METHODS = ("zscore_fixed", "zscore_elbow", "zscore_dbscan")
METHODS = ("none", "loss_percentile", "loss_gmm", "loss_ensemble", "autoencoder",
           "batch_quantile_mask") + ZSCORE_METHODS
AE_SEED_OFFSET = 11  # the AE's generators: seeded cfg.train.seed + 11


def keep_count(mask: torch.Tensor, ratio: float) -> torch.Tensor:
    """``(sum(mask) * ratio).astype(int32)`` as the JAX engine computes it
    (`engine.py:222`): the int32 count times a weak Python float is a
    float32 product there, so 45,000 x 0.7 gives 31,500 (Python's float64
    gives 31,499)."""
    r = torch.tensor(ratio, dtype=torch.float32, device=mask.device)
    return (mask.sum().to(torch.float32) * r).to(torch.int32)


def _truncate_in_order(mask: torch.Tensor, num_keep: torch.Tensor) -> torch.Tensor:
    """Keep only the first ``num_keep`` True entries in dataset order,
    ``Subset(clean_dataset, range(num_clean))`` (`engine.py:45-50`,
    `# 종합 loss.py:371-372`)."""
    ranks = torch.cumsum(mask.to(torch.int32), 0) - 1
    return torch.logical_and(mask, ranks < num_keep)


def ae_train_step(ae: ConvAutoEncoder, opt: torch.optim.Optimizer, batch_u8: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """One MSE step of the AE on a uint8 batch (`engine.py:313-334`), in
    float32 with TF32 off.  The weighted mean of per-sample means is
    torch's MSELoss over the actual, possibly partial, batch: pad lanes
    carry weight 0."""
    with f32_math():
        x = normalize_u8(batch_u8, torch.float32)
        per = ((ae(x) - x) ** 2).mean(dim=(1, 2, 3))
        loss = (per * w).sum() / torch.clamp_min(w.sum(), 1.0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return loss.detach()


class StrainerEngine:
    """Holds the strain state (base mask, active mask) across epochs."""

    def __init__(self, cfg: ExperimentConfig, disc: torch.nn.Module,
                 dataset: DeviceDataset,
                 feature_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 score_batch: int = 512):
        sc = cfg.strain
        if sc.method not in METHODS:
            raise ValueError(f"strain method {sc.method!r} is not ported yet")
        if sc.fake_concat not in ("none", "in_batch", "pool"):
            raise ValueError(f"unknown fake_concat {sc.fake_concat!r}")
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
        # the in-step mask's last step (batch_quantile_mask): D's scores, the
        # keep mask and its valid lanes (a partial tail's), for the parity
        # report; cleared by the Trainer on ungated epochs
        self.last_batch_scores = None
        self.last_batch_mask = None
        self.last_batch_valid = None
        # the autoencoder strainer: its net, trained once at ae_train_epoch,
        # and the explicit generators of its initial weights (CPU) and batch
        # order (the dataset's device); ``build_ae`` and ``ae_epoch_indices``
        # draw from them, and a test may replace either to inject draws
        self.ae = None
        self.ae_train_seconds = None
        seed = cfg.train.seed + AE_SEED_OFFSET
        self.ae_init_rng = torch.Generator().manual_seed(seed)
        self.ae_rng = torch.Generator(device=dev).manual_seed(seed)

    def _features_full(self) -> torch.Tensor:
        if self._features is None:
            if self.feature_fn is None:
                raise ValueError(f"strainer {self.sc.method!r} needs a feature extractor")
            with span("prefilter.features"):
                self._features = SC.score_features(self.feature_fn, self.dataset,
                                                   self.score_batch)
        return self._features

    def _set_base(self, mask: torch.Tensor) -> None:
        """Record a new permanent base and its compacted index list (one host
        fetch per strain event), so loss scoring skips the dropped samples."""
        self.base_active = mask
        with host_read("base"):
            idx = torch.nonzero(mask).flatten()
        self._base_subset = idx if idx.shape[0] < self.dataset.n else None

    def _losses(self) -> torch.Tensor:
        # only loss_percentile scores the base subset (`engine.py:129`); the
        # loss-space strainers score and threshold the whole set
        subset = self._base_subset if self.sc.method == "loss_percentile" else None
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
        with span("prefilter.zscore"):
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

    def outlier_mask(self) -> torch.Tensor:
        """The complement of the fixed z-score inlier mask over the whole
        dataset, at ``z_threshold`` (5.0 when it is None): the fake pool's
        source (`engine.py:185-193`, `# fake concate.py:546-548`).  K2a and
        K2b score the features, which a prefilter has already computed."""
        sc = self.sc
        thr = sc.z_threshold if sc.z_threshold is not None else 5.0
        mask, _ = TH.zscore_fixed_mask(self._features_full(), thr, sc.z_std_mode,
                                       sc.strict_less)
        return torch.logical_not(mask)

    def _refine(self, loss_ratio: float):
        """The percentile mask over the base, by the band path or in f32
        (`engine.py:229-262`)."""
        sc = self.sc
        use_band = sc.score_precision == "band_bf16"
        if use_band and self.band_cooloff > 0:
            self.band_cooloff -= 1
            use_band = False
        if not use_band:
            with span("strain.f32"):
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

    def _set_active(self, mask: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
        self.last_threshold = thr
        self.active = mask
        self.last_mask = mask
        return mask

    def on_epoch_start(self, epoch: int) -> torch.Tensor:
        sc = self.sc
        if sc.method in ("none", "batch_quantile_mask"):
            return self.active
        if sc.method in ZSCORE_METHODS:
            if sc.prefilter or sc.every_epoch:
                return self.active
            if epoch == sc.start_epoch:  # `#z_score.py:309-321`: once, at 3
                return self._strain_base()
            return self.active
        if sc.method == "autoencoder":
            if epoch == sc.ae_train_epoch:
                self._train_autoencoder()
            if epoch >= sc.start_epoch and self.ae is not None:
                errors = SC.score_ae_errors(self.ae, self.dataset, self.score_batch)
                mask, thr = TH.ae_error_mask(errors, sc.ae_sigma)
                self.last_scores = errors
                return self._set_active(mask, thr)  # from the full set (`:346-351`)
            return self.active
        if epoch < sc.start_epoch:
            return self.active
        if sc.method == "loss_gmm":
            # the full set (`:330-339`)
            return self._set_active(*self._by_primary(TH.gmm_mask, self._losses()))
        if sc.method == "loss_ensemble":
            mask, thr = self._by_primary(TH.ensemble_mask, self._losses())
            ratio = clean_ratio_at(epoch, sc.clean_ratio_schedule)
            return self._set_active(_truncate_in_order(mask, keep_count(mask, ratio)), thr)
        if sc.final_py_ratio_inversion:
            # quirk #1 (`# final.py:443`): clean_ratio passed AS loss_ratio
            loss_ratio = clean_ratio_at(epoch, sc.clean_ratio_schedule)
        else:
            loss_ratio = sc.loss_ratio
        return self._set_active(*self._refine(loss_ratio))

    def _by_primary(self, fn, losses: torch.Tensor):
        """``fn(losses)``'s (mask, threshold) as rank 0 fits them, on every
        rank; ``fn(losses)`` without a process group."""
        if not M.grouped():
            return fn(losses)

        def fit():
            mask, thr = fn(losses)
            return mask, thr.to(torch.float32)

        return M.from_primary(fit, torch.empty_like(losses, dtype=torch.bool),
                              torch.empty((), dtype=torch.float32, device=losses.device))

    def on_epoch_end(self, epoch: int) -> torch.Tensor:
        if self.sc.reset_each_epoch:
            self.active = self.base_active  # `#clean 분포...py:414-415`
        return self.active

    # ----------------------------------------------------------- AE training
    def build_ae(self) -> ConvAutoEncoder:
        """The strainer AE with its initial weights drawn from
        ``ae_init_rng`` (`engine.py:291-303`); checkpoint restore rebuilds
        it around the saved weights."""
        ae = ConvAutoEncoder(nc=self.cfg.model.nc)
        init_ae_weights(ae, self.ae_init_rng)
        return ae.to(self.dataset.device)

    def ae_epoch_indices(self, epoch: int, rows: int) -> torch.Tensor:
        """(rows, batch_size) sample indices of AE training epoch ``epoch``
        over the active set, the last row a partial tail's padding past it."""
        return epoch_batch_indices(self.active, rows, self.cfg.data.batch_size,
                                   generator=self.ae_rng)

    def _train_autoencoder(self) -> None:
        """`train_autoencoder` (`engine.py:305-346`, `#autoencoder.py:296-305`):
        Adam(``ae_lr``), MSE, ``ae_train_epochs`` epochs over the active set,
        drop_last=False: the last batch is the partial tail, its pad lanes
        weighted 0.  float32 with TF32 off, as the scoring.  One host read
        (the active count fixes the step count).  Under a process group
        rank 0 trains it and broadcasts its weights; every rank trains it
        on a sample-sharded dataset."""
        t0 = time.perf_counter()
        ae = self.build_ae()
        if not M.is_primary() and not self.dataset.sharded:
            for t in ae.state_dict().values():
                M.broadcast(t)
            self.ae = ae
            return
        opt = torch.optim.Adam(ae.parameters(), lr=self.sc.ae_lr)
        bs = self.cfg.data.batch_size
        dev = self.dataset.device
        n_act = int(self.active.sum())
        rows, tail = -(-n_act // bs), n_act % bs
        ones = torch.ones((bs,), dtype=torch.float32, device=dev)
        tail_w = (torch.arange(bs, device=dev) < tail).to(torch.float32)
        for ep in range(self.sc.ae_train_epochs):
            idx = self.ae_epoch_indices(ep, rows)
            for b in range(rows):
                ae_train_step(ae, opt, self.dataset.gather(idx[b]),
                              tail_w if (tail and b == rows - 1) else ones)
        for t in ae.state_dict().values():
            M.broadcast(t)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.ae = ae
        self.ae_train_seconds = time.perf_counter() - t0
