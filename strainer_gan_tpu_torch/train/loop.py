"""The epoch driver (counterpart of `strainer_gan_tpu/train/loop.py`), the
blocking path.

``Trainer`` turns a config into a run: builds the mixture, stages it on
the device, builds G/D and their Adam optimizers, wires the strainer, and
drives the reference's per-epoch schedule (`# final.py:414-448`):
prefilter -> [lr cut] -> [re-strain] -> batch loop.  One host fetch per
strain event (active count, strain accounting and the band path's overflow
flag) fixes the step count; the console prints every ``log_every`` steps,
the fixed-noise grids every ``sample_every`` iterations, the epoch's
per-sample loss history and, on epochs of the in-step mask, one packed
fetch of the contamination counters are the other host reads.

``epoch_indices`` and ``step_noise`` draw an epoch's batch order and a
step's noise from the Trainer's generator; a test may replace them on an
instance to hand the port the JAX package's draws.

``kernel_launches`` holds how often each CUDA kernel wrapper launched
during ``run()``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data import DeviceDataset, build_mixture, epoch_batch_indices, normalize_u8
from ..device import resolve_device
from ..kernels import launch_counts
from ..models import build_models
from ..models.features import build_feature_fn
from ..obs.metrics import MetricsLogger
from ..strain.engine import StrainerEngine
from ..utils.trees import finite_check
from .schedules import lr_at
from .state import make_optimizers
from .steps import autocast, step_config_from, train_step

BAND_COOLOFF_EVENTS = 5  # f32 strain events after a band overflow (`loop.py:302-308`)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device=None, max_synth: Optional[int] = None,
                 dataset: Optional[DeviceDataset] = None):
        """``dataset``: an already staged dataset to train on (on ``device``);
        by default the config's mixture is built and staged."""
        self.device = resolve_device(device)
        self.cfg = cfg
        if dataset is None:
            dataset = DeviceDataset(build_mixture(cfg.data, max_synth=max_synth), self.device)
        self.dataset = dataset
        gen, disc = build_models(cfg.model, seed=cfg.train.seed)
        self.gen, self.disc = gen.to(self.device), disc.to(self.device)
        self.opt_g, self.opt_d = make_optimizers(cfg, self.gen, self.disc)
        feature_fn = None
        s = cfg.strain
        if s.method.startswith("zscore") or (s.method == "loss_percentile" and s.prefilter):
            feature_fn = build_feature_fn(s.feature_extractor, cfg.model.nc, self.device)
        self.engine = StrainerEngine(cfg, self.disc, self.dataset, feature_fn=feature_fn,
                                     score_batch=cfg.strain.score_batch)
        self.scfg = step_config_from(cfg)
        self.logger = MetricsLogger(log_every=cfg.train.log_every)
        # one explicit generator for the epoch permutations and the noise
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        # the grids' noise, from its own seeded generator; a caller may
        # replace it (the tests hand both packages the same noise)
        self.fixed_noise = torch.randn(
            (cfg.train.fixed_noise_n, cfg.model.nz),
            generator=torch.Generator().manual_seed(cfg.train.seed + 7)).to(self.device)
        self.epoch_loss_history: List[np.ndarray] = []
        self.mask_history: List[np.ndarray] = []
        self.img_list: List[np.ndarray] = []  # fixed-noise grids (`#%basic.py:226`)
        self.strain_quality: List[Dict] = []
        self.epoch_results: List[Dict] = []  # run_epoch's dicts, in order
        self.kernel_launches: Dict[str, int] = {}
        self._iters = 0  # global training iterations so far
        self._stats = None  # (n_active, true-positive removals, n_contaminants)

    def setup(self) -> None:
        """Pre-training strain (the z-score prefilter).  Not logged as a
        strain event, as in the JAX package (`strainer_gan_tpu/train/loop.py:271-277`):
        epoch 0 finds the prefilter's mask already active, so ``run_epoch``
        only fetches its count."""
        s = self.cfg.strain
        if s.prefilter and s.method != "none":
            self.engine.prefilter()

    def _fetch_epoch_stats(self, active: torch.Tensor):
        """One host fetch; an overflow of the band path puts the engine on
        ``BAND_COOLOFF_EVENTS`` strain events of f32 scoring (the overflow
        pays bf16 bulk + full f32, so a persistently concentrated D must
        not pay it every epoch)."""
        contam = self.dataset.source_id != 0
        dropped = torch.logical_not(active)
        band = self.engine.last_band_stats
        overflow = band[1] if band is not None else torch.zeros((), device=self.device)
        stats = [int(v) for v in torch.stack([
            active.sum(), torch.logical_and(dropped, contam).sum(), contam.sum(),
            overflow.to(torch.int64),
        ]).tolist()]
        if stats[3] and self.engine.last_score_path == "band":
            self.engine.band_cooloff = BAND_COOLOFF_EVENTS
        self._stats = tuple(stats[:3])
        return self._stats

    def _log_strain(self, epoch: int, active: torch.Tensor) -> None:
        """One host fetch: the console line and the strain's precision and
        recall against the contamination labels."""
        n_active, strain_tp, n_contam = self._fetch_epoch_stats(active)
        removed = self.dataset.n - n_active
        self.logger.log_strain(epoch, removed, n_active)
        if removed and n_contam:
            self.strain_quality.append(dict(
                epoch=epoch, removed=removed, precision=strain_tp / removed,
                recall=strain_tp / n_contam))

    def epoch_indices(self, epoch: int, active: torch.Tensor, steps: int) -> torch.Tensor:
        """(steps, batch_size) sample indices of ``epoch``."""
        return epoch_batch_indices(active, steps, self.cfg.data.batch_size, generator=self.rng)

    def step_noise(self, epoch: int, i: int) -> torch.Tensor:
        """(batch_size, nz) noise of step ``i`` of ``epoch``."""
        return torch.randn((self.cfg.data.batch_size, self.cfg.model.nz), generator=self.rng,
                           device=self.device)

    def run_epoch(self, epoch: int) -> Dict:
        cfg, s, t = self.cfg, self.cfg.strain, self.cfg.train
        t0 = time.perf_counter()
        mask_on = s.method == "batch_quantile_mask" and epoch >= s.mask_start_epoch
        if not mask_on:
            # stale-state guard (`loop.py:337-346`): the parity report must
            # not read an earlier gated epoch's in-step scores
            eng = self.engine
            eng.last_batch_scores = eng.last_batch_mask = eng.last_batch_valid = None
        prev_active = self.engine.active
        active = self.engine.on_epoch_start(epoch)
        if active is not prev_active:
            self._log_strain(epoch, active)
        elif self._stats is None:
            self._fetch_epoch_stats(active)
        n_active = self._stats[0]
        self.mask_history.append(active.cpu().numpy())  # waits for the strain
        strain_seconds = time.perf_counter() - t0

        lr_g = lr_at(t.lr_g, epoch, t)
        lr_d = lr_at(t.lr_d, epoch, t)
        bs = cfg.data.batch_size
        if cfg.data.drop_last:
            steps, tail = n_active // bs, 0
        else:
            # exact partial final batch (`#%basic.py:76`): the last step runs
            # with ``tail`` valid lanes
            steps, tail = -(-n_active // bs), n_active % bs
        if steps == 0:
            self.logger.stream.write(
                f"[strainer] WARNING epoch {epoch}: 0 full batches ({n_active} active "
                f"samples < batch_size {bs}) — no training this epoch\n")
        idx = self.epoch_indices(epoch, active, steps)
        d_train = not self.engine.d_bn_eval
        sampling = bool(t.sample_every)
        losses = []  # per-sample real losses of the epoch's steps, on the device
        # contamination counters of the in-step mask, summed on the device
        counters = torch.zeros((2,), dtype=torch.int64, device=self.device)
        metrics = None
        lanes = None
        for i in range(steps):
            ids = idx[i]
            x = normalize_u8(self.dataset.gather(ids), torch.float32)
            z = self.step_noise(epoch, i)
            lanes = tail if (tail and i == steps - 1) else None
            metrics = train_step(
                self.gen, self.disc, self.opt_g, self.opt_d, x,
                self.dataset.source_id[ids], z, lr_g, lr_d, self.scfg, d_train=d_train,
                lane_count=lanes, mask_on=mask_on,
            )
            self.logger.log_step(epoch, t.epochs, i, steps, metrics)
            if mask_on:
                counters += torch.stack([metrics["n_contam"], metrics["n_filtered_contam"]])
            losses.append(metrics["real_loss_per_sample"][:lanes])
            # a grid after every sample_every-th global iteration (`#%basic.py:300-304`)
            if sampling and (self._iters + i) % t.sample_every == 0:
                self.img_list.append(self.sample())
        self._iters += steps
        # and after the last iteration of the last epoch, unless that one
        # was a sample point already (`#%basic.py:301`, an ``or``)
        if sampling and steps and epoch == t.epochs - 1 \
                and (self._iters - 1) % t.sample_every != 0:
            self.img_list.append(self.sample())
        total_contam = filtered_contam = 0
        if mask_on:
            # one host fetch per epoch for both sums (`loop.py:719-727`)
            total_contam, filtered_contam = counters.tolist()
            self.logger.log_contamination(epoch, filtered_contam, total_contam)
            if metrics is not None:
                # the last step's scores and mask for the parity report; a
                # partial tail's valid lanes are its first ``lanes``
                self.engine.last_batch_scores = metrics["score_probs"]
                self.engine.last_batch_mask = metrics["keep_mask"]
                self.engine.last_batch_valid = bs if lanes is None else lanes
        if losses:
            # the reference's per-epoch ``epoch_losses`` (`# 1,2,8.py:300-303`)
            self.epoch_loss_history.append(torch.cat(losses).cpu().numpy())
        if t.check_finite and not finite_check(self.gen, self.disc):
            raise FloatingPointError(
                f"non-finite parameters detected after epoch {epoch} — training "
                "diverged (enable smaller lr or f32 compute)")
        self.engine.on_epoch_end(epoch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        result = dict(steps=steps, active=n_active, lr_g=lr_g, lr_d=lr_d,
                      filtered_contam=filtered_contam, total_contam=total_contam, last=metrics,
                      seconds=time.perf_counter() - t0, strain_seconds=strain_seconds)
        self.epoch_results.append(result)
        return result

    def run(self, epochs: Optional[int] = None) -> List[Dict]:
        before = launch_counts()
        self.setup()
        out = [self.run_epoch(e) for e in range(epochs or self.cfg.train.epochs)]
        after = launch_counts()
        self.kernel_launches = {k: after[k] - before[k] for k in after}
        return out

    def sample(self, n: Optional[int] = None, train_bn: Optional[bool] = None) -> np.ndarray:
        """Fixed-noise generator output as (N, H, W, C) float32
        (`#%basic.py:301-304`; `strainer_gan_tpu/train/loop.py:794-818`).

        The reference never calls ``netG.eval()``: its grids come from
        BatchNorm in train mode, on the fixed batch's own statistics, under
        no_grad.  ``train_bn=True`` (``TrainConfig.sample_train_bn``) does
        that and, as the JAX package, drops the running-statistics update
        that forward makes: G's buffers are restored afterwards."""
        if train_bn is None:
            train_bn = self.cfg.train.sample_train_bn
        z = self.fixed_noise if n is None else self.fixed_noise[:n]
        kept = [b.clone() for b in self.gen.buffers()]
        with torch.no_grad(), autocast(z, self.scfg.compute_dtype):
            imgs = self.gen(z, train=train_bn)
        with torch.no_grad():
            for b, k in zip(self.gen.buffers(), kept):
                b.copy_(k)
        return imgs.to(torch.float32).permute(0, 2, 3, 1).cpu().numpy()
