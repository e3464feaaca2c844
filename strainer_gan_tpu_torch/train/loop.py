"""The epoch loop (counterpart of `strainer_gan_tpu/train/loop.py`): its
blocking chunked path (`loop.py:392-561`) and its deferred-stats path
(`loop.py:563-704`).

``Trainer`` turns a config into a run: builds the mixture, stages it on
the device, builds G/D and their Adam optimizers, wires the strainer, and
drives the reference's per-epoch schedule (`# final.py:414-448`):
prefilter -> [lr cut] -> [re-strain] -> batch loop.  One host fetch per
strain event (active count, strain accounting and the band path's overflow
flag) fixes the step count.  On the blocking path it comes before the
epoch's steps are launched.  On the deferred path (``defer_epoch_stats``,
a strain event of a chunked epoch without fixed-noise grids, whose capture
key has had its warm-up step: decided before any capture, counted in
``graph_stats`` as ``deferred_epochs`` and ``blocking_epochs``) the stats
are enqueued first, then the chunks of a guessed step count (the previous
epoch's, or the capacity of the permanent base), each step gated on the
device by the live count (``steps.GatedChunkedStep``: CUDA graph IF nodes
on the card); the fetch waits while they run, catch-up chunks follow a
short guess, then the gated partial tail, and only the live rows are
accounted.  Draws made for steps past the live count are undone (the
generators set back and drawn again up to it), so every later draw is the
one the blocking path makes.  A deferred epoch whose gated capture or
launch fails raises; it never becomes a blocking one.

The epoch is cut into segments that end right after each fixed-noise
sample point (``sample_every``); each segment runs as full chunks of
``steps_per_dispatch`` steps through ``steps.ChunkedStep`` (on the card,
one CUDA graph replay a chunk), then the remainder, the steps short of a
chunk, as one launch of the key's gated chunk (``GatedChunkedStep`` with
``c0`` its first step and ``bound`` its end: only its live steps run);
the ``drop_last=False`` partial tail, lane-masked, is one launch of the
key's gated tail.  The first chunk of a capture key (chunk, ``mask_on``,
``d_train``, stem sharing, compute type) is preceded by one per-step step
of the run with that key, its warm-up: nothing is trained that the
per-step path would not train.  Before that warm-up, and on a
sample-sharded dataset, the remainder and the tail run step by step.
``steps_per_dispatch=1`` is the per-step loop.  Executors are
cached per Trainer and share one graph memory pool; ``drop_captures``
empties the cache, and every ``load_state_dict`` of either optimizer
(``checkpoint.restore_checkpoint``, ``bridge.load_adam_from_flax``) calls
it.  ``scan_unroll`` has no counterpart in a graph (in the JAX package it
changes compile time only) and is ignored.  ``graph_stats`` counts the
captures and replays, beside ``kernel_launches``.

The console prints every ``log_every`` steps (at most one host fetch a
chunk), the fixed-noise grids every ``sample_every`` iterations, the
epoch's per-sample loss history and, on epochs of the in-step mask, one
packed fetch of the contamination counters are the other host reads.  A
logger with ``collect=False`` (the ``logger`` argument) keeps no loss
series, and the Trainer then keeps no mask or per-sample loss history and
draws no grids (`loop.py:365`).

Fake concatenation (`loop.py:271-282, 359-372`): an ``in_batch_recycle``
config turns the step's in-step keep on from ``fake_concat_start_epoch``
(the same capture key as ``batch_mask``'s gate); a pool config builds
``fake_pool`` in ``setup`` from the z-score outliers, and its steps take
the pool's rows and the gate as inputs: the gate's flip is a flag filled
before each replay, not a new capture.

The MNIST MLPs (`loop.py:203-227`): ``auto_batch_divisor`` sets the batch
from the staged dataset's size, min(max(n // divisor, 16), 64), before
anything is built from it (so the captures are keyed by that batch); the
feature trunk takes the flattened rows; a D with dropout takes its keep
masks from the Trainer's own generator (``drop_rng``), so the noise stream
is the same with dropout or without it.  ``mnist_full``'s periodic FID
(`loop.py:738-753`) runs after every ``fid_every_epochs``-th epoch against
the clean reals, appends ``(epoch, fid_real)`` to ``fid_history`` and
prints ``Epoch N: FID = v``.

``epoch_indices`` and ``step_noise`` draw an epoch's batch order and a
step's noise from the Trainer's generator, ``step_dropout`` a step's keep
masks from ``drop_rng``, and ``pool_order`` and ``step_pool_rows`` the
pool's permutations from its own (``pool_rng``), outside any graph and in
the per-step order; a test may replace them on an instance to hand the
port the JAX package's draws (a deferred epoch asks for the capacity's
index rows and for the draws of every step it dispatches, dead ones too).

``kernel_launches`` holds how often each CUDA kernel wrapper launched
during ``run()``.

Spans and counters (``obs.profiler``): ``epoch`` around ``run_epoch``;
inside it ``epoch.strain`` (``engine.on_epoch_start``), ``epoch.stats``
(the stats' dispatch and fetch), ``step.eager`` (one per-step step: its
draws, gather, step and accounting), ``step.chunk`` (one executor call:
the draws stacked, the replay, the accounting; ``chunk.capture`` inside
around a first capture), ``step.remainder`` (one launch of a gated
remainder or tail, the same parts), ``epoch.grid`` (``sample()``) and
``epoch.close`` (everything after the last step); ``host_read.<what>``
around each read that blocks the host on the card.  Each epoch's result
holds its own counts (``counts``): eager steps by reason (``eager.warmup``,
the capture key's warm-up; ``eager.remainder``, a segment's steps short
of a chunk; ``eager.tail``, the partial last step; ``eager.per_step`` at
``steps_per_dispatch=1``), the gated launches' live steps
(``gated.remainder``, ``gated.tail``) and host reads by what they read;
the rest of its steps ran in full chunks (``graph_stats`` counts the
replays, gated launches included).

Data parallelism (`loop.py:160-245, 440-460`): whenever a
``torch.distributed`` process group is initialised (``parallel``; the
CLI's ``--dp``), whatever its size, the Trainer takes the rank path: it
trains on the rank's card (``cuda:LOCAL_RANK``, or the CPU with gloo),
holds the whole dataset there as the single-host JAX mesh replicates it,
draws every step's indices, noise, pool rows and keep masks for the
global batch from the same generators on every rank, and hands the step
the rank's lanes (``steps.rank_inputs``; inside a chunk each rank gathers
its own lanes).  The batch must divide by the world size.  Only rank 0
prints and runs the periodic FID.  At world size 1 the rank path is
bit-equal to the run with no group.

Multi-host staging (`loop.py:166-199, 384-389`): when the group spans more
than one host (``parallel.multihost.host_count``), every rank builds the
same mixture, trims it to equal shards and stages only its own rows
(``DeviceDataset.from_rank_local``).  Whatever the environment, a
sample-sharded ``dataset`` makes each step bring its lanes in through the
dataset's exchange (a collective every rank enters, recorded into the
CUDA graphs), keeps every strain event on the blocking path (counted in
``blocking_epochs``), sums the contamination counts over ranks, and has
every rank gather the periodic FID's rows before rank 0 computes it.
Bit-equal to the replicated run on the same trimmed mixture.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data import DeviceDataset, build_mixture, epoch_batch_indices, normalize_u8
from ..data.pipeline import device_full_and_tail
from ..device import resolve_device
from ..kernels import launch_counts
from ..models import build_models
from ..models.features import build_feature_fn
from ..obs.metrics import MetricsLogger
from ..obs.profiler import count, counts, counts_since, host_read, span
from ..data.mixers import Mixture
from ..parallel import mesh as M
from ..parallel import multihost as MH
from ..parallel.multihost import rank_device
from ..strain.engine import StrainerEngine
from ..strain.pool import fake_pool_rows
from ..utils.trees import finite_check
from .schedules import lr_at
from .state import make_optimizers
from .steps import (ChunkedStep, GatedChunkedStep, autocast, drop_shape, pool_indices,
                    rank_inputs, step_config_from, train_step)

BAND_COOLOFF_EVENTS = 5  # f32 strain events after a band overflow (`loop.py:302-308`)
POOL_SEED_OFFSET = 13  # the fake pool's generator: seeded cfg.train.seed + 13
DROP_SEED_OFFSET = 17  # D's dropout masks' generator: seeded cfg.train.seed + 17
# the strainers whose mask is picked from the whole dataset, not from the
# permanent base: a deferred epoch's step capacity is then the dataset's
FULL_SET_STRAINERS = ("loss_gmm", "loss_ensemble", "autoencoder")


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device=None, max_synth: Optional[int] = None,
                 dataset: Optional[DeviceDataset] = None,
                 logger: Optional[MetricsLogger] = None):
        """``dataset``: an already staged dataset to train on (on ``device``;
        sample-sharded or not); by default the config's mixture is built and
        staged (this rank's shard of it across hosts).  ``logger``: the
        console and loss series (`loop.py:152-158`); by default one at the
        config's ``log_every``."""
        # under a process group: the rank's card (or the CPU with gloo)
        self.device = resolve_device(rank_device(device))
        self.cfg = cfg
        # host seconds of building the mixture (synthetic generators, resize
        # and gather through the host-staging library), when this Trainer
        # staged its own dataset
        self.staging_seconds: Optional[float] = None
        if dataset is None:
            t0 = time.perf_counter()
            mixture = build_mixture(cfg.data, max_synth=max_synth)
            self.staging_seconds = time.perf_counter() - t0
            if MH.host_count() > 1:
                # this rank's contiguous rows of the mixture trimmed to equal
                # shards (`loop.py:180-199`)
                lo, hi, n = MH.shard_bounds(len(mixture), MH.rank(), MH.world())
                dataset = DeviceDataset.from_rank_local(
                    Mixture(mixture.images[lo:hi], mixture.source_id[lo:hi],
                            mixture.labels[lo:hi]), n, self.device)
            else:
                dataset = DeviceDataset(mixture, self.device)
        self.dataset = dataset
        if cfg.data.auto_batch_divisor:
            # `#8.py:43`: batch = min(max(n // divisor, 16), 64)
            bs = min(max(dataset.n // cfg.data.auto_batch_divisor, 16), 64)
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=bs))
            self.cfg = cfg
        if cfg.data.batch_size % M.world():
            raise ValueError(f"batch_size {cfg.data.batch_size} not divisible by "
                             f"dp={M.world()}")
        gen, disc = build_models(cfg.model, seed=cfg.train.seed)
        self.gen, self.disc = gen.to(self.device), disc.to(self.device)
        self.opt_g, self.opt_d = make_optimizers(cfg, self.gen, self.disc)
        feature_fn = None
        s = cfg.strain
        if s.method.startswith("zscore") or s.fake_concat == "pool" or (
                s.method == "loss_percentile" and s.prefilter):
            feature_fn = build_feature_fn(
                s.feature_extractor, cfg.model.nc, self.device,
                flatten_input_hw=((cfg.data.image_size,) * 2 if cfg.data.flatten else None))
        self.engine = StrainerEngine(cfg, self.disc, self.dataset, feature_fn=feature_fn,
                                     score_batch=cfg.strain.score_batch)
        self.scfg = step_config_from(cfg)
        self.logger = logger if logger is not None else MetricsLogger(
            log_every=cfg.train.log_every, style="mnist" if cfg.model.arch == "mlp" else "dcgan")
        # one explicit generator for the epoch permutations and the noise
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        # the fake pool's permutations (its build and each step's rows), from
        # their own generator, so the noise stream is the same with or
        # without a pool
        self.pool_rng = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + POOL_SEED_OFFSET)
        # D's dropout masks, from their own generator too
        self.drop_rng = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + DROP_SEED_OFFSET)
        # the fake-concat configs' device-resident uint8 outlier pool, built
        # by setup() (not the CUDA graphs' memory pool, ``_graph_pool``)
        self.fake_pool: Optional[torch.Tensor] = None
        self.fake_pool_rows: Optional[torch.Tensor] = None  # its dataset indices
        # the grids' noise, from its own seeded generator; a caller may
        # replace it (the tests hand both packages the same noise)
        self.fixed_noise = torch.randn(
            (cfg.train.fixed_noise_n, cfg.model.nz),
            generator=torch.Generator().manual_seed(cfg.train.seed + 7)).to(self.device)
        self.epoch_loss_history: List[np.ndarray] = []
        self.mask_history: List[np.ndarray] = []
        self.img_list: List[np.ndarray] = []  # fixed-noise grids (`#%basic.py:226`)
        self.strain_quality: List[Dict] = []
        self.fid_history: List = []  # (epoch, fid_real) of each periodic FID
        self.epoch_results: List[Dict] = []  # run_epoch's dicts, in order
        self.kernel_launches: Dict[str, int] = {}
        self._iters = 0  # global training iterations so far
        self._stats = None  # (n_active, true-positive removals, n_contaminants)
        self._last_steps = None  # the last epoch's full steps: a deferred epoch's guess
        self._pinned: Dict[tuple, torch.Tensor] = {}  # the stats' host buffers
        # chunk executors by capture key (the gated chunks and gated tails
        # apart), their shared graph pool and counts
        self._executors: Dict[tuple, ChunkedStep] = {}
        self._gated: Dict[tuple, GatedChunkedStep] = {}
        self._gated_tails: Dict[tuple, GatedChunkedStep] = {}
        self._graph_pool = None
        self.graph_stats = dict(captures=0, replays=0, gated_replays=0, conditional_nodes=0,
                                deferred_epochs=0, blocking_epochs=0, capture_s=[],
                                instantiate_s=[])
        for opt in (self.opt_g, self.opt_d):
            # a loaded state rebinds the tensors a captured graph reads
            opt.register_load_state_dict_post_hook(lambda _opt: self.drop_captures())

    def drop_captures(self) -> None:
        """Forget every chunk executor and its graph (and its warm-up), and
        their memory pool: the next capture starts a new one."""
        self._executors.clear()
        self._gated.clear()
        self._gated_tails.clear()
        self._graph_pool = None

    def _executor(self, cls, key: tuple, like: Dict, chunk: int, **kw):
        _, mask_on, d_train, stem_share, _ = key
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return cls(self.gen, self.disc, self.opt_g, self.opt_d, self.dataset, self.scfg, chunk,
                   like, mask_on=mask_on, d_train=d_train, stats=self.graph_stats,
                   stem_share=stem_share, graph_pool=self._graph_pool,
                   fake_pool=self.fake_pool, **kw)

    def _add_executor(self, key: tuple, like: Dict) -> None:
        self._executors[key] = self._executor(ChunkedStep, key, like, key[0])

    def _gated_executor(self, key: tuple, tail: bool = False) -> GatedChunkedStep:
        """The gated chunk (or, with ``tail``, the gated partial tail) of a
        warmed-up capture key; its metrics are shaped as the key's chunk's."""
        cache = self._gated_tails if tail else self._gated
        if key not in cache:
            like = {k: v[0] for k, v in self._executors[key].out.items()}
            cache[key] = self._executor(GatedChunkedStep, key, like, 1 if tail else key[0],
                                        tail=tail)
        return cache[key]

    def setup(self) -> None:
        """Pre-training strain (the z-score prefilter), then the fake pool of
        a pool config from the z-score outliers (`strainer_gan_tpu/train/loop.py:271-282`).
        The prefilter is not logged as a strain event, as in the JAX
        package: epoch 0 finds its mask already active, so ``run_epoch``
        only fetches its count."""
        s = self.cfg.strain
        if s.prefilter and s.method != "none":
            self.engine.prefilter()
        if s.fake_concat == "pool":
            self.fake_pool_rows = fake_pool_rows(self.engine.outlier_mask(),
                                                 s.fake_pool_fraction,
                                                 perm=self.pool_order(self.dataset.n))
            self.fake_pool = self.dataset.gather(self.fake_pool_rows)

    def _dispatch_epoch_stats(self, active: torch.Tensor, with_mask: bool = False):
        """Enqueue the packed epoch stats (active count, true-positive
        removals, contaminants, the band path's overflow flag) and, with
        ``with_mask``, the mask itself for copies to pinned host memory,
        with an event after them; nothing waits (`loop.py:284-292`).  On the
        deferred path this runs before the epoch's chunks are launched, so
        ``_fetch_epoch_stats`` waits for the strain and the copies only."""
        ds = self.dataset
        contam = ds.source_id != 0  # the rank's rows of a sharded dataset
        dropped = torch.logical_not(active).narrow(0, ds.lo, contam.shape[0])
        counts = torch.stack([torch.logical_and(dropped, contam).sum(), contam.sum()])
        if ds.sharded:
            M.all_reduce_(counts)  # the counts stay global (`loop.py:263`)
        band = self.engine.last_band_stats
        overflow = band[1] if band is not None else torch.zeros((), device=self.device)
        outs = [torch.cat([active.sum().reshape(1), counts, overflow.to(torch.int64).reshape(1)])]
        if with_mask:
            outs.append(active)
        if self.device.type != "cuda":
            return outs, None
        host = []
        for t in outs:
            # one pinned buffer per shape, reused: each fetch copies it out
            # before the next dispatch
            key = (tuple(t.shape), t.dtype)
            if key not in self._pinned:
                self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.append(self._pinned[key].copy_(t, non_blocking=True))
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _fetch_epoch_stats(self, pending):
        """Wait for ``_dispatch_epoch_stats``'s copies (`loop.py:294-309`);
        returns (n_active, true-positive removals, n_contaminants) and the
        mask on the host (None unless dispatched ``with_mask``).  An
        overflow of the band path puts the engine on ``BAND_COOLOFF_EVENTS``
        strain events of f32 scoring (the overflow pays bf16 bulk + full
        f32, so a persistently concentrated D must not pay it every
        epoch)."""
        host, done = pending
        with host_read("stats"):
            if done is not None:
                done.synchronize()
            stats = [int(v) for v in host[0].tolist()]
            mask = host[1].numpy().copy() if len(host) > 1 else None
        if stats[3] and self.engine.last_score_path == "band":
            self.engine.band_cooloff = BAND_COOLOFF_EVENTS
        self._stats = tuple(stats[:3])
        return self._stats, mask

    def _log_strain(self, epoch: int, n_active: int, strain_tp: int, n_contam: int) -> None:
        """The console line and the strain's precision and recall against
        the contamination labels."""
        removed = self.dataset.n - n_active
        self.logger.log_strain(epoch, removed, n_active)
        if removed and n_contam:
            self.strain_quality.append(dict(
                epoch=epoch, removed=removed, precision=strain_tp / removed,
                recall=strain_tp / n_contam))

    def _warn_no_batches(self, epoch: int, n_active: int) -> None:
        bs = self.cfg.data.batch_size
        self.logger.stream.write(
            f"[strainer] WARNING epoch {epoch}: 0 full batches ({n_active} active "
            f"samples < batch_size {bs}) — no training this epoch\n")

    def _step_counts(self, n_active: int):
        """(steps, tail): the epoch's steps and the valid lanes of its
        partial last step (0 with ``drop_last``)."""
        bs = self.cfg.data.batch_size
        if self.cfg.data.drop_last:
            return n_active // bs, 0
        # exact partial final batch (`#%basic.py:76`): the last step runs
        # with ``tail`` valid lanes
        return -(-n_active // bs), n_active % bs

    def _step_capacity(self) -> int:
        """The most steps a deferred epoch can have, from what the host
        knows: the permanent base's size (`loop.py:566-572`), or the
        dataset's for the strainers that pick from all of it."""
        sub = self.engine._base_subset
        n = (self.dataset.n if sub is None or self.cfg.strain.method in FULL_SET_STRAINERS
             else int(sub.shape[0]))
        return self._step_counts(n)[0]

    def epoch_indices(self, epoch: int, active: torch.Tensor, steps: int) -> torch.Tensor:
        """(steps, batch_size) sample indices of ``epoch``.  One permutation
        whatever ``steps`` is: the first rows of a longer draw are the rows
        of a shorter one."""
        return epoch_batch_indices(active, steps, self.cfg.data.batch_size, generator=self.rng)

    def step_noise(self, epoch: int, i: int) -> torch.Tensor:
        """(batch_size, nz) noise of step ``i`` of ``epoch``."""
        return torch.randn((self.cfg.data.batch_size, self.cfg.model.nz), generator=self.rng,
                           device=self.device)

    def step_dropout(self, epoch: int, i: int) -> List[torch.Tensor]:
        """D's keep masks of step ``i`` of ``epoch``: ``steps.drop_shape``
        bool per hidden width, each element kept with probability 1 - p
        (``jax.random.bernoulli``'s ``uniform < p`` form); [] without
        dropout."""
        keep = 1.0 - self.scfg.dropout
        return [torch.rand(drop_shape(self.scfg, self.cfg.data.batch_size, w),
                           generator=self.drop_rng, device=self.device) < keep
                for w in self.scfg.drop_widths]

    def pool_order(self, n: int) -> torch.Tensor:
        """A random permutation of ``n`` (the pool's build draws one over the
        dataset, each pool step one over the pool's rows)."""
        return torch.randperm(n, generator=self.pool_rng, device=self.device)

    def step_pool_rows(self, epoch: int, i: int) -> torch.Tensor:
        """(batch_size,) fake-pool rows of step ``i`` of ``epoch``."""
        return pool_indices(self.pool_order(self.fake_pool.shape[0]),
                            self.cfg.data.batch_size)

    def run_epoch(self, epoch: int) -> Dict:
        before = counts()
        with span("epoch"):
            result = self._epoch(epoch)
        result["counts"] = counts_since(before)
        self.epoch_results.append(result)
        return result

    def _epoch(self, epoch: int) -> Dict:
        cfg, s, t = self.cfg, self.cfg.strain, self.cfg.train
        t0 = time.perf_counter()
        mask_on = s.method == "batch_quantile_mask" and epoch >= s.mask_start_epoch
        recycle_on = s.fake_concat == "in_batch" and epoch >= s.fake_concat_start_epoch
        concat_on = s.fake_concat == "pool" and epoch >= s.fake_concat_start_epoch
        gate = mask_on or recycle_on  # the step's in-step keep (`loop.py:359-363`)
        if not gate:
            # stale-state guard (`loop.py:337-346`): the parity report must
            # not read an earlier gated epoch's in-step scores
            eng = self.engine
            eng.last_batch_scores = eng.last_batch_mask = eng.last_batch_valid = None
        prev_active = self.engine.active
        with span("epoch.strain"):
            active = self.engine.on_epoch_start(epoch)
        strain_event = self._stats is None or active is not prev_active
        collect = self.logger.collect
        sampling = bool(t.sample_every and collect)
        chunk = max(1, t.steps_per_dispatch)
        d_train = not self.engine.d_bn_eval
        key = (chunk, gate, d_train, True, self.scfg.compute_dtype)
        # the deferred-stats path (`loop.py:373-390`): a strain event of a
        # chunked epoch without grids, once its capture key has had its
        # warm-up step (decided here, before any capture); a sample-sharded
        # dataset keeps the blocking path (`loop.py:384-389`)
        deferred = (t.defer_epoch_stats and strain_event and chunk > 1 and not sampling
                    and key in self._executors and not self.dataset.sharded)
        if strain_event:
            self.graph_stats["deferred_epochs" if deferred else "blocking_epochs"] += 1
        lr_g = lr_at(t.lr_g, epoch, t)
        lr_d = lr_at(t.lr_d, epoch, t)
        bs = cfg.data.batch_size
        pooled = self.fake_pool is not None
        losses = []  # per-sample real losses of the epoch's steps, on the device
        # contamination counters of the in-step mask, summed on the device
        counters = torch.zeros((2,), dtype=torch.int64, device=self.device)
        metrics = None
        lanes = None

        def account(m, it0, n, steps, stacked=True, valid=None):
            """Log ``n`` of the epoch's ``steps`` from ``it0`` and add them to
            its counters and history; ``m`` is a chunk's stacked metrics or,
            with ``stacked=False``, one step's.  ``valid``: a partial tail's
            lanes."""
            nonlocal metrics, lanes
            if stacked:
                self.logger.log_chunk(epoch, t.epochs, it0, steps, m, n)
            else:
                self.logger.log_step(epoch, t.epochs, it0, steps, m)
            if mask_on:
                counters.add_(torch.stack([m["n_contam"].sum(), m["n_filtered_contam"].sum()]))
            if collect:
                losses.append(m["real_loss_per_sample"].reshape(-1) if stacked
                              else m["real_loss_per_sample"][:valid])
            metrics = {k: v[n - 1] for k, v in m.items()} if stacked else m
            lanes = valid

        if deferred:
            steps, strain_seconds = self._deferred_steps(
                epoch, active, prev_active, key, lr_g, lr_d, concat_on, account, t0)
        else:
            if strain_event:
                with span("epoch.stats"):
                    stats, _ = self._fetch_epoch_stats(self._dispatch_epoch_stats(active))
                if active is not prev_active:
                    self._log_strain(epoch, *stats)
            n_active = self._stats[0]
            if collect:
                with host_read("mask"):  # waits for the strain
                    self.mask_history.append(active.cpu().numpy())
            strain_seconds = time.perf_counter() - t0
            steps, tail = self._step_counts(n_active)
            self._last_steps = n_active // bs
            if steps == 0:
                self._warn_no_batches(epoch, n_active)
            idx = self.epoch_indices(epoch, active, steps)

            def run_one(i, reason):
                valid = tail if (tail and i == steps - 1) else None
                count("eager." + ("per_step" if chunk == 1 else
                                  "tail" if valid is not None else reason))
                with span("step.eager"):
                    # the global step's draws; the rank takes its lanes
                    _, z, rows, drop = rank_inputs(
                        self.scfg, idx[i], self.step_noise(epoch, i),
                        self.step_pool_rows(epoch, i) if pooled else None,
                        self.step_dropout(epoch, i))
                    u8, src = self.dataset.batch(idx[i])
                    m = train_step(
                        self.gen, self.disc, self.opt_g, self.opt_d,
                        normalize_u8(u8, torch.float32), src, z, lr_g, lr_d, self.scfg,
                        d_train=d_train, lane_count=valid, mask_on=gate,
                        fake_pool=self.fake_pool, pool_idx=rows, concat_on=concat_on,
                        drop_masks=drop,
                    )
                    account(m, i, 1, steps, stacked=False, valid=valid)

            def run_chunk(i, ex):
                with span("step.chunk"):
                    z, rows, drop = self._stacked_draws(
                        [self._step_draws(epoch, i + j, pooled) for j in range(chunk)])
                    # a copy: the next chunk reuses the buffers
                    account(ex(idx[i:i + chunk], z, lr_g, lr_d, pool_idx=rows,
                               concat_on=concat_on, drop=drop), i, chunk, steps)

            def run_remainder(i, n):
                """Steps ``i`` to ``i + n - 1`` (``n`` short of a chunk) as one
                launch of the key's gated chunk: only the live steps' draws,
                the dead rows zeros, which no step reads."""
                count("gated.remainder", n)
                with span("step.remainder"):
                    z, rows, drop = self._stacked_draws(
                        [self._step_draws(epoch, i + j, pooled) for j in range(n)])

                    def pad(t):
                        return None if t is None else torch.cat(
                            [t, t.new_zeros((chunk - n,) + tuple(t.shape[1:]))])

                    m = self._gated_executor(key)(
                        pad(idx[i:i + n]), pad(z), lr_g, lr_d, i, i + n, pool_idx=pad(rows),
                        concat_on=concat_on, drop=[pad(d) for d in drop])
                    account({k: v[:n] for k, v in m.items()}, i, n, steps)

            def run_tail(i):
                """The partial tail step ``i`` as one launch of the key's
                gated tail, its ``tail`` lanes live."""
                count("gated.tail")
                with span("step.remainder"):
                    z, rows, drop = self._stacked_draws([self._step_draws(epoch, i, pooled)])
                    m = self._gated_executor(key, tail=True)(
                        idx[i:i + 1], z, lr_g, lr_d, 0, tail, pool_idx=rows,
                        concat_on=concat_on, drop=drop)
                    account({k: v[0] for k, v in m.items()}, i, 1, steps, stacked=False,
                            valid=tail)

            # segments end right after each step whose global iteration is a
            # sample point (`#%basic.py:300-304`; `loop.py:527-561`): full
            # chunks, then the remainder, and the partial tail by itself; once
            # the key has had its warm-up (so chunk > 1), each of the last two
            # is one launch of its gated graph (the conditions of the deferred
            # path's gated chunks), before that step by step
            pos = 0
            while pos < steps:
                if sampling:
                    until = (-(self._iters + pos)) % t.sample_every
                    boundary, sample_here = min(pos + until + 1, steps), pos + until < steps
                else:
                    boundary, sample_here = steps, False
                # full chunks stop short of the partial tail step
                limit = boundary - (1 if (tail and boundary == steps) else 0)
                while chunk > 1 and pos + chunk <= limit:
                    if key not in self._executors:
                        run_one(pos, "warmup")  # the key's warm-up: a step of the run
                        self._add_executor(key, metrics)
                        pos += 1
                        continue
                    run_chunk(pos, self._executors[key])
                    pos += chunk
                gated = key in self._executors and not self.dataset.sharded
                if gated and pos < limit:
                    run_remainder(pos, limit - pos)
                    pos = limit
                while pos < limit:
                    run_one(pos, "remainder")
                    pos += 1
                if pos < boundary:  # the partial tail
                    if gated:
                        run_tail(pos)
                    else:
                        run_one(pos, "remainder")
                    pos += 1
                if sample_here:
                    with span("epoch.grid"):
                        self.img_list.append(self.sample())
        with span("epoch.close"):
            n_active = self._stats[0]
            self._iters += steps
            # and after the last iteration of the last epoch, unless that one
            # was a sample point already (`#%basic.py:301`, an ``or``)
            if sampling and steps and epoch == t.epochs - 1 \
                    and (self._iters - 1) % t.sample_every != 0:
                with span("epoch.grid"):
                    self.img_list.append(self.sample())
            total_contam = filtered_contam = 0
            if mask_on:
                # one host fetch per epoch for both sums (`loop.py:719-727`)
                with host_read("contam"):
                    total_contam, filtered_contam = counters.tolist()
                self.logger.log_contamination(epoch, filtered_contam, total_contam)
            if gate and metrics is not None:
                # the last step's scores and mask for the parity report; a
                # partial tail's valid lanes are its first ``lanes``
                self.engine.last_batch_scores = metrics["score_probs"]
                self.engine.last_batch_mask = metrics["keep_mask"]
                self.engine.last_batch_valid = bs if lanes is None else lanes
            ev = cfg.eval
            if ev.fid and ev.fid_every_epochs and (epoch + 1) % ev.fid_every_epochs == 0 \
                    and (M.is_primary() or self.dataset.sharded):
                # the periodic FID (`# 1,2,8.py:333-359`; `loop.py:738-753`); the
                # rows it reads gathered on every rank of a sharded dataset
                from ..eval.suite import eval_rows, evaluate_run

                n_fid = min(ev.fid_n_samples, self.dataset.n)
                rows = eval_rows(self.dataset, n_fid)
                if M.is_primary():
                    fid = evaluate_run(cfg, self.gen, rows, n_samples=n_fid)
                    self.fid_history.append((epoch, fid.get("fid_real")))
                    self.logger.stream.write(f"Epoch {epoch + 1}: FID = {fid.get('fid_real')}\n")
            if losses:
                # the reference's per-epoch ``epoch_losses`` (`# 1,2,8.py:300-303`)
                with host_read("history"):
                    self.epoch_loss_history.append(torch.cat(losses).cpu().numpy())
            if t.check_finite:
                with host_read("finite"):
                    finite = finite_check(self.gen, self.disc)
                if not finite:
                    raise FloatingPointError(
                        f"non-finite parameters detected after epoch {epoch} — training "
                        "diverged (enable smaller lr or f32 compute)")
            self.engine.on_epoch_end(epoch)
            if self.device.type == "cuda":
                with host_read("sync"):
                    torch.cuda.synchronize(self.device)
            result = dict(steps=steps, active=n_active, lr_g=lr_g, lr_d=lr_d,
                          filtered_contam=filtered_contam, total_contam=total_contam, last=metrics,
                          seconds=time.perf_counter() - t0, strain_seconds=strain_seconds)
        return result

    def _step_draws(self, epoch: int, i: int, pooled: bool):
        """Step ``i``'s draws: noise, pool rows (None without a pool) and
        keep masks."""
        return (self.step_noise(epoch, i),
                self.step_pool_rows(epoch, i) if pooled else None,
                self.step_dropout(epoch, i))

    @staticmethod
    def _stacked_draws(draws):
        """Per-step draws stacked along a leading step axis, as a chunk
        takes them."""
        zs, rows, drops = zip(*draws)
        return (torch.stack(zs), None if rows[0] is None else torch.stack(rows),
                [torch.stack(ms) for ms in zip(*drops)])

    def _generator_states(self):
        return [g.get_state() for g in (self.rng, self.pool_rng, self.drop_rng)]

    def _deferred_steps(self, epoch, active, prev_active, key, lr_g, lr_d, concat_on,
                        account, t0):
        """The deferred-stats epoch (`loop.py:563-704`): the stats are
        dispatched first, then the chunks of the guessed step count
        (the previous epoch's, or the capacity), each gated on the device
        by the live count; the stats are fetched while they run; catch-up
        chunks follow if the guess fell short, then the gated partial tail.
        Only the live rows are accounted.  Returns (steps, strain_seconds).

        Draws: every step's noise, pool rows and keep masks are drawn in the
        per-step order, as the blocking path draws them, and the
        generators' states are kept at each chunk's first step; once the
        count is known, a dispatch past it sets them back to the kept state
        at or below the count and draws again up to it, so they stand after
        exactly the live steps' draws: epoch ``e + 1`` draws the same
        whichever path epoch ``e`` took."""
        chunk, bs = key[0], self.cfg.data.batch_size
        pooled = self.fake_pool is not None
        max_steps = self._step_capacity()
        rows = max(1, -(-max_steps // chunk)) * chunk
        with span("epoch.stats"):
            pending = self._dispatch_epoch_stats(active, with_mask=self.logger.collect)
        idx = self.epoch_indices(epoch, active, rows)
        n_valid, tail_dev = device_full_and_tail(active, bs).unbind()
        gated = self._gated_executor(key)
        draws, kept = [], {}

        def draw_upto(n):
            while len(draws) < n:
                if len(draws) % chunk == 0:
                    kept[len(draws)] = self._generator_states()
                draws.append(self._step_draws(epoch, len(draws), pooled))

        outs = []

        def dispatch(c):
            with span("step.chunk"):
                draw_upto((c + 1) * chunk)
                z, rows_c, drop = self._stacked_draws(draws[c * chunk:(c + 1) * chunk])
                outs.append(gated(idx[c * chunk:(c + 1) * chunk], z, lr_g, lr_d, c * chunk,
                                  n_valid, pool_idx=rows_c, concat_on=concat_on, drop=drop))

        guess = self._last_steps if self._last_steps is not None else max_steps
        guess = min(max(guess, 1), max_steps)
        for c in range(-(-guess // chunk)):
            dispatch(c)
        # the stats' wait rides under the chunks' device time
        with span("epoch.stats"):
            stats, mask = self._fetch_epoch_stats(pending)
        strain_seconds = time.perf_counter() - t0
        n_active = stats[0]
        if mask is not None:
            self.mask_history.append(mask)
        if active is not prev_active:
            self._log_strain(epoch, *stats)
        full = n_active // bs
        steps, tail = self._step_counts(n_active)
        if steps == 0:
            self._warn_no_batches(epoch, n_active)
        self._last_steps = full
        if steps > rows:
            raise RuntimeError(f"epoch {epoch}: {n_active} active samples exceed the "
                               f"deferred path's capacity of {rows} steps")
        while len(outs) * chunk < full:  # catch-up: the guess fell short
            dispatch(len(outs))
        m_tail = None
        if tail:
            with span("step.chunk"):
                # the gated partial tail, after every live full chunk: its index
                # row ``n_valid`` taken on the device, its draws step ``full``'s
                draw_upto(steps)
                z, rows_t, drop = self._stacked_draws(draws[full:full + 1])
                row = torch.clamp(n_valid, max=rows - 1).reshape(1)
                m_tail = self._gated_executor(key, tail=True)(
                    idx.index_select(0, row), z, lr_g, lr_d, 0, tail_dev, pool_idx=rows_t,
                    concat_on=concat_on, drop=drop)
        if steps < len(draws):  # the dispatches drew past the live steps
            at = steps - steps % chunk
            for g, st in zip((self.rng, self.pool_rng, self.drop_rng), kept[at]):
                g.set_state(st)
            for i in range(at, steps):
                self._step_draws(epoch, i, pooled)
        for c, m in enumerate(outs):
            v = min(max(full - c * chunk, 0), chunk)
            if v == 0:
                break
            account({k: val[:v] for k, val in m.items()}, c * chunk, v, steps)
        if m_tail is not None:
            account({k: val[0] for k, val in m_tail.items()}, full, 1, steps, stacked=False,
                    valid=tail)
        return steps, strain_seconds

    def run(self, epochs: Optional[int] = None) -> List[Dict]:
        before = launch_counts()
        self.setup()
        out = [self.run_epoch(e) for e in range(epochs or self.cfg.train.epochs)]
        after = launch_counts()
        self.kernel_launches = {k: after[k] - before[k] for k in after}
        return out

    def sample(self, n: Optional[int] = None, train_bn: Optional[bool] = None) -> np.ndarray:
        """Fixed-noise generator output as (N, H, W, C) float32, or the
        MLP's (N, H*W*C) rows, as the JAX package returns them
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
        imgs = imgs.to(torch.float32)
        if imgs.dim() == 4:
            imgs = imgs.permute(0, 2, 3, 1)
        with host_read("grid"):
            return imgs.cpu().numpy()
