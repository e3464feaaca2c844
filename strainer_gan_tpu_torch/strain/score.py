"""Scoring passes over the dataset (counterpart of
`strainer_gan_tpu/strain/score.py`).

Every pass gathers uint8 batches from the device-resident dataset,
normalises them there, and runs an eval-mode forward.  Eval mode makes every
score independent of its batch, and every forward runs at the full
``batch_size`` (the last batch is padded, as the JAX scan pads it), so the
same sample gets the same float32 score whichever pass scores it and in
whichever batch: the band path's float32 re-scores equal the full float32
pass's, bit for bit.

Precision: strain decisions carry float32 rounding.  ``score_d_losses``,
``score_features`` and ``score_ae_errors`` run in float32 with TF32 off (``device.f32_math``);
``fused_percentile_refine`` scores the bulk in bfloat16 and re-scores in
float32 every sample near the percentile threshold, which gives the same
mask as the float32 pass.

Under a process group the D-loss passes are sharded by rows, as the JAX
mesh shards them: each rank scores its block (and launches K1 on it), and
the blocks are gathered, so every rank holds the same loss vector and
decides the same mask.  The feature and autoencoder passes run whole on
each rank, unless the dataset is sample-sharded (multi-host staging): then
each rank scores its own shard, which is its block of a pass over the
whole set, and the rows are gathered in order; a pass over a subset
brings each batch's rows in through the dataset's exchange, every rank
asking for every rank's rows of the batch.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call

from ..data.pipeline import DeviceDataset, normalize_u8
from ..device import f32_math
from ..kernels.bce import bce_scores
from ..models.autoencoder import reconstruction_errors
from ..obs.profiler import host_read, span
from ..ops import stats as S
from ..parallel import mesh as M
from . import thresholds as TH

FEATURE_DIM = 512  # the ResNet18 trunk's width
RANK_WINDOW = 8  # rank positions re-scored on each side of a decision rank


def _batched(fn: Callable[[torch.Tensor], torch.Tensor], dataset: DeviceDataset,
             out: torch.Tensor, batch_size: int, subset: Optional[torch.Tensor],
             dtype: torch.dtype = torch.float32,
             fetch: Optional[Callable[[int, int], torch.Tensor]] = None) -> torch.Tensor:
    """``fn`` over rows ``[0, len(out))`` of ``dataset`` (or of ``subset``),
    in padded batches, into ``out``; ``fetch(lo, hi)``, when given, brings
    the uint8 rows of each batch instead."""
    n = out.shape[0]
    if fetch is None:
        if subset is None:
            fetch = lambda lo, hi: dataset.images[lo:hi]  # noqa: E731
        else:
            fetch = lambda lo, hi: dataset.gather(subset[lo:hi])  # noqa: E731
    with torch.no_grad(), f32_math():
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            batch = fetch(lo, hi)
            if hi - lo < batch_size:
                pad = batch.new_zeros((batch_size - (hi - lo),) + batch.shape[1:])
                batch = torch.cat([batch, pad])
            out[lo:hi] = fn(normalize_u8(batch, dtype))[:hi - lo]
    return out


def _d_logits_fn(disc: torch.nn.Module, dtype: torch.dtype):
    """Eval-mode D logits at compute type ``dtype``.  For bfloat16 this is
    the JAX package's ``disc.clone(compute_dtype=bfloat16)``
    (`strainer_gan_tpu/models/layers.py:54-66,213-218`): inputs and conv
    kernels in bfloat16, conv outputs bfloat16 (float32 accumulation), the
    BatchNorm coefficients computed in float32 from its float32 parameters
    and applied in bfloat16, the logits cast to float32."""
    if dtype == torch.float32:
        return lambda x: disc(x, train=False)
    kernels = {name: p.to(dtype) for name, p in disc.named_parameters()
               if name.startswith("convs.")}
    return lambda x: functional_call(disc, kernels, (x,), {"train": False})


def _d_losses(disc: torch.nn.Module, dataset: DeviceDataset, real_label: float,
              batch_size: int, subset: Optional[torch.Tensor],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    n = dataset.n if subset is None else subset.shape[0]
    if M.grouped():
        # sharded by rows: each rank scores its block of ceil(n / world)
        # rows (K1 on the block), then the blocks are gathered in order
        m = -(-n // M.world())
        lo = min(M.rank() * m, n)
        hi = min(lo + m, n)
        block = torch.zeros((m,), dtype=torch.float32, device=dataset.device)
        logits = _d_logits_fn(disc, dtype)
        if not dataset.sharded:
            rows = (torch.arange(lo, hi, device=dataset.device) if subset is None
                    else subset[lo:hi])
            _batched(logits, dataset, block[:hi - lo], batch_size, rows, dtype)
        elif subset is None:
            # the rank's block of the whole set is its shard
            if (lo, m) != (dataset.lo, dataset.images.shape[0]):
                raise ValueError(f"rank {M.rank()}'s shard is not its block of {n} rows")
            _batched(logits, dataset.local(), block, batch_size, None, dtype)
        else:
            # every rank's block, padded to m rows: each batch's exchange
            # brings the rank its own rows (every rank runs ceil(m / batch)
            # batches; the padding scores row 0 and falls past n)
            req = torch.zeros((M.world() * m,), dtype=torch.int64, device=dataset.device)
            req[:n] = subset
            req = req.view(M.world(), m)
            _batched(logits, dataset, block, batch_size, None, dtype,
                     fetch=lambda a, b: dataset.batch(req[:, a:b].reshape(-1))[0])
        return M.all_gather(bce_scores(block, real_label, out=block))[:n]
    logits = torch.empty((n,), dtype=torch.float32, device=dataset.device)
    _batched(_d_logits_fn(disc, dtype), dataset, logits, batch_size, subset, dtype)
    return bce_scores(logits, real_label, out=logits)


def score_d_losses(disc: torch.nn.Module, dataset: DeviceDataset,
                   real_label: float = 1.0, batch_size: int = 512,
                   subset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample BCE(D(x), real_label) with D in eval mode (`score.py:78-143`,
    `# final.py:343-356`), in float32.

    ``subset``: optional int64 indices; scores only those samples (the
    reference scores the prefiltered Subset, `# final.py:440-443`) and
    returns scores aligned with it.  The D forward writes its logits into
    one buffer, and ONE launch of the K1 kernel turns the whole buffer
    into losses in place (nothing reads the logits afterwards).
    """
    return _d_losses(disc, dataset, real_label, batch_size, subset)


def score_features(feature_fn: Callable[[torch.Tensor], torch.Tensor],
                   dataset: DeviceDataset, batch_size: int = 512) -> torch.Tensor:
    """(N, 512) float32 ResNet18 features of every sample (`score.py:148-165`,
    `#z_score.py:276-283`); of a sample-sharded dataset, each rank's shard
    scored and the rows gathered in order (a collective)."""
    local = dataset.local()
    feats = torch.empty((local.n, FEATURE_DIM), dtype=torch.float32, device=dataset.device)
    _batched(feature_fn, local, feats, batch_size, None)
    return M.all_gather(feats) if dataset.sharded else feats


def score_ae_errors(ae: torch.nn.Module, dataset: DeviceDataset,
                    batch_size: int = 512) -> torch.Tensor:
    """(N,) float32 per-sample reconstruction MSE of every sample
    (`score.py:371-394`, `#autoencoder.py:307-322`), in float32 with TF32
    off: the errors decide the strain."""
    local = dataset.local()
    errors = torch.empty((local.n,), dtype=torch.float32, device=dataset.device)
    _batched(lambda x: reconstruction_errors(ae(x), x), local, errors, batch_size, None)
    return M.all_gather(errors) if dataset.sharded else errors


def band_capacity(m: int, batch_size: int, band_capacity_frac: float) -> int:
    """The most samples a band may re-score before the pass falls back to
    float32 for all (`score.py:210-211`): ``band_capacity_frac`` of the
    ``m`` scored samples, at least 256, rounded up to whole batches."""
    cap = min(m, max(256, int(m * band_capacity_frac)))
    return -(-cap // batch_size) * batch_size


def fused_percentile_refine(disc: torch.nn.Module, dataset: DeviceDataset, loss_ratio,
                            valid: torch.Tensor, real_label: float = 1.0,
                            batch_size: int = 512, subset: Optional[torch.Tensor] = None,
                            band_eps: float = 0.05, band_capacity_frac: float = 0.0625):
    """The loss-percentile refinement (`# final.py:343-374`) with bfloat16
    bulk scoring and a float32 band (`strainer_gan_tpu/strain/score.py:167-368`).

    The bulk is scored by an eval-mode bfloat16 D forward; one stable argsort
    of those losses (invalid lanes at float32 max, lanes outside ``subset``
    at +inf) estimates the threshold, and every valid sample within
    ``band_eps * max(1, |thr|)`` of it, plus the rank windows [-8, +9]
    around the percentile's lower rank and around ``n_valid // 2`` (the
    empty-keep fallback's cut), is re-scored in float32.
    ``percentile_refine_mask`` then decides on the hybrid scores.  When the
    empty-keep fallback engages, the median's value neighbourhood is
    re-scored too.  When a band holds more than ``band_capacity`` samples,
    every sample is scored in float32 instead.

    Host reads: the band's size (one), then the kept count and the median
    band's size together (one); a third when the median band is re-scored.
    Spans: ``strain.bulk`` (the bfloat16 pass), ``strain.band`` (the
    threshold, the band, its float32 re-score and the decision),
    ``strain.median`` (the median band's re-score) and ``strain.f32`` (the
    fallback).

    Returns ``(mask, thr, scores, band_stats)``: ``scores`` are the hybrid
    losses (+inf outside ``subset``), ``band_stats`` a (3,) float32 tensor
    ``[n_rescored, fell_back_to_f32, max_normalized_drift]`` with drift
    ``|bf16 - f32| / max(1, |f32|)`` over the re-scored samples (0 after a
    fallback; after a band overflow ``n_rescored`` is the band's size).
    """
    n, dev = dataset.n, dataset.device
    m = n if subset is None else int(subset.shape[0])
    cap = band_capacity(m, batch_size, band_capacity_frac)

    def losses(idx, dtype):
        return _d_losses(disc, dataset, real_label, batch_size, idx, dtype)

    def to_full(vals):
        if subset is None:
            return vals
        full = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
        full[subset] = vals
        return full

    def full_f32(n_rescored):
        with span("strain.f32"):
            s = to_full(losses(subset, torch.float32))
            mask, thr = TH.percentile_refine_mask(s, loss_ratio, valid=valid)
            stats = torch.tensor([float(n_rescored), 1.0, 0.0], device=dev)
        return mask, thr, s, stats

    def rescore(base, idx):
        """float32 losses of the samples ``idx`` written over ``base``, and
        their largest normalised distance from ``base``."""
        vals = losses(idx, torch.float32)
        hybrid = base.clone()
        hybrid[idx] = vals
        drift = ((vals - base[idx]).abs() / vals.abs().clamp_min(1.0)).amax() \
            if idx.numel() else torch.zeros((), device=dev)
        return hybrid, drift

    with span("strain.bulk"):
        s_bulk = to_full(losses(subset, torch.bfloat16))
    with span("strain.band"):
        q = (1.0 - torch.tensor(loss_ratio, dtype=torch.float32, device=dev)) * 100.0
        big = torch.tensor(torch.finfo(torch.float32).max, dtype=torch.float32, device=dev)
        masked = torch.where(valid, s_bulk, big)
        order = torch.argsort(masked, stable=True)
        xs = masked[order]
        n_valid = valid.sum()
        pos_lo = torch.floor(q / 100.0 * torch.clamp_min(n_valid - 1, 0)).to(torch.int64)
        thr0 = S.interpolate_sorted(xs, n_valid, q)
        # bf16 rounding is relative to the score, so the band scales with it
        band = valid & ((s_bulk - thr0).abs() <= band_eps * thr0.abs().clamp_min(1.0))
        # a sparse neighbourhood can leave a rank the decision interpolates at
        # (the percentile's, or the fallback's n_valid // 2) outside the
        # eps-band: re-score small rank windows around both
        win = torch.arange(-RANK_WINDOW, RANK_WINDOW + 2, device=dev)
        pos_half = n_valid // 2
        for p in (pos_lo, pos_half):
            band[order[torch.clamp(p + win, 0, n - 1)]] = True
        band &= valid
        with host_read("band"):
            idx = torch.nonzero(band).flatten()
        n_band = idx.numel()
        if n_band > cap:
            return full_f32(n_band)
        s_hybrid, drift = rescore(s_bulk, idx)
        mask, thr = TH.percentile_refine_mask(s_hybrid, loss_ratio, valid=valid)
        # the empty-keep fallback cuts by rank at the median, where bf16 can
        # misorder dense scores: re-score the median's neighbourhood, when used
        m0 = xs[torch.clamp(pos_half, 0, n - 1)]
        band_med = valid & ((s_bulk - m0).abs() <= band_eps * m0.abs().clamp_min(1.0)) & ~band
        with host_read("kept"):
            n_kept, n_med = (int(v) for v in torch.stack([
                (valid & (s_hybrid < thr)).sum(), band_med.sum()]).tolist())
    if n_kept == 0:
        if n_med > cap:
            return full_f32(n_band + n_med)
        with span("strain.median"):
            with host_read("band"):
                med = torch.nonzero(band_med).flatten()
            s_hybrid, d_med = rescore(s_hybrid, med)
            drift = torch.maximum(drift, d_med)
            mask, thr = TH.percentile_refine_mask(s_hybrid, loss_ratio, valid=valid)
        n_band += n_med
    stats = torch.stack([torch.tensor(float(n_band), device=dev),
                         torch.zeros((), device=dev), drift.to(torch.float32)])
    return mask, thr, s_hybrid, stats
