"""Evaluation after or during training (counterpart of
`strainer_gan_tpu/eval/suite.py:28-140`).

``generate_samples`` draws images from the trained G in eval mode (its
BatchNorms on their running statistics).  ``evaluate_run`` computes, as
`strainer_gan_tpu/eval/suite.py:87-139` does, against the clean reals
(``source_id == 0``, the first ``n_samples``) and against the
contaminants (the first ``n_samples``):

* with ``feature_distance`` / ``wasserstein``, the mean ResNet50 feature
  distance and the PCA-50 Wasserstein distance (`#strainer gan.py:637-680`,
  ``eval/distances.py``) over ResNet50 features of the reals, the fakes
  and, when at least one exists, the contaminants (every image, the tail
  batch padded; grayscale repeated to three channels);
* with ``fid``, the FID against the reals and, when at least two
  contaminants exist, against them: the `# 1,2,8.py:333-359` periodic FID
  (L2-normalised activations with ``fid_normalize_activations``) and the
  FID of `#strainer gan.py:674-680`.

A 1-channel config (the MNIST MLPs) with either distance on is refused:
the JAX suite builds a 1-channel ResNet50 and then feeds it images
repeated to three channels, which flax rejects (``ScopeParamShapeError``,
`strainer_gan_tpu/eval/suite.py:93-96`), so the reference gives no value
to match.  Each call appends to ``calls`` the host seconds of its feature
passes and of its distances (each synchronised on the card).

On a sample-sharded dataset (multi-host staging) the rows the suite reads
come in through the dataset's exchange, which every rank must enter:
``eval_rows`` gathers them on every rank into a dataset of their own, on
which rank 0's ``evaluate_run`` picks the same rows.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from ..config import ExperimentConfig
from ..data.pipeline import DeviceDataset, normalize_u8
from ..models.features import build_feature_fn
from ..train.steps import autocast
from .distances import mean_feature_distance, pca_wasserstein_distance
from .fid import _sync, batched_feature_pass, calculate_fid

SAMPLE_SEED = 1234  # the JAX package's default key, PRNGKey(1234)
calls: List[Dict] = []


def generate_samples(gen: torch.nn.Module, n: int, nz: int, generator: torch.Generator,
                     image_shape=None, batch: int = 100,
                     compute_dtype: str = "float32") -> torch.Tensor:
    """``n`` images (N, C, H, W) float32 from eval-mode G, ``batch`` at a time
    (a ragged tail batch is generated whole and cut); MLP rows are reshaped
    to ``image_shape`` (C, H, W)."""
    dev = next(gen.parameters()).device
    outs = []
    with torch.no_grad():
        for i in range(-(-n // batch)):
            z = torch.randn((batch, nz), generator=generator, device=dev)
            with autocast(z, compute_dtype):
                img = gen(z, train=False)
            img = img.to(torch.float32)[:min(batch, n - i * batch)]
            if img.dim() == 2 and image_shape is not None:
                img = img.reshape((img.shape[0],) + tuple(image_shape))
            outs.append(img)
    return torch.cat(outs)


def check_config(cfg: ExperimentConfig) -> None:
    """Refuse what the reference cannot compute: the ResNet50 distances of
    a config that is not 3-channel."""
    ev = cfg.eval
    if (ev.feature_distance or ev.wasserstein) and cfg.model.nc != 3:
        raise ValueError(
            f"the eval suite's ResNet50 distances on a {cfg.model.nc}-channel config: the "
            "reference builds a 1-channel ResNet50 and feeds it images repeated to 3 "
            "channels, which flax rejects (ScopeParamShapeError, "
            "strainer_gan_tpu/eval/suite.py:93-96), so there is no value to match; turn "
            "feature_distance and wasserstein off")


def eval_rows(dataset: DeviceDataset, n_samples: int) -> DeviceDataset:
    """What ``evaluate_run`` reads of ``dataset``: the dataset itself, or of
    a sample-sharded one (on every rank: a collective) its first
    ``n_samples`` clean and first ``n_samples`` contaminant rows, in dataset
    order, gathered into a dataset of their own."""
    if not dataset.sharded:
        return dataset
    src = dataset.all_source_ids()
    idx = torch.cat([torch.nonzero(src == 0).flatten()[:n_samples],
                     torch.nonzero(src != 0).flatten()[:n_samples]]).sort().values
    return DeviceDataset.from_tensors(dataset.gather(idx), src[idx], dataset.device)


def evaluate_run(cfg: ExperimentConfig, gen: torch.nn.Module, dataset: DeviceDataset,
                 n_samples: int = 500, feature_name: str = "resnet50") -> Dict[str, float]:
    check_config(cfg)
    ev = cfg.eval
    distances = ev.feature_distance or ev.wasserstein
    generator = torch.Generator(device=dataset.device).manual_seed(SAMPLE_SEED)
    image_shape = ((cfg.model.nc, cfg.data.image_size, cfg.data.image_size)
                   if cfg.model.arch == "mlp" else None)
    fakes = generate_samples(gen, n_samples, cfg.model.nz, generator, image_shape,
                             compute_dtype=cfg.model.compute_dtype)
    src = dataset.source_id
    clean_idx = torch.nonzero(src == 0).flatten()[:n_samples]
    contam_idx = torch.nonzero(src != 0).flatten()[:n_samples]
    out: Dict[str, float] = {}
    reals = normalize_u8(dataset.gather(clean_idx), torch.float32)
    if distances:
        ffn = build_feature_fn(feature_name, 3, dataset.device)

        def feats(x):
            # eval-mode BatchNorm: a feature does not depend on its batch
            return batched_feature_pass(x, ffn, batch_size=min(256, x.shape[0]),
                                        keep_all=True)

        t0 = time.perf_counter()
        rf, gf = feats(reals), feats(fakes)
        cf = (feats(normalize_u8(dataset.gather(contam_idx), torch.float32))
              if contam_idx.shape[0] else None)
        _sync(dataset.device)
        t1 = time.perf_counter()
        for tag, f in (("real", rf), ("contaminant", cf)):
            if f is None:
                continue
            if ev.feature_distance:
                out[f"feature_distance_{tag}"] = float(mean_feature_distance(f, gf))
            if ev.wasserstein:
                out[f"wasserstein_{tag}"] = float(pca_wasserstein_distance(f, gf))
        calls.append(dict(features_s=t1 - t0, distances_s=time.perf_counter() - t1,
                          n=(rf.shape[0], gf.shape[0], 0 if cf is None else cf.shape[0])))
    if ev.fid:
        out["fid_real"] = calculate_fid(reals, fakes, batch_size=min(50, n_samples),
                                        normalize=ev.fid_normalize_activations)
        if contam_idx.shape[0] >= 2:
            contams = normalize_u8(dataset.gather(contam_idx), torch.float32)
            out["fid_contaminant"] = calculate_fid(
                contams, fakes, batch_size=min(50, contam_idx.shape[0]),
                normalize=ev.fid_normalize_activations)
    return out
