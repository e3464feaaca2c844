"""Evaluation after or during training (counterpart of
`strainer_gan_tpu/eval/suite.py:28-140`).

``generate_samples`` draws images from the trained G in eval mode (its
BatchNorms on their running statistics).  ``evaluate_run`` computes the
suite's FID against the clean reals (``source_id == 0``, the first
``n_samples``) and, when at least two exist, against the contaminants:
the `# 1,2,8.py:333-359` periodic FID (L2-normalised activations with
``fid_normalize_activations``) and the FID of `#strainer gan.py:674-680`.
The suite's feature distance and Wasserstein distance (ResNet50 features,
`eval/distances.py`) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import ExperimentConfig
from ..data.pipeline import DeviceDataset, normalize_u8
from ..train.steps import autocast
from .fid import calculate_fid

SAMPLE_SEED = 1234  # the JAX package's default key, PRNGKey(1234)


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


def evaluate_run(cfg: ExperimentConfig, gen: torch.nn.Module, dataset: DeviceDataset,
                 n_samples: int = 500) -> Dict[str, float]:
    ev = cfg.eval
    if ev.feature_distance or ev.wasserstein:
        raise NotImplementedError("the suite's feature and Wasserstein distances "
                                  "(ResNet50, eval/distances.py) are not ported yet")
    generator = torch.Generator(device=dataset.device).manual_seed(SAMPLE_SEED)
    image_shape = ((cfg.model.nc, cfg.data.image_size, cfg.data.image_size)
                   if cfg.model.arch == "mlp" else None)
    fakes = generate_samples(gen, n_samples, cfg.model.nz, generator, image_shape,
                             compute_dtype=cfg.model.compute_dtype)
    src = dataset.source_id
    clean_idx = torch.nonzero(src == 0).flatten()[:n_samples]
    contam_idx = torch.nonzero(src != 0).flatten()[:n_samples]
    out: Dict[str, float] = {}
    if ev.fid:
        reals = normalize_u8(dataset.gather(clean_idx), torch.float32)
        out["fid_real"] = calculate_fid(reals, fakes, batch_size=min(50, n_samples),
                                        normalize=ev.fid_normalize_activations)
        if contam_idx.shape[0] >= 2:
            contams = normalize_u8(dataset.gather(contam_idx), torch.float32)
            out["fid_contaminant"] = calculate_fid(
                contams, fakes, batch_size=min(50, contam_idx.shape[0]),
                normalize=ev.fid_normalize_activations)
    return out
