"""Serving path (counterpart of `strainer_gan_tpu/serve.py:26-75`).

``Sampler`` wraps a trained generator (live weights or a checkpoint
directory) behind a fixed-batch-size sampling function: device-resident
weights, uint8 NHWC images ready for encoding.  On the card one batch is
one CUDA graph replay, the counterpart of the JAX package's jit: the
first batch runs eagerly (its warm-up), the second captures the batch,
and every later one copies its noise into the graph's static input and
replays it.  A capture or replay that fails raises.

    sampler = Sampler.from_checkpoint("runs/final/ckpt")
    imgs = sampler.sample(64, seed=0)            # (64, 64, 64, 3) uint8
    grid = sampler.sample_grid(64)               # PNG-ready grid array
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .config import ExperimentConfig
from .device import resolve_device
from .models import build_models
from .obs.images import make_grid
from .train.steps import autocast, capturing


def _batch_seed(seed: int, i: int) -> int:
    """A 63-bit seed for batch ``i`` of ``sample(n, seed)`` (the JAX
    package folds ``i`` into the key of ``seed``)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0] >> 1)


class Sampler:
    def __init__(self, cfg: ExperimentConfig, gen_state: Dict[str, torch.Tensor],
                 batch_size: int = 64, device=None):
        """``gen_state``: G's ``state_dict`` (parameters and BatchNorm
        running statistics)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        gen, _ = build_models(cfg.model, seed=cfg.train.seed)
        gen.load_state_dict(gen_state)
        self.gen = gen.to(self.device)
        self.batch_size = batch_size
        self._z = torch.zeros((batch_size, cfg.model.nz), dtype=torch.float32,
                              device=self.device)
        self._out = None
        self._graph = None
        self.replays = 0

    @classmethod
    def from_checkpoint(cls, path: str, epoch: Optional[int] = None, batch_size: int = 64,
                        device=None) -> "Sampler":
        """From ``checkpoint.save_checkpoint``'s directory: ``config.json``
        and ``epoch_N/state.pt`` (the newest epoch without ``epoch``)."""
        with open(os.path.join(path, "config.json")) as f:
            cfg = ExperimentConfig.from_json(f.read())
        if epoch is None:
            epoch = max(int(d.split("_", 1)[1]) for d in os.listdir(path)
                        if d.startswith("epoch_"))
        dev = resolve_device(device)
        payload = torch.load(os.path.join(path, f"epoch_{epoch}", "state.pt"),
                             map_location=dev, weights_only=True)
        return cls(cfg, payload["gen"], batch_size, dev)

    def _sample_batch(self, z: torch.Tensor) -> torch.Tensor:
        """(batch, nz) noise -> (batch, H, W, C) uint8: G in eval mode (its
        BatchNorms on their running statistics), the MLP's rows reshaped to
        images (`strainer_gan_tpu/serve.py:60-62`), ``(x + 1) * 127.5``
        clipped to [0, 255] and truncated."""
        with torch.no_grad(), autocast(z, self.cfg.model.compute_dtype):
            imgs = self.gen(z, train=False)
        imgs = imgs.to(torch.float32)
        if imgs.dim() == 2:
            s = self.cfg.data.image_size
            imgs = imgs.reshape(-1, s, s, self.cfg.model.nc)
        else:
            imgs = imgs.permute(0, 2, 3, 1)
        return torch.clamp((imgs + 1.0) * 127.5, 0, 255).to(torch.uint8)

    def _run(self, z: torch.Tensor) -> torch.Tensor:
        self._z.copy_(z)
        if self.device.type != "cuda":
            return self._sample_batch(self._z)
        if self._out is None:
            self._out = self._sample_batch(self._z)  # warm-up, eagerly
            return self._out.clone()
        if self._graph is None:
            graph = torch.cuda.CUDAGraph()
            with capturing(graph):
                self._out = self._sample_batch(self._z)
            self._graph = graph
        self._graph.replay()
        self.replays += 1
        return self._out.clone()

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` uint8 NHWC images, batch by batch; batch ``i``'s noise comes
        from a CPU ``torch.Generator`` seeded from (``seed``, ``i``)."""
        outs = []
        for i in range(-(-n // self.batch_size)):
            g = torch.Generator().manual_seed(_batch_seed(seed, i))
            z = torch.randn((self.batch_size, self.cfg.model.nz), generator=g)
            outs.append(self._run(z).cpu().numpy())
        return np.concatenate(outs)[:n]

    def sample_grid(self, n: int = 64, seed: int = 0, nrow: int = 8) -> np.ndarray:
        imgs = self.sample(n, seed).astype(np.float32) / 255.0
        return make_grid(imgs, nrow=nrow, normalize=False)
