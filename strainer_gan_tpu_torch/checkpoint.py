"""Checkpoint and resume (counterpart of `strainer_gan_tpu/checkpoint.py`).

The JAX package's layout and semantics, with ``torch.save`` in place of
orbax: under the checkpoint directory, ``epoch_N/state.pt`` holds G and D
(parameters and BatchNorm buffers), both Adam states, the strain masks
(``active``, ``base_active``, ``last_mask``), the last strain's scores, the
autoencoder strainer's weights once trained (``ae``), a pool config's fake
pool (``fake_pool``; restored into the Trainer's pool tensor in place, so
its captured graphs stay valid) and the Trainer's ``torch.Generator``
states, the dropout masks' among them (the JAX package stores its PRNG
key); ``config.json`` the config; ``meta_epoch_N.json`` that epoch's
metadata (``d_bn_eval``, ``iters``, ``band_cooloff``, ...), with the same
keys as the JAX package's; ``meta.json`` the latest epoch's.  Enough to
resume with the same masks and losses as an uninterrupted run.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch

from .parallel.multihost import is_primary


def save_checkpoint(path: str, trainer, epoch: int) -> str:
    """Save the trainer's state at an epoch boundary; returns the directory.
    Under a process group only rank 0 writes (every rank holds the same
    state)."""
    path = os.path.abspath(path)
    if not is_primary():
        return path
    eng = trainer.engine
    payload = dict(
        gen=trainer.gen.state_dict(), disc=trainer.disc.state_dict(),
        opt_g=trainer.opt_g.state_dict(), opt_d=trainer.opt_d.state_dict(),
        active=eng.active, base_active=eng.base_active,
        rng=trainer.rng.get_state(), pool_rng=trainer.pool_rng.get_state(),
        drop_rng=trainer.drop_rng.get_state(), epoch=epoch,
    )
    if trainer.fake_pool is not None:
        payload["fake_pool"] = trainer.fake_pool  # the JAX package's ``pool``
        payload["fake_pool_rows"] = trainer.fake_pool_rows
    if eng.last_mask is not None:
        # a one-shot strainer never strains again: without its mask a resume
        # would train on strained-out samples
        payload["last_mask"] = eng.last_mask
    if eng.last_scores is not None:
        # the decision's evidence, for a resumed --parity-check
        payload["last_scores"] = eng.last_scores
    if eng.ae is not None:
        # the AE trains once, at ae_train_epoch: a resume past it without
        # these weights would never strain again
        payload["ae"] = eng.ae.state_dict()
    os.makedirs(os.path.join(path, f"epoch_{epoch}"), exist_ok=True)
    torch.save(payload, os.path.join(path, f"epoch_{epoch}", "state.pt"))
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(trainer.cfg.to_json())
    meta = dict(
        epoch=epoch,
        d_bn_eval=eng.d_bn_eval,
        iters=trainer._iters,
        has_ae=eng.ae is not None,
        has_last_mask=eng.last_mask is not None,
        has_last_scores=eng.last_scores is not None,
        last_threshold=None if eng.last_threshold is None else float(eng.last_threshold),
        band_cooloff=eng.band_cooloff,
    )
    # the metadata travels with its epoch; meta.json is the latest view
    for name in (f"meta_epoch_{epoch}.json", "meta.json"):
        with open(os.path.join(path, name), "w") as f:
            json.dump(meta, f)
    return path


def restore_checkpoint(path: str, trainer, epoch: Optional[int] = None) -> int:
    """Restore into a trainer built from the same config (after its
    ``setup()``); returns the epoch to resume from.  Without ``epoch``, the
    latest saved one; an explicit earlier epoch reads that epoch's meta.

    The modules load in place, but each optimizer's ``load_state_dict``
    replaces its state tensors and its rate: its post-hook makes the
    Trainer drop every captured chunk, which would otherwise go on
    training the old tensors."""
    path = os.path.abspath(path)
    if epoch is None:
        epoch = max(int(d.split("_", 1)[1]) for d in os.listdir(path)
                    if d.startswith("epoch_"))
    meta = {}
    for name in (f"meta_epoch_{epoch}.json", "meta.json"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            with open(p) as f:
                meta = json.load(f)
            break
    payload = torch.load(os.path.join(path, f"epoch_{epoch}", "state.pt"),
                         map_location=trainer.device, weights_only=True)
    trainer.gen.load_state_dict(payload["gen"])
    trainer.disc.load_state_dict(payload["disc"])
    trainer.opt_g.load_state_dict(payload["opt_g"])
    trainer.opt_d.load_state_dict(payload["opt_d"])
    trainer.rng.set_state(payload["rng"].cpu())
    for name in ("pool_rng", "drop_rng"):
        if name in payload:
            getattr(trainer, name).set_state(payload[name].cpu())
    if "fake_pool" in payload:
        trainer.fake_pool_rows = payload["fake_pool_rows"]
        saved = payload["fake_pool"]
        if trainer.fake_pool is not None and trainer.fake_pool.shape == saved.shape:
            trainer.fake_pool.copy_(saved)  # in place: a captured graph reads this tensor
        else:
            trainer.fake_pool = saved
            trainer.drop_captures()
    eng = trainer.engine
    eng.active = payload["active"]
    # rebuilds the compacted scoring subset of the base too
    eng._set_base(payload["base_active"])
    if meta.get("has_ae"):
        eng.ae = eng.build_ae()  # the module, around the saved weights
        eng.ae.load_state_dict(payload["ae"])
    if meta.get("has_last_mask"):
        eng.last_mask = payload["last_mask"]
    if meta.get("has_last_scores"):
        eng.last_scores = payload["last_scores"]
    if meta.get("last_threshold") is not None:
        eng.last_threshold = torch.tensor(meta["last_threshold"], dtype=torch.float32,
                                          device=trainer.device)
    eng.band_cooloff = meta.get("band_cooloff", 0)
    eng.d_bn_eval = meta.get("d_bn_eval", False)
    trainer._iters = meta.get("iters", 0)
    return epoch + 1
