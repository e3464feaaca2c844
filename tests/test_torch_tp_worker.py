"""One rank of the port's dp x tp checks (tests/test_torch_tp.py,
tests/test_torch_tp_variants.py).

``run_rank`` joins a gloo group of ``dp * tp`` ranks, lays them out with
``parallel.mesh.make_mesh_2d``, places tests/test_torch_dp_worker.py's
narrow ``basic`` state with ``put_state_tp`` and runs one step on the
rank's lanes of the batch the test wrote (``inputs.pt``) inside the grid.
It saves to ``out_<tag>_<rank>.pt`` the metrics, the rank's shards and the
whole state gathered again over the tp group.

``run_variants_rank`` does the same for each step variant of ``VARIANTS``
(the in-step keep, on a full batch and on a partial tail, recycling, the
pool, the MLP's G-first and dropout steps), one step each from the
variant's own inputs, and with ``chunk`` also ``chunk_runs``: ``CHUNK``
masked steps one by one, then through one ``ChunkedStep`` and one
``GatedChunkedStep`` on a sample-sharded copy of the dataset.  It imports
no JAX and holds no test of its own.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

import test_torch_dp_worker as DW

TIMEOUT_S = 60
TAIL, CHUNK, N_IMAGES = 11, 4, 64
# variant -> (preset, the step's gates); each step of the in-step keep and
# of recycling has its keep on, the pool its gate
VARIANTS = {
    "batch_mask": ("batch_mask", dict(mask_on=True)),
    "batch_mask_tail": ("batch_mask", dict(mask_on=True, lane_count=TAIL)),
    "in_batch_recycle": ("in_batch_recycle", dict(mask_on=True)),
    "pool": ("strainer_concat_fast", dict(concat_on=True)),
    "mnist8": ("mnist8", {}),
    "mnist_full": ("mnist_full", {}),
}


def variant_config(preset: str):
    """``preset`` at batch 16 in float32, the DCGAN at width 8 (the MLP at
    its published widths)."""
    from strainer_gan_tpu_torch import get_preset

    return DW.tiny(get_preset(preset))


def modules_and_config(inputs, preset: str = "basic"):
    """G, D, their optimizers and the StepConfig of ``preset``, G and D
    loaded from ``inputs``."""
    from strainer_gan_tpu_torch.models import build_models
    from strainer_gan_tpu_torch.train.state import make_optimizers
    from strainer_gan_tpu_torch.train.steps import step_config_from

    cfg = variant_config(preset)
    gen, disc = build_models(cfg.model)
    gen.load_state_dict(inputs["gen"])
    disc.load_state_dict(inputs["disc"])
    return gen, disc, *make_optimizers(cfg, gen, disc), step_config_from(cfg)


def _grid_ctx(grid):
    import contextlib

    return grid if grid is not None else contextlib.nullcontext()


def _placed(gen, disc, opt_g, opt_d, grid):
    """The state placed on ``grid`` by ``put_state_tp``; the placement."""
    from strainer_gan_tpu_torch.parallel import mesh as M

    if grid is None:
        return None
    placement = placement_of(gen, disc, grid.tp)
    M.put_state_tp(grid, [gen, disc], [opt_g, opt_d])
    return placement


def _result(m, gen, disc, opt_g, opt_d, grid, placement) -> dict:
    shards = DW.state_of(gen, disc, opt_g, opt_d)
    out = dict(metrics={k: v.detach().clone() for k, v in m.items()}, shards=shards)
    if grid is not None:
        out["state"] = whole(grid, placement, shards)
    return out


def step(inputs, grid=None, variant: str = "basic") -> dict:
    """One step of ``variant`` (``basic`` or a key of ``VARIANTS``) from
    ``inputs``: the weights and the global step's draws (batch, source
    ids, noise; pool rows, keep masks).  Inside ``grid``, on a state placed
    by ``put_state_tp``; without one, as the replicated path runs it."""
    from strainer_gan_tpu_torch.data import normalize_u8
    from strainer_gan_tpu_torch.train.steps import rank_inputs, train_step

    preset, gates = VARIANTS.get(variant, (variant, {}))
    gen, disc, opt_g, opt_d, scfg = modules_and_config(inputs, preset)
    placement = _placed(gen, disc, opt_g, opt_d, grid)
    kw = dict(gates)
    with _grid_ctx(grid):
        rid, rz, rpool, rdrop = rank_inputs(scfg, torch.arange(inputs["batch"].shape[0]),
                                            inputs["z"], inputs.get("pool_idx"),
                                            inputs.get("drop"))
        if scfg.pool_concat:
            kw.update(fake_pool=inputs["pool"], pool_idx=rpool)
        m = train_step(gen, disc, opt_g, opt_d, normalize_u8(inputs["batch"][rid]),
                       inputs["src"][rid], rz, inputs["lr"], inputs["lr"], scfg,
                       drop_masks=rdrop, **kw)
    return _result(m, gen, disc, opt_g, opt_d, grid, placement)


def chunk_runs(inputs, grid=None) -> dict:
    """``batch_mask`` with the keep on from ``inputs["batch_mask"]``'s
    weights: ``CHUNK`` steps one by one on the replicated dataset
    (``steps``; ``after_gated``: the state after the first ``CHUNK - 1``),
    then from the same state ``CHUNK`` steps through one ``ChunkedStep``
    (``chunked``) and ``CHUNK - 1`` live steps of a ``GatedChunkedStep`` of
    ``CHUNK`` (``gated``), both on a copy of the dataset staged by
    ``from_rank_local`` (each rank's shard of the rows: its lanes come in
    through the exchange), all inside ``grid``."""
    import numpy as np

    from strainer_gan_tpu_torch.data import DeviceDataset, Mixture, normalize_u8
    from strainer_gan_tpu_torch.parallel import mesh as M
    from strainer_gan_tpu_torch.train.steps import (ChunkedStep, GatedChunkedStep,
                                                    rank_inputs, train_step)

    c = inputs["chunk"]
    images, src, idx, z, lr = c["images"], c["src"], c["idx"], c["z"], inputs["batch_mask"]["lr"]
    ds = DeviceDataset(Mixture(images.numpy(), src.numpy(), np.zeros(len(src), np.int64)), "cpu")
    n_local = N_IMAGES // M.world() if M.grouped() else N_IMAGES
    lo = M.rank() * n_local if M.grouped() else 0
    sharded = DeviceDataset.from_rank_local(
        Mixture(images[lo:lo + n_local].numpy(), src[lo:lo + n_local].numpy(),
                np.zeros(n_local, np.int64)), N_IMAGES, "cpu")
    out = {}
    with _grid_ctx(grid):
        gen, disc, opt_g, opt_d, scfg = modules_and_config(inputs["batch_mask"], "batch_mask")
        placement = _placed(gen, disc, opt_g, opt_d, grid)
        ms = []
        for j in range(CHUNK):
            u8, s = ds.batch(idx[j])
            _, rz, _, _ = rank_inputs(scfg, idx[j], z[j])
            ms.append(train_step(gen, disc, opt_g, opt_d, normalize_u8(u8), s, rz, lr, lr, scfg,
                                 mask_on=True))
            if j == CHUNK - 2:
                out["after_gated"] = _result(ms[-1], gen, disc, opt_g, opt_d, grid,
                                             placement)["shards"]
        out["steps"] = _result({k: torch.stack([m[k] for m in ms]) for k in ms[0]},
                               gen, disc, opt_g, opt_d, grid, placement)
        stats = dict(captures=0, replays=0, capture_s=[], instantiate_s=[],
                     conditional_nodes=0, gated_replays=0)
        for name, cls, extra in (("chunked", ChunkedStep, ()),
                                 ("gated", GatedChunkedStep,
                                  (0, torch.tensor(CHUNK - 1)))):
            gen, disc, opt_g, opt_d, scfg = modules_and_config(inputs["batch_mask"], "batch_mask")
            placement = _placed(gen, disc, opt_g, opt_d, grid)
            ex = cls(gen, disc, opt_g, opt_d, sharded, scfg, CHUNK, ms[0], mask_on=True,
                     d_train=True, stats=stats)
            m = ex(idx, z, lr, lr, *extra)
            out[name] = _result(m, gen, disc, opt_g, opt_d, grid, placement)
    return out


def placement_of(gen, disc, tp: int) -> dict:
    """``tp_placement`` keyed as ``DW.state_of`` keys the state: each
    parameter's Adam moments are placed as the parameter."""
    from strainer_gan_tpu_torch.parallel.mesh import tp_placement

    out = {}
    for name, module in (("G", gen), ("D", disc)):
        for k, dim in tp_placement(module, tp).items():
            out[f"{name}.{k}"] = dim
            out[f"{name}.mu.{k}"] = out[f"{name}.nu.{k}"] = dim
    return out


def whole(grid, placement: dict, shards: dict) -> dict:
    """Every shard gathered over the tp group along its placed dim."""
    out = {}
    for k, t in shards.items():
        dim = placement.get(k)
        if dim is None:
            out[k] = t.clone()
            continue
        parts = [torch.empty_like(t) for _ in range(grid.tp)]
        dist.all_gather(parts, t.contiguous(), group=grid.tp_group)
        out[k] = torch.cat(parts, dim)
    return out


def run_rank(rank: int, dp: int, tp: int, tmp: str, tag: str) -> None:
    _in_group(rank, dp, tp, tmp, tag,
              lambda inputs, grid: dict(step=step(inputs, grid)))


def variant_runs(inputs, grid=None, chunk: bool = False) -> dict:
    """``step`` of every variant (and ``chunk_runs`` with ``chunk``)."""
    out = {v: step(inputs[v], grid, v) for v in VARIANTS}
    if chunk:
        out["chunk"] = chunk_runs(inputs, grid)
    return out


def run_variants_rank(rank: int, dp: int, tp: int, tmp: str, tag: str, chunk: bool) -> None:
    _in_group(rank, dp, tp, tmp, tag,
              lambda inputs, grid: variant_runs(inputs, grid, chunk))


def _in_group(rank, dp, tp, tmp, tag, fn) -> None:
    """``fn(inputs, grid)`` as ``rank`` of the gloo group of its launcher's
    environment (tests/test_torch_ranks.py), laid out as a dp x tp grid, with
    the grid's coordinates, saved to ``out_<tag>_<rank>.pt``."""
    from strainer_gan_tpu_torch.parallel import multihost as MH
    from strainer_gan_tpu_torch.parallel.mesh import make_mesh_2d

    torch.set_num_threads(1)
    assert MH.initialize("cpu", timeout_s=TIMEOUT_S) and MH.world() == dp * tp
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        grid = make_mesh_2d(dp, tp)
        out = dict(coords=(grid.d, grid.t), **fn(inputs, grid))
        torch.save(out, os.path.join(tmp, f"out_{tag}_{rank}.pt"))
    finally:
        MH.shutdown()
