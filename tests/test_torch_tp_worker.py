"""One rank of the port's dp x tp checks (tests/test_torch_tp.py).

``run_rank`` joins a gloo group of ``dp * tp`` ranks, lays them out with
``parallel.mesh.make_mesh_2d``, places tests/test_torch_dp_worker.py's
narrow ``basic`` state with ``put_state_tp`` and runs one step on the
rank's lanes of the batch the test wrote (``inputs.pt``) inside the grid.
It saves to ``out_<tag>_<rank>.pt`` the metrics, the rank's shards and the
whole state gathered again over the tp group.  It imports no JAX and holds
no test of its own.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

import test_torch_dp_worker as DW

TIMEOUT_S = 60


def modules_and_config(inputs):
    from strainer_gan_tpu_torch import get_preset
    from strainer_gan_tpu_torch.train.steps import step_config_from

    cfg = DW.tiny(get_preset("basic"))
    return (*DW.modules(cfg, inputs), step_config_from(cfg))


def step(inputs, grid=None) -> dict:
    """One ``basic`` step from ``inputs`` (inside ``grid``, on a state placed
    by ``put_state_tp``; without one, as the replicated path runs it)."""
    import contextlib

    from strainer_gan_tpu_torch.data import normalize_u8
    from strainer_gan_tpu_torch.parallel import mesh as M
    from strainer_gan_tpu_torch.train.steps import rank_inputs, train_step

    gen, disc, opt_g, opt_d, scfg = modules_and_config(inputs)
    if grid is not None:
        placement = placement_of(gen, disc, grid.tp)
        M.put_state_tp(grid, [gen, disc], [opt_g, opt_d])
    with grid if grid is not None else contextlib.nullcontext():
        rid, rz, _, _ = rank_inputs(scfg, torch.arange(inputs["batch"].shape[0]), inputs["z"])
        m = train_step(gen, disc, opt_g, opt_d, normalize_u8(inputs["batch"][rid]),
                       inputs["src"][rid], rz, inputs["lr"], inputs["lr"], scfg)
    shards = DW.state_of(gen, disc, opt_g, opt_d)
    out = dict(metrics={k: v.detach().clone() for k, v in m.items()}, shards=shards)
    if grid is not None:
        out["state"] = whole(grid, placement, shards)
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


def run_rank(rank: int, dp: int, tp: int, port: int, tmp: str, tag: str) -> None:
    from strainer_gan_tpu_torch.parallel.mesh import make_mesh_2d

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=dp * tp, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        grid = make_mesh_2d(dp, tp)
        out = dict(coords=(grid.d, grid.t), step=step(inputs, grid))
        torch.save(out, os.path.join(tmp, f"out_{tag}_{rank}.pt"))
    finally:
        dist.destroy_process_group()
