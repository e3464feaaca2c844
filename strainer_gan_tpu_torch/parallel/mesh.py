"""Data parallelism over ranks (counterpart of
`strainer_gan_tpu/parallel/mesh.py:57-106`).

The JAX package runs one global program over a ``dp`` mesh: state and
dataset replicated, the batch axis sharded, every statistic taken over the
global batch.  The port runs the same global step with one process per
card (``parallel.multihost``): each rank holds the state and the dataset,
takes its lanes of each global batch (``lanes``), and the step's explicit
collectives make every statistic global:

* ``all_reduce_sum``: a sum over ranks whose backward all-reduces the
  incoming gradient (each rank's loss is its share of the global loss, so
  a statistic's gradient is the sum of the ranks' gradients);
* ``all_gather``: per-sample vectors of the global batch, in rank order;
* ``sync_grads``: one flat bucket of a module's gradients all-reduced
  before Adam, so every rank applies the same update.

The BatchNorms and loss means reduce over ranks only inside
``batch_sharded()`` (the train step); elsewhere (the fixed-noise grids,
the eval-mode scoring passes) a module computes on what its rank holds.
Without a process group every helper is the identity.
"""
from __future__ import annotations

import contextlib
from typing import Iterable

import torch
import torch.distributed as dist

from .multihost import grouped, is_primary, rank, world

_SHARDED = [False]


@contextlib.contextmanager
def batch_sharded():
    """Inside the block (under a process group) the train step's batch is
    sharded over the ranks: BatchNorm statistics and loss means are global."""
    prev = _SHARDED[0]
    _SHARDED[0] = grouped()
    try:
        yield
    finally:
        _SHARDED[0] = prev


def sharded() -> bool:
    return _SHARDED[0]


def lanes(t: torch.Tensor, dim: int = 0, blocks: int = 1) -> torch.Tensor:
    """The rank's lanes of a global-batch tensor along ``dim``: of each of
    ``blocks`` equal blocks (a pooled fake batch is two: generated, then
    pool lanes), the rank's contiguous share, concatenated."""
    if not grouped():
        return t
    n = t.shape[dim] // blocks
    b, r = n // world(), rank()
    parts = [t.narrow(dim, k * n + r * b, b) for k in range(blocks)]
    return parts[0] if blocks == 1 else torch.cat(parts, dim)


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over ranks of a tensor outside autograd; returns it."""
    if grouped():
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over ranks, differentiable; the identity without a group."""
    if not grouped():
        return t
    return _AllReduceSum.apply(t)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors concatenated along dim 0, in rank order."""
    if not grouped():
        return t
    src = t.contiguous()
    if src.dtype == torch.bool:
        return all_gather(src.to(torch.uint8)).to(torch.bool)
    if dist.get_backend() == "nccl":
        out = src.new_empty((world() * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src)
        return out
    parts = [torch.empty_like(src) for _ in range(world())]
    dist.all_gather(parts, src)
    return torch.cat(parts)


def sync_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum each parameter's gradient over ranks, through one flat bucket."""
    if not grouped():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    o = 0
    for g in grads:
        g.copy_(flat[o:o + g.numel()].view_as(g))
        o += g.numel()


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` as rank ``src`` holds it, on every rank (in place); returns it."""
    if not grouped():
        return t
    if t.dtype == torch.bool:
        u = t.to(torch.uint8)
        dist.broadcast(u, src)
        t.copy_(u.to(torch.bool))
        return t
    dist.broadcast(t, src)
    return t


def from_primary(fn, *likes: torch.Tensor):
    """``fn()``'s tensors as rank 0 computes them, on every rank: a decision
    made once (a GMM fit) and broadcast.  ``likes`` give the other ranks
    the outputs' shapes and types."""
    if not grouped():
        return fn()
    outs = fn() if is_primary() else tuple(torch.empty_like(x) for x in likes)
    return tuple(broadcast(o.contiguous()) for o in outs)


__all__ = ["all_gather", "all_reduce_", "all_reduce_sum", "batch_sharded", "broadcast",
           "from_primary", "grouped", "is_primary", "lanes", "rank",
           "sharded", "sync_grads", "world"]
