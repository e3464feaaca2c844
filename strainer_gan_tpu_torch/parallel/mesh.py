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

``exchange`` serves a sample-sharded dataset (multi-host staging,
``data.pipeline.DeviceDataset.from_rank_local``): every rank writes the
rows of a request it owns and zeros elsewhere, and one sum over ranks
gives each rank the rows (a reduce-scatter where it needs only its lanes).

The dp x tp grid (`strainer_gan_tpu/parallel/mesh.py:37-46, 165-196`):
``make_mesh_2d(dp, tp)`` lays the ranks out tp innermost (rank = d * tp +
t) and makes one dp group and one tp group per coordinate.  Inside
``with grid:`` the helpers above (``lanes``, ``all_reduce_sum``,
``all_gather``, ``sync_grads``, ``exchange``, the BatchNorm sums and loss
means) work on the rank's dp group.  ``put_state_tp`` keeps on each rank
its slice of every output-feature-sharded parameter, BatchNorm buffer and
Adam moment (``tp_sharding_for``: the flax last axis, which is dim 0 of a
``Conv2d`` or ``Linear`` weight and of a 1-D leaf, dim 1 of a
``ConvTranspose2d`` weight; replicated where tp does not divide it) and
hooks the module's chain of layers (the DCGAN's ``convs``, the MLP's
``linears``): a sharded layer computes its own output features, its
BatchNorm, activation and dropout run on them (``tp_slice`` cuts a
full-width keep mask to the rank's columns), and the next layer's input is
gathered over the tp group along dim 1 (``tp_gather``, whose backward
sums the partial input gradients of a sharded consumer: a reduce-scatter).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from .multihost import grouped, is_primary, rank, world

_SHARDED = [False]
_GRID: List["Grid"] = []  # the active dp x tp grid, innermost last


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
    b, r = n // dp_world(), dp_rank()
    parts = [t.narrow(dim, k * n + r * b, b) for k in range(blocks)]
    return parts[0] if blocks == 1 else torch.cat(parts, dim)


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over ranks of a tensor outside autograd; returns it."""
    if grouped():
        dist.all_reduce(t, **_dp())
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, kw):
        ctx.kw = kw
        out = t.clone()
        dist.all_reduce(out, **kw)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, **ctx.kw)
        return g, None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over ranks, differentiable; the identity without a group."""
    if not grouped():
        return t
    return _AllReduceSum.apply(t, _dp())


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors concatenated along dim 0, in rank order."""
    if not grouped():
        return t
    src = t.contiguous()
    if src.dtype == torch.bool:
        return all_gather(src.to(torch.uint8)).to(torch.bool)
    if dist.get_backend() == "nccl":
        out = src.new_empty((dp_world() * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, **_dp())
        return out
    parts = [torch.empty_like(src) for _ in range(dp_world())]
    dist.all_gather(parts, src, **_dp())
    return torch.cat(parts)


def sync_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum each parameter's gradient over ranks, through one flat bucket."""
    if not grouped():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, **_dp())
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


def exchange(rows: torch.Tensor, lanes_only: bool = False) -> torch.Tensor:
    """The sum over ranks of ``rows`` (B, ...), each row nonzero on at most
    one rank: every rank's rows (``lanes_only``: the rank's lanes, through
    a reduce-scatter under NCCL; gloo has none, and a grid's lanes are its
    dp coordinate's, so there it sums all and takes the lanes).  Integer
    sums of one nonzero term are exact, so the result is the owner's
    bytes.  In place on ``rows`` where it sums all."""
    if not grouped():
        return rows
    if lanes_only and dist.get_backend() == "nccl" and grid() is None:
        out = rows.new_empty((rows.shape[0] // world(),) + tuple(rows.shape[1:]))
        dist.reduce_scatter_tensor(out, rows)
        return out
    dist.all_reduce(rows)
    return lanes(rows) if lanes_only else rows


# ------------------------------------------------------------- dp x tp grid


@dataclasses.dataclass
class Grid:
    """A dp x tp layout of the group's ranks, tp innermost: rank = d * tp + t.
    ``with grid:`` makes the dp helpers work on ``dp_group``."""
    dp: int
    tp: int
    d: int  # this rank's dp coordinate
    t: int  # and its tp coordinate
    dp_group: object  # the ranks with this rank's t
    tp_group: object  # the ranks with this rank's d

    def __enter__(self) -> "Grid":
        _GRID.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _GRID.remove(self)


def make_mesh_2d(dp: int, tp: int) -> Grid:
    """The dp x tp grid over the process group (`mesh.py:37-46`).  Every rank
    creates every group, in the same order: the dp groups by t, then the
    tp groups by d."""
    if not grouped() or world() != dp * tp:
        raise ValueError(f"a {dp} x {tp} grid needs a process group of {dp * tp} ranks, "
                         f"not {world() if grouped() else 0}")
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
    d, t = divmod(rank(), tp)
    return Grid(dp, tp, d, t, dp_groups[t], tp_groups[d])


def grid() -> Optional[Grid]:
    return _GRID[-1] if _GRID else None


def dp_world() -> int:
    """The ranks a batch is sharded over: the grid's dp size, else all."""
    g = grid()
    return g.dp if g is not None else world()


def dp_rank() -> int:
    g = grid()
    return g.d if g is not None else rank()


def _dp() -> Dict:
    """The collectives' group keyword: the grid's dp group, else none (all)."""
    g = grid()
    return {"group": g.dp_group} if g is not None else {}


def tp_sharding_for(layer: nn.Module, name: str, t: torch.Tensor, tp: int) -> Optional[int]:
    """The dim of ``layer``'s leaf ``name`` (``t``) sharded over tp, or None
    (replicated), as `mesh.py:165-182` decides on the flax leaf: its
    output-feature axis when tp divides it.  That axis is dim 0 of a
    ``Conv2d`` or ``Linear`` weight (out, in, ...), dim 1 of a
    ``ConvTranspose2d`` weight (in, out, kh, kw), and dim 0 of a 1-D leaf
    (biases, BatchNorm scale, shift and running statistics)."""
    if t.dim() >= 2:
        if isinstance(layer, nn.ConvTranspose2d):
            dim = 1
        elif isinstance(layer, (nn.Conv2d, nn.Linear)):
            dim = 0
        else:
            return None
    elif t.dim() == 1:
        dim = 0
    else:
        return None
    return dim if t.shape[dim] % tp == 0 else None


def tp_placement(module: nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """``tp_sharding_for`` of every parameter and buffer of ``module``, by
    name."""
    out = {}
    for mname, layer in module.named_modules():
        for kind in (layer.named_parameters, layer.named_buffers):
            for name, t in kind(recurse=False):
                out[f"{mname}.{name}" if mname else name] = tp_sharding_for(layer, name, t, tp)
    return out


class _TPGather(torch.autograd.Function):
    """The ranks' channel slices concatenated along dim 1 over the tp group.
    Backward: with ``partial`` (the consumer is itself sharded, so each rank
    holds a partial gradient of the whole input) the sum over tp, then the
    rank's slice: a reduce-scatter; without it (a replicated consumer: every
    rank holds the whole gradient) the rank's slice alone."""

    @staticmethod
    def forward(ctx, x, g: Grid, partial: bool):
        ctx.g, ctx.partial, ctx.c = g, partial, x.shape[1]
        src = x.contiguous()
        if dist.get_backend() == "nccl":  # one buffer, as ``all_gather``
            out = src.new_empty((g.tp,) + tuple(src.shape))
            dist.all_gather_into_tensor(out, src, group=g.tp_group)
            return torch.cat(out.unbind(0), 1)
        parts = [torch.empty_like(src) for _ in range(g.tp)]
        dist.all_gather(parts, src, group=g.tp_group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous()
        if ctx.partial:
            g = g.clone()
            dist.all_reduce(g, group=ctx.g.tp_group)
        return g.narrow(1, ctx.g.t * ctx.c, ctx.c).contiguous(), None, None


class _TPEnter(torch.autograd.Function):
    """A whole input entering a sharded layer: the identity, whose backward
    sums the ranks' partial gradients over the tp group."""

    @staticmethod
    def forward(ctx, x, g: Grid):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.g.tp_group)
        return g, None


def tp_gather(x: torch.Tensor, g: Grid, partial: bool) -> torch.Tensor:
    return _TPGather.apply(x, g, partial)


def tp_slice(t: torch.Tensor, width: int) -> torch.Tensor:
    """The active grid's tp rank's ``width`` columns (last dim) of ``t``, a
    full-width tensor beside a sharded layer's output (D's keep masks: every
    tp rank drops the same units); ``t`` itself where it is ``width`` wide
    (no grid, or a replicated layer)."""
    n, g = t.shape[-1], grid()
    if n == width:
        return t
    if g is None or n != width * g.tp:
        raise ValueError(f"{n} columns beside a layer output {width} wide, "
                         f"tp {g.tp if g is not None else 'none'}")
    return t.narrow(-1, g.t * width, width)


# the chain of layers a tp placement hooks, by module: the DCGAN's
# convolutions, the MLP's Linears
TP_CHAINS = ("convs", "linears")


def _tp_hooks(chain: nn.ModuleList, sharded: List[bool], g: Grid) -> None:
    """Each layer's input made whole along dim 1 (channels or features)
    before it runs: gathered over tp after a sharded layer, or entered (its
    gradient summed over tp) into a sharded one; a sharded last layer's
    output gathered.  What runs between two layers (BatchNorm, activation,
    dropout) sees the earlier layer's output features only."""
    for i, layer in enumerate(chain):
        local_in = i > 0 and sharded[i - 1]
        if local_in or sharded[i]:
            def pre(_m, args, _local=local_in, _partial=sharded[i]):
                x = args[0]
                x = tp_gather(x, g, _partial) if _local else _TPEnter.apply(x, g)
                return (x,) + tuple(args[1:])

            layer.register_forward_pre_hook(pre)
    if sharded[-1]:
        chain[-1].register_forward_hook(lambda _m, _a, out: tp_gather(out, g, False))


def put_state_tp(g: Grid, modules: Iterable[nn.Module],
                 optimizers: Iterable[torch.optim.Optimizer] = ()) -> None:
    """Keep on this rank its tp slice of every sharded parameter and buffer
    of ``modules`` (the DCGAN's ``convs`` chain, the MLP's ``linears``, and
    their BatchNorms) and of the optimizers' Adam moments, in place (the
    parameters stay the optimizers' objects), and hook the chain's layers
    (`mesh.py:185-196`).  A module with neither chain is refused."""
    opt_state = {}
    for opt in optimizers:
        opt_state.update(opt.state)
    for module in modules:
        chain = next((c for c in TP_CHAINS if hasattr(module, c)), None)
        if chain is None:
            raise NotImplementedError(
                f"{type(module).__name__} has no tp chain ({' or '.join(TP_CHAINS)})")
        placement = tp_placement(module, g.tp)
        with torch.no_grad():
            for kind in (module.named_parameters, module.named_buffers):
                for name, t in kind():
                    dim = placement[name]
                    if dim is None:
                        continue
                    size = t.shape[dim] // g.tp
                    t.data = t.data.narrow(dim, g.t * size, size).clone()
                    st = opt_state.get(t, {})
                    for key, v in st.items():  # the moments; the step count stays
                        if isinstance(v, torch.Tensor) and v.dim() > 0:
                            st[key] = v.narrow(dim, g.t * size, size).clone()
        layers = getattr(module, chain)
        _tp_hooks(layers, [placement[f"{chain}.{i}.weight"] is not None
                           for i in range(len(layers))], g)


__all__ = ["Grid", "all_gather", "all_reduce_", "all_reduce_sum", "batch_sharded", "broadcast",
           "dp_rank", "dp_world", "exchange", "from_primary", "grid", "grouped",
           "is_primary", "lanes", "make_mesh_2d", "put_state_tp", "rank", "sharded",
           "sync_grads", "tp_gather", "tp_placement", "tp_sharding_for", "tp_slice", "world"]
