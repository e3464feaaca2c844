"""The GAN train step, D-first or G-first, with the in-step quantile mask
(counterpart of `strainer_gan_tpu/train/steps.py:61-363`,
``_build_step_body``).

Faithful to the reference's update algebra (`#%basic.py:237-288`): ONE G
forward whose autograd graph the G step reuses; D sees the real batch, then
the detached fakes (two BN statistic updates), D's Adam step applies, and
then the G loss re-scores the same fakes through the UPDATED D (a third D
statistic update, in train mode).  BN statistics thus thread through in
the reference order (`steps.py:315-321`).  The MNIST baselines update G
first (``g_before_d``, `#8.py:118-132`, `steps.py:322-331`): G steps
through the current D, then D steps on the same fakes, made before G's
update.  G's backward reaches only G's parameters (``backward(inputs=)``),
so D's update sees none of its gradients.

The MLP's D may drop out (``dropout``, `# 1,2,8.py:110-128`).  Its keep
masks are inputs of the step, ``drop_masks``: one bool tensor per hidden
width (``drop_shape``), whose rows 0, 1, 2 and 3 serve D's forward of the
real batch, of the fakes in D's update, of the fakes in G's update and,
with an in-step keep, the scoring forward, the forwards the JAX step
gives their own dropout keys (`steps.py:105-108, 159-161`); with a pool,
the fake forward's row spans all 2b lanes.  The step draws nothing, so a
captured chunk replays the masks its caller filled, as it replays the
noise.  ``flatten`` makes the real batch (N, H*W*C) rows for the MLP
(`steps.py:110-111`).

The per-batch quantile mask (``batch_mask`` with ``mask_on``, `# 상위
10%...X.py:280-318`, `steps.py:130-190`): a no-grad scoring forward of the
real batch, in D's training mode (torch updates BN running statistics under
no_grad too, so this pass comes first in the statistics' order), keeps the
samples whose ``sigmoid`` score is at or above the batch's ``mask_quantile``;
the real AND the fake side then train at the kept size, expressed as
per-sample weights on full-shape batches (weighted loss means and weighted
BatchNorm), which is torch's smaller batch exactly.  With ``stem_share``
D's BatchNorm-free stem runs once: the scoring pass and the training real
forward both start from its output, and autograd carries the real side's
gradient back through it (the JAX step's captured ``stem_vjp``,
`steps.py:298-307`).

Fake concatenation (`steps.py:198-236`): with ``in_batch_recycle`` the
same in-step keep (at ``recycle_quantile``) recycles the reals it drops as
fakes in D's fake batch; with ``pool_concat`` D's fake side gains a batch
of the device-resident outlier pool, gathered and normalised inside the
step from the pool rows the caller draws (see ``step_body``).

``lane_count`` gives the partial tail batch of a drop_last=False epoch
(`steps.py:116-128`): lanes >= lane_count carry weight 0 in every loss mean,
every BatchNorm statistic (G's and D's), the in-step quantile and the
contamination counts — the same numbers torch gets from the smaller batch.
``z`` is an argument so a test can hand both packages the same noise; the
Trainer draws it from a ``torch.Generator``.  The step reads nothing back
to the host.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..data.pipeline import normalize_u8
from ..kernels.gated_graph import GatedGraph
from ..obs.profiler import span
from ..ops import losses as L
from ..ops import stats as S
from ..parallel import mesh as M
from .state import set_lr


class StepConfig(NamedTuple):
    d_loss_reduction: str = "sum"  # 'sum' | 'half_mean'
    real_label: float = 1.0
    fake_label: float = 0.0
    batch_mask: bool = False  # the in-step quantile mask (batch_quantile_mask)
    mask_quantile: float = 0.1
    in_batch_recycle: bool = False  # fake_concat="in_batch"
    recycle_quantile: float = 0.1
    pool_concat: bool = False  # fake_concat="pool"
    nz: int = 100
    # "bfloat16" runs the forwards under autocast on the card; parameters,
    # BN statistics, losses and Adam stay float32
    compute_dtype: str = "float32"
    g_before_d: bool = False
    dropout: float = 0.0  # D's dropout rate (the MLP's)
    drop_widths: Tuple[int, ...] = ()  # D's hidden widths that drop out, in order
    flatten: bool = False


# D forwards a step drops out in: real, fakes in D's update, G's update and
# the in-step keep's scoring forward
DROP_REAL, DROP_FAKE, DROP_G, DROP_SCORE = range(4)


def drop_shape(scfg: StepConfig, b: int, width: int) -> Tuple[int, int, int]:
    """The shape of a step's keep masks for one hidden width of D, at batch
    ``b``: a row per forward (the scoring row only where the step has an
    in-step keep), and 2b lanes with a pool (D's fake forward then spans
    the generated and the pool lanes; the other rows use the first b)."""
    rows = 4 if (scfg.batch_mask or scfg.in_batch_recycle) else 3
    return rows, 2 * b if scfg.pool_concat else b, width


def rank_inputs(scfg: StepConfig, ids, z, pool_idx=None, drop=None):
    """The rank's lanes of a global step's draws: sample indices, noise,
    pool rows and keep masks ((rows, lanes, width) each); all as given
    without a process group."""
    drop = [M.lanes(m, dim=1, blocks=2 if scfg.pool_concat else 1) for m in drop or ()]
    return (M.lanes(ids), M.lanes(z), None if pool_idx is None else M.lanes(pool_idx),
            drop or None)


def step_config_from(cfg) -> StepConfig:
    t, s, m = cfg.train, cfg.strain, cfg.model
    if s.fake_concat not in ("none", "in_batch", "pool"):
        raise ValueError(f"unknown fake_concat {s.fake_concat!r}")
    batch_mask = s.method == "batch_quantile_mask"
    return StepConfig(d_loss_reduction=t.d_loss_reduction, real_label=t.real_label,
                      fake_label=t.fake_label, batch_mask=batch_mask,
                      mask_quantile=s.mask_quantile,
                      in_batch_recycle=s.fake_concat == "in_batch",
                      recycle_quantile=s.in_batch_recycle_quantile,
                      pool_concat=s.fake_concat == "pool", nz=m.nz,
                      compute_dtype=m.compute_dtype, g_before_d=t.g_before_d,
                      dropout=m.d_dropout,
                      drop_widths=tuple(reversed(m.hidden)) if m.d_dropout > 0 else (),
                      flatten=cfg.data.flatten)


@contextlib.contextmanager
def capturing(graph: "torch.cuda.CUDAGraph", pool=None):
    """``torch.cuda.graph(graph, pool)`` with Python's cyclic garbage
    collector held off.  A collection inside a capture can free an older
    graph (a Trainer is a reference cycle: its optimizers' load hooks hold
    it), and destroying a graph is an operation the capturing stream
    refuses: the capture fails.  So dead cycles are collected before the
    capture and none during it."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        if enabled:
            gc.enable()


def autocast(x: torch.Tensor, compute_dtype: str):
    """bfloat16 autocast on the card when ``compute_dtype`` asks for it;
    float32 elsewhere.  Its weight-cast cache is off: inside a CUDA graph
    capture a cast cached during an earlier step would be baked into the
    graph, and every replay would then train on stale bfloat16 weights.
    Without the cache each region casts its weights again, which gives the
    same values."""
    if compute_dtype == "bfloat16" and x.device.type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16, cache_enabled=False)
    return contextlib.nullcontext()


def train_step(gen: torch.nn.Module, disc: torch.nn.Module,
               opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer,
               x: torch.Tensor, source_id: torch.Tensor, z: torch.Tensor,
               lr_g: float, lr_d: float, scfg: StepConfig, d_train: bool = True,
               lane_count: Optional[int] = None, mask_on: bool = False,
               stem_share: bool = True, fake_pool: Optional[torch.Tensor] = None,
               pool_idx: Optional[torch.Tensor] = None,
               concat_on: Optional[torch.Tensor] = None,
               drop_masks: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One step on a normalised NCHW batch ``x`` at rates ``lr_g``, ``lr_d``;
    updates the modules and optimizers in place and returns the metrics of
    `steps.py:347-360`.  See ``step_body``."""
    set_lr(opt_g, lr_g)
    set_lr(opt_d, lr_d)
    return step_body(gen, disc, opt_g, opt_d, x, source_id, z, scfg, d_train=d_train,
                     lane_count=lane_count, mask_on=mask_on, stem_share=stem_share,
                     fake_pool=fake_pool, pool_idx=pool_idx, concat_on=concat_on,
                     drop_masks=drop_masks)


def pool_indices(perm: torch.Tensor, b: int) -> torch.Tensor:
    """The ``b`` pool rows of one step from a permutation of the pool's
    rows, wrapping when the pool is smaller than the batch
    (`strainer_gan_tpu/train/steps.py:212-216`)."""
    return perm[torch.arange(b, device=perm.device) % perm.shape[0]]


def step_body(gen: torch.nn.Module, disc: torch.nn.Module,
              opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer,
              x: torch.Tensor, source_id: torch.Tensor, z: torch.Tensor,
              scfg: StepConfig, d_train: bool = True,
              lane_count: Optional[int] = None, mask_on: bool = False,
              stem_share: bool = True, fake_pool: Optional[torch.Tensor] = None,
              pool_idx: Optional[torch.Tensor] = None,
              concat_on: Optional[torch.Tensor] = None,
              drop_masks: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The step at the optimizers' current rates: what ``ChunkedStep``
    captures.  It reads nothing back to the host and makes no tensor from
    host data, so a CUDA graph can capture it.

    ``d_train=False`` is the bn_eval_after_score quirk: D's BatchNorms use
    (and keep) their running statistics.  ``mask_on`` gates the in-step
    keep of a ``batch_mask`` or an ``in_batch_recycle`` config (the epoch
    has reached ``mask_start_epoch`` or ``fake_concat_start_epoch``);
    ``stem_share=False`` runs the scoring and the real forward through the
    whole of D each, for the A/B test only.

    Fake concatenation (`strainer_gan_tpu/train/steps.py:198-236`):

    * ``in_batch_recycle``: the reals the keep drops replace the fakes in
      their slots of D's fake batch, which is weighted by the valid lanes;
      G's BatchNorms see the kept slots only, and G's loss runs on the same
      combined batch, so the recycled lanes carry no G gradient.
    * ``pool_concat``: D's fake side is 2b lanes, the b generated images and
      b images of ``fake_pool`` (uint8 NHWC on the device), rows
      ``pool_idx`` (b,), gathered and normalised here; the pool lanes weigh
      ``concat_on`` (a 0-d float32 device flag, 1 from the gate epoch on,
      else 0) times the generated lanes' weights, and D_G_z1 covers the
      generated lanes only.  G trains on its generated fakes alone.

    ``drop_masks``: D's keep masks, ``drop_shape`` bool per hidden width of
    a D with dropout (rows ``DROP_REAL``, ``DROP_FAKE``, ``DROP_G`` and
    ``DROP_SCORE``).

    Under a process group (``parallel.mesh``) the step is one global step
    over the ranks: ``x``, ``source_id``, ``z``, ``pool_idx`` and
    ``drop_masks`` are the rank's lanes of the global batch
    (``rank_inputs``), ``lane_count`` counts the global batch's valid
    lanes, every BatchNorm statistic, loss mean, metric and counter is the
    global batch's, the in-step quantile runs over the gathered scores,
    and the gradients are summed over ranks before each Adam step.  The
    per-sample metrics come back for the global batch, in rank order.

    Inside a dp x tp grid (``with grid:``, the state placed by
    ``parallel.mesh.put_state_tp``) the batch is sharded over the dp
    coordinate and every sum above runs over the dp group, while each
    sharded layer computes its own output features and the tp group
    gathers them for the next (`mesh.py:165-196`).  Every variant runs
    there, as GSPMD shards any step on a tp-placed state: the in-step keep
    (D's 1-wide last layer is replicated at tp > 1 and reads a gathered
    input, so every tp rank of a dp row scores the same and keeps the same
    lanes), recycling and the pool (G's output is
    gathered whole), and the MLP's G-first and dropout steps (each tp rank
    drops its columns of the full-width masks).  ``ChunkedStep`` runs this
    body too, so a chunk under the grid records the tp collectives."""
    with M.batch_sharded():
        return _step(gen, disc, opt_g, opt_d, x, source_id, z, scfg, d_train, lane_count,
                     mask_on, stem_share, fake_pool, pool_idx, concat_on, drop_masks)


def _step(gen, disc, opt_g, opt_d, x, source_id, z, scfg, d_train, lane_count, mask_on,
          stem_share, fake_pool, pool_idx, concat_on, drop_masks):
    b = x.shape[0]  # the rank's lanes
    dev = x.device
    sharded = M.sharded()
    if scfg.flatten:
        x = x.reshape(b, -1)
    if scfg.dropout > 0 and (drop_masks is None or len(drop_masks) != len(scfg.drop_widths)):
        raise ValueError(f"a step of D with dropout needs {len(scfg.drop_widths)} keep masks")
    stem_share = stem_share and hasattr(disc, "stem") and scfg.dropout == 0

    def d_fwd(inp, w, row):
        if scfg.dropout > 0:
            n = inp.shape[0]
            return disc(inp, w, train=d_train, drop_masks=[m[row][:n] for m in drop_masks])
        return disc(inp, w, train=d_train)

    if scfg.pool_concat and not isinstance(concat_on, torch.Tensor):
        concat_on = torch.full((), float(bool(concat_on)), device=dev)  # a fill, no copy
    valid = valid_g = None
    valid_w = None
    if lane_count is not None:
        off = M.dp_rank() * b  # the global index of the rank's first lane
        valid = torch.arange(off, off + b, device=dev) < lane_count
        valid_w = valid.to(torch.float32)
        valid_g = M.all_gather(valid)
    real_t, fake_t = scfg.real_label, scfg.fake_label
    amp = autocast(x, scfg.compute_dtype)

    # ---- in-step strain: score the real batch, keep the top 1 - q
    masked = (scfg.batch_mask or scfg.in_batch_recycle) and mask_on
    q = scfg.mask_quantile if scfg.batch_mask else scfg.recycle_quantile
    keep = torch.ones((b,), dtype=torch.bool, device=dev) if valid is None else valid
    keep_g = keep  # the global batch's keep, for the metrics
    if sharded:
        keep_g = (torch.ones((b * M.dp_world(),), dtype=torch.bool, device=dev) if valid is None
                  else valid_g)
    h_real = None
    if masked:
        with amp:
            if stem_share:
                h_real = disc.stem(x)  # with its graph: the real forward reuses it
            with torch.no_grad():
                logits_s = (disc.head(h_real, valid_w, train=d_train) if stem_share
                            else d_fwd(x, valid_w, DROP_SCORE))
        # as XLA computes jax.nn.sigmoid; over the global batch
        probs_s = M.all_gather(L.sigmoid_ftz(logits_s))
        if valid is None:
            keep_g = probs_s >= S.quantile(probs_s, q)
        else:
            # a partial tail: the quantile of the valid lanes only, which is
            # torch.quantile on the smaller batch
            keep_g = (probs_s >= S.masked_quantile(probs_s, valid_g, q)) & valid_g
        keep = M.lanes(keep_g)  # each rank keeps its own lanes
    w_real = w_fake = keep.to(torch.float32) if masked else valid_w

    # ---- G forward, once; its graph serves the G step below.  G's BN
    # statistics cover the kept slots only: the reference draws its noise
    # at the masked size
    with amp:
        fake = gen(z, w_fake, train=True)

    recycle = scfg.in_batch_recycle and masked

    def fake_batch(imgs):
        """D's fake-side batch, its lane weights and, with the pool, the
        weights of the lanes G made."""
        if recycle:
            use_real = torch.logical_not(keep)
            if valid is not None:
                use_real = torch.logical_and(use_real, valid)  # pads stay fake slots
            combined = torch.where(use_real.view((-1,) + (1,) * (x.dim() - 1)),
                                   x.to(imgs.dtype), imgs)
            return combined, valid_w, None
        if scfg.pool_concat:
            pool_x = normalize_u8(fake_pool.index_select(0, pool_idx), torch.float32)
            if scfg.flatten:
                pool_x = pool_x.reshape(b, -1)
            gen_w = torch.ones((b,), dtype=torch.float32, device=dev) if valid_w is None \
                else valid_w
            w = torch.cat([gen_w, concat_on * gen_w])
            return torch.cat([imgs, pool_x.to(imgs.dtype)]), w, torch.cat(
                [gen_w, torch.zeros_like(gen_w)])
        return imgs, w_fake, None

    def d_update():
        """D's update on the real batch, then the detached fakes."""
        opt_d.zero_grad(set_to_none=True)
        fake_d, w_fd, gen_slot = fake_batch(fake.detach())
        with amp:
            out_r = (disc.head(h_real, w_real, train=d_train) if h_real is not None
                     else d_fwd(x, w_real, DROP_REAL))
            out_f = d_fwd(fake_d, w_fd, DROP_FAKE)
        per_real = L.bce_from_logits(out_r, real_t)
        per_fake = L.bce_from_logits(out_f, fake_t)
        err_d = L.d_loss(per_real, per_fake, scfg.d_loss_reduction, w_real, w_fd)
        err_d.backward()
        M.sync_grads(disc.parameters())
        opt_d.step()
        return err_d, out_r, out_f, per_real, per_fake, w_fd, gen_slot

    def g_update():
        """G's update through D as it stands: on the recycled batch, or on
        the generated fakes alone; its backward reaches G's parameters
        only."""
        opt_g.zero_grad(set_to_none=True)
        fake_g, w_fg = fake_batch(fake)[:2] if recycle else (fake, w_fake)
        with amp:
            out_g = d_fwd(fake_g, w_fg, DROP_G)
        err_g = L.weighted_mean(L.bce_from_logits(out_g, real_t), w_fg)
        err_g.backward(inputs=list(gen.parameters()))
        M.sync_grads(gen.parameters())
        opt_g.step()
        return err_g, out_g, w_fg

    if scfg.g_before_d:  # `#8.py:118-132`
        err_g, out_g, w_fg = g_update()
        err_d, out_r, out_f, per_real, per_fake, w_fd, gen_slot = d_update()
    else:
        err_d, out_r, out_f, per_real, per_fake, w_fd, gen_slot = d_update()
        err_g, out_g, w_fg = g_update()

    with torch.no_grad():
        contam = source_id != 0
        if valid is not None:
            contam = torch.logical_and(contam, valid)  # pads never count
        filtered = (torch.logical_and(contam, torch.logical_not(keep)).sum() if masked
                    else torch.zeros((), dtype=torch.int64, device=dev))
        means = dict(
            errD=err_d.detach(), errG=err_g.detach(),
            errD_real=L.weighted_mean(per_real, w_real).detach(),
            errD_fake=L.weighted_mean(per_fake, w_fd).detach(),
            D_x=L.weighted_mean(torch.sigmoid(out_r), w_real),
            D_G_z1=L.weighted_mean(torch.sigmoid(out_f),
                                   gen_slot if scfg.pool_concat else w_fd),
            D_G_z2=L.weighted_mean(torch.sigmoid(out_g), w_fg))
        counts = dict(n_contam=contam.sum(), n_filtered_contam=filtered)
        if sharded:
            # the ranks' shares and counts summed: one collective each
            for group in (means, counts):
                total = M.all_reduce_(torch.stack(list(group.values())))
                group.update(zip(group, total.unbind()))
        metrics = dict(
            means,
            real_loss_per_sample=M.all_gather(per_real.detach()),
            keep_mask=keep_g,
            # the scores the mask came from, for the parity report
            score_probs=(probs_s if masked
                         else torch.zeros((keep_g.shape[0],), dtype=torch.float32,
                                          device=dev)),
            **counts,
        )
    return metrics


class ChunkedStep:
    """``chunk`` consecutive train steps as one unit (counterpart of
    `strainer_gan_tpu/train/steps.py:392-473`, ``make_chunked_train_step``).

    On the card the chunk is one CUDA graph: the first call captures
    ``chunk`` calls of ``step_body`` (the same body the per-step path runs,
    so the results are bit for bit the same) and every call replays it; a
    capture or a replay that fails raises, nothing drops back to eager
    steps.  On the CPU, which a caller must ask for, the same body runs
    eagerly over the same buffers.  Under a process group the graph
    records the step's collectives; on a dp x tp grid (called inside
    ``with grid:`` on a ``put_state_tp`` state, as JAX's chunked executor
    runs on a tp-sharded state) also the tp gathers and their backward
    sums, so a replay needs no grid around it, and each eager call does.

    Static inputs: ``idx`` (chunk, batch) sample indices and ``z`` (chunk,
    batch, nz) noise, filled from the caller's draws at each call (and, for
    a D with dropout, ``drop``: D's keep masks, one (chunk,) +
    ``drop_shape`` bool buffer per hidden width, filled the same way, so each
    replay drops out with fresh masks); each
    step gathers and normalises its batch from the dataset inside the
    chunk, as the JAX scan's ``jnp.take`` does.  With a ``fake_pool`` (the
    pool configs), also ``pool_idx`` (chunk, batch), each step's pool rows,
    and ``concat_on``, the pool's 0-d float32 gate flag: both filled before
    each call, so the gate's flip at ``fake_concat_start_epoch`` needs no
    new capture (it is traced, not static, in JAX: `steps.py:370-372`).  Static outputs: the
    step's metrics stacked (chunk, ...) in ``out``, shaped like ``like``
    (the metrics of a step already run with the same key: the capture's
    warm-up, so Adam's state and cuDNN's plans exist before a capture).
    ``__call__`` returns a copy of ``out``: the next call overwrites it.

    Each call fills the optimizers' rate tensors (``state.set_lr``), which
    the replay reads.  A graph keeps the addresses of everything it reads;
    ``__call__`` checks before each replay that the parameters, buffers,
    optimizer state, rates and the fake pool are still the tensors it
    captured and raises if one was rebound (the Trainer drops its captures
    whenever an optimizer loads a state, so this never fires on its path).  ``stats``
    is the owner's dict of counts, shared by its executors: ``captures``,
    ``replays``, and each capture's ``capture_s`` (the host's time to
    record the chunk) and ``instantiate_s``.
    """

    def __init__(self, gen, disc, opt_g, opt_d, dataset, scfg: StepConfig, chunk: int,
                 like: Dict[str, torch.Tensor], *, mask_on: bool, d_train: bool,
                 stats: Dict, stem_share: bool = True, graph_pool=None,
                 fake_pool: Optional[torch.Tensor] = None):
        self.gen, self.disc, self.opt_g, self.opt_d = gen, disc, opt_g, opt_d
        self.dataset, self.scfg, self.chunk = dataset, scfg, chunk
        self.mask_on, self.d_train, self.stem_share = mask_on, d_train, stem_share
        self.graph_pool, self.fake_pool = graph_pool, fake_pool
        self.stats = stats
        self.device = dev = dataset.device
        b = like["real_loss_per_sample"].shape[0]
        self.idx = torch.zeros((chunk, b), dtype=torch.int64, device=dev)
        self.z = torch.zeros((chunk, b, scfg.nz), dtype=torch.float32, device=dev)
        self.pool_idx = torch.zeros((chunk, b), dtype=torch.int64, device=dev)
        self.concat_on = torch.zeros((), dtype=torch.float32, device=dev)
        self.drop = [torch.zeros((chunk,) + drop_shape(scfg, b, w), dtype=torch.bool,
                                 device=dev) for w in scfg.drop_widths]
        self.out = {k: torch.zeros((chunk,) + tuple(v.shape), dtype=v.dtype, device=dev)
                    for k, v in like.items()}
        self.graph = None
        self._ptrs = None

    def _step(self, j: int, lane_count: Optional[torch.Tensor] = None) -> None:
        """Step ``j`` of the chunk from the static buffers, its metrics into
        row ``j`` of ``out``."""
        # the rank's lanes of the step (all of them without a group); a
        # sample-sharded dataset brings them in through the exchange
        u8, src = self.dataset.batch(self.idx[j])
        _, z, pool_idx, drop = rank_inputs(self.scfg, self.idx[j], self.z[j],
                                           self.pool_idx[j], [m[j] for m in self.drop])
        m = step_body(self.gen, self.disc, self.opt_g, self.opt_d,
                      normalize_u8(u8, torch.float32), src, z, self.scfg,
                      d_train=self.d_train, lane_count=lane_count, mask_on=self.mask_on,
                      stem_share=self.stem_share, fake_pool=self.fake_pool, pool_idx=pool_idx,
                      concat_on=self.concat_on, drop_masks=drop)
        for k, v in m.items():
            self.out[k][j].copy_(v)

    def _body(self) -> None:
        for j in range(self.chunk):
            self._step(j)

    def _pointers(self):
        ts = [*self.gen.parameters(), *self.gen.buffers(), *self.disc.parameters(),
              *self.disc.buffers(), self.dataset.images, self.dataset.source_id]
        if self.fake_pool is not None:
            ts.append(self.fake_pool)
        for opt in (self.opt_g, self.opt_d):
            ts += [g["lr"] for g in opt.param_groups]
            ts += [t for st in opt.state.values() for t in st.values()
                   if isinstance(t, torch.Tensor)]
        return [t.data_ptr() for t in ts]

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        with capturing(graph, self.graph_pool):
            t0 = time.perf_counter()
            self._body()
            t1 = time.perf_counter()
        # leaving the block ends the capture and instantiates the graph
        self.stats["instantiate_s"].append(time.perf_counter() - t1)
        self.stats["capture_s"].append(t1 - t0)
        self.stats["captures"] += 1
        self.graph = graph
        self._ptrs = self._pointers()

    def __call__(self, idx: torch.Tensor, z: torch.Tensor, lr_g: float, lr_d: float,
                 pool_idx: Optional[torch.Tensor] = None,
                 concat_on: bool = False,
                 drop: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Run the chunk on ``idx`` (chunk, batch) and ``z`` (chunk, batch, nz)
        at rates ``lr_g``, ``lr_d`` (with a fake pool: on its rows
        ``pool_idx`` (chunk, batch), gated by ``concat_on``; with dropout:
        D's keep masks ``drop``, (chunk,) + ``drop_shape`` per hidden width);
        returns the stacked metrics."""
        self._fill(idx, z, lr_g, lr_d, pool_idx, concat_on, drop)
        return self._run()

    def _run(self) -> Dict[str, torch.Tensor]:
        """The chunk on the filled buffers: captured at the first call and
        launched (on the card), or run eagerly (on the CPU); a copy of
        ``out``."""
        if self.device.type == "cuda":
            if self.graph is None:
                with span("chunk.capture"):
                    self._capture()
            else:
                self._check_pointers()
            self._launch()
            self.stats["replays"] += 1
        else:
            self._body()
        return {k: v.clone() for k, v in self.out.items()}

    def _launch(self) -> None:
        self.graph.replay()

    def _fill(self, idx, z, lr_g, lr_d, pool_idx, concat_on, drop) -> None:
        """The caller's inputs into the static buffers, the rates into the
        optimizers' rate tensors."""
        self.idx.copy_(idx)
        self.z.copy_(z)
        for buf, m in zip(self.drop, drop or ()):
            buf.copy_(m)
        if len(drop or ()) != len(self.drop):
            raise ValueError(f"this chunk takes {len(self.drop)} keep-mask buffers")
        if self.fake_pool is not None:
            self.pool_idx.copy_(pool_idx)
            self.concat_on.fill_(float(concat_on))
        set_lr(self.opt_g, lr_g)
        set_lr(self.opt_d, lr_d)

    def _check_pointers(self) -> None:
        if self._pointers() != self._ptrs:
            raise RuntimeError(
                "a tensor this CUDA graph reads was rebound after its capture "
                "(an optimizer or module state was loaded); drop the captures first")


class GatedChunkedStep(ChunkedStep):
    """A chunk whose live steps are decided on the device (counterpart of
    `strainer_gan_tpu/train/steps.py:476-572`, ``make_gated_chunked_train_step``;
    with ``tail=True``, of `steps.py:575-634`, ``make_gated_tail_step``).

    Two more static 0-d int64 buffers: ``c0``, the chunk's first global
    step, and ``bound``, the epoch's live step count (``n_valid``); step
    ``j`` runs only if ``c0 + j < bound``.  A dead step leaves every
    parameter, buffer, Adam moment and Adam step count as it was, and its
    row of ``out`` keeps whatever an earlier call wrote there: a caller
    reads the live rows only.

    On the card each step is captured as its own CUDA graph (the same
    ``step_body``, so a live step is bit for bit the ungated one) and
    ``kernels.gated_graph.GatedGraph`` puts each under an IF node whose
    predicate a one-thread kernel computes inside the graph from the
    buffers, all under one outer IF on ``c0 < bound``: a wholly dead chunk
    costs one predicate kernel.  No host read decides anything; a capture,
    build or launch that fails raises.  On the CPU the same steps run
    eagerly and each predicate is read on the host.

    ``tail=True`` is the gated partial tail: one step (``chunk`` 1) with
    ``c0`` 0 and ``bound`` the tail's valid-lane count, which is also the
    step's ``lane_count`` (a device tensor: no host read), so it runs only
    if the tail has lanes.
    """

    def __init__(self, *args, tail: bool = False, **kw):
        super().__init__(*args, **kw)
        if tail and self.chunk != 1:
            raise ValueError("the gated tail is one step")
        self.tail = tail
        self.c0 = torch.zeros((), dtype=torch.int64, device=self.device)
        self.bound = torch.zeros((), dtype=torch.int64, device=self.device)
        self._given = (0, 0)  # the last call's c0 and bound, as given

    def _lanes(self) -> Optional[torch.Tensor]:
        return self.bound if self.tail else None

    def _body(self) -> None:
        # the CPU path: the predicate on the host, a read only of a bound
        # given as a device tensor
        c0, bound = self._given
        for j in range(min(int(bound) - c0, self.chunk)):
            self._step(j, self._lanes())

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graphs = []
        # one synchronisation and one collection for all the steps'
        # captures (``capturing`` does both for each), then the collector
        # held off; each graph kept un-instantiated: only its clone in the
        # gated graph runs
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        torch.cuda.synchronize(self.device)
        try:
            with torch.cuda.stream(torch.cuda.Stream(self.device)):
                for j in range(self.chunk):
                    g = torch.cuda.CUDAGraph(keep_graph=True)
                    g.capture_begin(pool=self.graph_pool)
                    try:
                        self._step(j, self._lanes())
                    finally:
                        g.capture_end()
                    graphs.append(g)
        finally:
            if enabled:
                gc.enable()
        t1 = time.perf_counter()
        self.graph = GatedGraph(graphs, self.c0, self.bound, outer=not self.tail)
        self.stats["instantiate_s"].append(time.perf_counter() - t1)
        self.stats["capture_s"].append(t1 - t0)
        self.stats["captures"] += 1
        self.stats["conditional_nodes"] += self.graph.conditionals
        self._ptrs = self._pointers()

    def __call__(self, idx: torch.Tensor, z: torch.Tensor, lr_g: float, lr_d: float,
                 c0: int, bound: Union[int, torch.Tensor],
                 pool_idx: Optional[torch.Tensor] = None, concat_on: bool = False,
                 drop: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """``ChunkedStep.__call__`` with the chunk's first global step ``c0``
        (a host int) and the live count ``bound`` (a 0-d device tensor,
        copied on the device, or a host int, filled as ``c0`` is); returns
        the stacked metrics, live rows first."""
        self._fill(idx, z, lr_g, lr_d, pool_idx, concat_on, drop)
        self._given = (c0, bound)
        self.c0.fill_(c0)
        if isinstance(bound, torch.Tensor):
            self.bound.copy_(bound)
        else:
            self.bound.fill_(bound)
        return self._run()

    def _launch(self) -> None:
        self.graph.launch()
        self.stats["gated_replays"] += 1
