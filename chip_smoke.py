"""Drive the PyTorch/H100 port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line of output or more each; any failure raises and the
script exits non-zero without printing its result line:

1. build: compile ``strainer_gan_tpu_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (one process per source, all started together), and read the
   card's name and power limit.
2. kernels: every CUDA kernel of the port at the shapes its path gives it,
   held against its plain PyTorch version on the same inputs, and timed
   with CUDA events beside its plain version (and, where one PyTorch call
   computes the same function, that call).  K1 and K2 at the ``final``
   path's shapes (K2b bit-equal to its plain version; K1 also with ``out=``,
   in place and replayed from a CUDA graph, and timed per call both back
   to back and from a graph of 100 calls, which leaves the host out);
   then the JAX fixture: the seeded inputs of
   ``tests/fixtures/torch_port_jax_masks.npz`` made again, and the card's
   max-|z| masks (fixed, elbow, quantile at the K3 clean ratio) and loss
   mask held to the JAX package's stored decisions, each flip printed with
   its distance to the threshold; the same for the loss-space fixture
   (``tests/fixtures/torch_port_jax_loss_masks.npz``: 40,000 bimodal
   losses, AE-like errors and 128-lane score batches): the card's GMM and
   ensemble masks and thresholds, their in-order truncations at 0.9 and
   0.7, the IQR fence, the AE mask and the in-step quantile keeps; K3
   (DBSCAN neighbour counts) on 40,000 x 512 clustered
   features, held to a float64 sandwich, its 3xTF32 d^2 error on sampled
   pairs held to its error band, the pairs it redecided in the band and
   its adjacency bitmask's size printed, and timed at 40,000 and at
   222,599 rows (the real ``zscore_dbscan`` mixture).
3. slice: ``final`` exactly as the preset ships it (``score_precision=
   "band_bf16"``), through the port's command line (``cli.run``) with
   ``--epochs 4 --max-synth 8192 --out <tmp> --checkpoint-every 1
   --save-samples-every 2 --parity-check``: z-score prefilter on ResNet18
   features, D-first steps at full model width (nz=100, ngf=ndf=64,
   64x64x3), batch 128, the loss-percentile strain at epoch 3 scored by the
   band path (bf16 bulk, f32 band), its LR cut; the outputs (PNGs read back,
   ``metrics.json``, checkpoints, fixed-noise grids, the parity report at
   1.0) are checked.
4. band: a fresh Trainer restored from the run's epoch-2 checkpoint strains
   at epoch 3; its mask must equal the uninterrupted run's, and the all-f32
   path (``score_d_losses`` + ``percentile_refine_mask``) on the same D must
   give the same mask (0 flips) and threshold.  Prints the band's statistics
   and K1's launches in the event, and times the band path against the f32
   path at the same N.
   chunked (final): the same ``final`` run again at ``steps_per_dispatch=1``
   (every step eager) from the same initial state and draws must equal the
   CLI run (32 steps a CUDA graph replay) bit for bit: parameters,
   BatchNorm buffers, Adam moments and step counts, loss series,
   per-sample losses, masks, epoch results, grids and console text, across
   the epoch-3 strain, its LR cut and the ``d_train`` flip; a Trainer
   restored from epoch 1 trains epochs 2-3 through the executor to the same
   epoch-3 mask and state; the host's time from the epoch-3 band scoring's
   return to the end of ``_fetch_epoch_stats`` and to the first training
   launch (the strain event's round trip).
   serve: a ``Sampler`` from the run's checkpoint makes 256 images at batch
   64 (a warm-up batch, then one graph replay a batch); replayed batches
   equal eager ones on the same noise; latency a batch, replayed and eager.
   deferred: ``final`` on the run's staged images for 6 epochs with the
   logger's no-history mode (``collect=False``) and no grids
   (``sample_every=0``), its strain keeping 40, 30 and 20 % of its base at
   epochs 3-5 (a shrinking count, each with a partial tail): epochs 4 and 5
   take the deferred-stats path (the stats fetched while the gated chunks
   run: each step of a chunk under a CUDA graph conditional IF node, the
   partial tail a gated one-step graph), and the run is bit-equal to the
   same run blocking.  Prints the conditional nodes, the deferred epochs,
   each strain event's host time from the strain's return to the first
   training launch on both paths (the chunked phase's method), a wholly
   dead chunk's launch time and a live gated step's time beside the
   ungated replay's.
5. zscore_dbscan: the ``zscore_dbscan`` preset at full width, batch 128, on
   its full synthetic mixture (40,000 images): the DBSCAN-calibrated
   z-score prefilter (K2, then K3 twice), then training.
6. loss_gmm, loss_ensemble, autoencoder: each preset at full width on the
   first 16,384 images of the ``zscore_dbscan`` mixture already on the
   card: every loss-space strain event launches K1, its GMM or ensemble
   threshold agrees with the CPU plain path's on the same losses (1e-5
   relative, flips counted with their distances), ``reset_each_epoch``
   restores the full set; the AE trains at epoch 3 and its mask agrees
   with the numpy oracle's (parity 1.0).  Seconds per strain event and
   the AE's training seconds are printed.
7. zscore_elbow and zscore: each preset up to its strain event.
8. basic: one epoch through the command line, no strainer (4,480 images,
   so that the epoch holds a full chunk).
9. zscore_loss: through the command line, epochs 0-3: the elbow prefilter
   (K2a, K2b) held to the numpy oracle's elbow mask (agreement >= 0.99, the
   repo's own bound), then the epoch-3 loss strain (K1) held to numpy's
   percentile, and the parity report at 1.0; without grids, so epoch 3
   takes the deferred-stats path.
10. batch_mask: through the command line with ``--epochs 11 --max-synth
   4096 --parity-check``, across the gate epoch (10): the ``Filtered
   CIFAR-10 images`` line equal to the epoch's counts, the last gated
   step's kept and valid lanes, the parity report at 1.0, s/step ungated
   and masked; then ``EAGER_STEPS`` (8) steps each of the masked, unmasked
   and unshared masked step timed (synchronised), and one
   ``obs/profiler.trace`` of ``TRACED_STEPS`` (5) masked steps: device
   operations per step, the device-busy share of the
   traced wall time and the ten operations with the most device time.
   chunked (batch_mask): the preset on the same images with
   ``mask_start_epoch=1``, 2 epochs (its configuration's epochs) at
   ``steps_per_dispatch`` 32 and 1,
   bit-equal as above (with the contamination counters and the parity
   report's last batch); then ms/step of replayed chunks against eager
   steps, masked and unmasked (synchronised), and a replayed masked chunk's
   device time (CUDA events) against its time through the executor, with a
   trace of one replayed chunk.
   dp: the data-parallel rank path on the card.  A child process (this
   script with ``--dp-child <dir>``) gets a launcher's environment of one
   rank (``RANK=0 WORLD_SIZE=1``, joining the store this script holds for
   it through ``parallel.multihost.Rendezvous``), so ``--dp 1``
   joins an NCCL group and the Trainer takes the rank path: its BatchNorm
   sums, loss denominators, gathered scores, gradient buckets and metrics
   go through NCCL collectives, recorded into the chunked executor's CUDA
   graphs.  Started before phase 5, it trains, beside phases 5-9 (whose
   seconds therefore include its load), ``batch_mask`` gated from epoch 1
   for 2 epochs (``--max-synth 4096``, a config JSON: the chunked phase's
   configuration) and ``zscore_loss`` as phase 9 runs it (the K2 prefilter, then the epoch-3 loss strain
   through the row-sharded scoring pass and K1), then waits, idle, until
   the chunked phase is done; each run must be bit-equal to the same run
   with no group, phase 9's and the chunked phase's (parameters,
   BatchNorm buffers, Adam state, losses, per-sample history, masks, last
   metrics, grids, console text); ``zscore_loss``'s epoch 3 is deferred
   there too, its gated chunks' conditional nodes around NCCL collectives.
   Prints the collectives, K1/K2a/K2b's
   launches on the rank path, and the replayed masked step's ms with and
   without the collectives, each timed alone on the card.  Multi-host
   staging: the child trains ``batch_mask`` again from its configuration
   on a copy of its images staged by ``DeviceDataset.from_rank_local`` (in
   a group of one rank the shard is every row): each step's lanes come in
   through the exchange (a reduce-scatter recorded into the graphs) and
   its strain event blocks; it must be bit-equal to the child's replicated
   run, and the replayed masked step is timed on both datasets with the
   exchange's bytes a step.  ``zscore_loss``'s prefilter and loss strain
   are made again by fresh engines with its trained D on its dataset and
   on such a copy (the passes read the rank's block, the base subset's
   rows come through the exchange): bit-equal, K1/K2a/K2b's launches on
   the sharded path printed.  The dp x tp helpers, on one 1 x 1 grid
   made in the child: one ``basic`` step at full width (batch 128, bf16)
   through ``put_state_tp`` must be bit-equal to the same seeded step with
   no group in this process, both timed over 3 eager steps; so must one
   step each of ``batch_mask`` and ``in_batch_recycle`` (the in-step keep
   on), ``strainer_concat_fast``'s pool step (its gate on, seeded pool
   rows), ``mnist8`` and ``mnist_full`` (keep masks from a seeded
   ``torch.Generator``), all as shipped at full width; then one chunk of
   ``TP_CHUNK`` (8) ``batch_mask`` steps captured (with the grid's tp
   gathers and their backward sums) and replayed on the grid must be
   bit-equal to the same steps eager on the grid.  Prints the collectives the
   capture recorded, and the masked step's ms replayed and eager on the
   grid beside its replayed ms with no group and on the rank path.
11. in_batch_recycle: through the command line with ``--epochs 4
   --max-synth 4500`` across its gate epoch (3): the reals the in-step keep
   drops replace fakes in D's fake batch; the same run at
   ``steps_per_dispatch=1`` bit-equal; the recycled lanes of each step of a
   replayed gated chunk, and ms/step replayed with and without recycling.
12. fake_pool: ``strainer_concat_fast`` through the command line with
   ``--epochs 4 --max-synth 3400`` per source: the z-score prefilter and
   the pool's outlier mask (K2a, K2b), the device-resident pool of 10% of
   the images drawn from the outliers (its size, outlier count and
   anime-like share printed), the pooled step (2x128 fake lanes) from the
   gate epoch 3 and the epoch-3 loss strain (K1); the same run at
   ``steps_per_dispatch=1`` bit-equal; a resume from epoch 2 to the same
   epoch-3 mask, pool and state; ms/step replayed with the pool, before
   its gate, and without it.
13. mnist8: through the command line with ``--epochs 2`` (the G-first
   MLP step at full width, 100-256-512-1024-784 / 784-1024-512-256-1, the
   auto batch of 64 from the staged digits): the same run at
   ``steps_per_dispatch=1`` bit-equal, its 28x28 grey grids read back,
   ms/step replayed and eager, and a ``Sampler`` serving its checkpoint
   (ms a batch of 64, replayed and eager, replayed batches bit-equal).
14. mnist_full: through the command line, for 3 epochs with its FID every
   3 (a config JSON), and ``--parity-check``: the 1-channel ResNet18 z-score prefilter (K2a and
   K2b at ``numpy_eps``, launched on the path) with a mask equal to the
   plain path's on the card and both kernels timed at its shape; the
   D-first dropout step, G with BatchNorm1d, labels 0.9/0.1 (a replayed
   chunk bit-equal to its 32 eager steps on the same noise and keep masks,
   consecutive replays with fresh masks, ms/step replayed and eager); the
   periodic FID at epoch 3 (real and contaminant, finite, with the
   seconds of the activation passes and of the square root, and its
   branch); the parity report at 1.0.
15. fid: the FID chain on ``tests/fixtures/backbones.npz`` (InceptionV3
   on synthetic weights, float32 with TF32 off): activations within 2e-3
   of the fixture, the FID within 2e-2 relative of its scipy value, and
   the Newton-Schulz trace within 1e-3 of eigh's on a well-conditioned
   2048-dimensional pair, each timed.
16. eval: the eval suite's ResNet50 (synthetic weights, float32 with TF32
   off) on the fixture's ``resnet50_features`` (rtol 1e-3, atol 1e-2, the
   JAX test's); the card's PCA-50 Wasserstein and mean feature distances
   on 409 x 2048 and 500 x 2048 seeded features held to float64 numpy
   (SVD, svd_flip, scipy's 1-D Wasserstein) at 1e-3 and 1e-5 relative;
   then ``strainer_gan`` through the command line with ``--epochs 1
   --max-synth 2560 --eval --eval-samples 500``: the six values finite and
   in ``metrics.json``, with the seconds of the feature passes, the SVDs
   and the FIDs.

Before the fixtures, the adam phase holds the card's capturable Adam
(``train/state.py::make_adam``) to the JAX package's ``optax.scale_by_adam``
updates in ``tests/fixtures/torch_port_jax_adam.npz``, eagerly and replayed
from a CUDA graph, at 1e-5.  Every phase that stages a mixture prints its
host seconds (``staging: native``), and the staging line sums them; the
host_staging phase, right after the build, times the generators and the
resize alone (native against its numpy plain version, bytes compared).

Every Trainer phase trains through the chunked executor as the presets ship
it (``steps_per_dispatch=32``: one CUDA graph replay a full chunk), prints
its graphs' capture and instantiation seconds and replays, and fails if no
chunk was replayed.  Launch counters are zeroed right before each path is
driven (``cli.run``, ``run()`` or ``setup()``) and read right after it.

Deviations from the presets, each for a reason:
- ``final``: ``--epochs 4`` (epoch 3 is the first strain event) and
  ``--max-synth 8192`` per source (16,384 images, 128 steps per epoch, to
  bound the run's time).  Nothing else: it scores by the shipped band path.
- ``final`` (deferred): 6 epochs (the strain epochs 4 and 5 are the first
  a warmed-up capture key lets defer) on the slice's images, its clean
  ratios changed so that the count shrinks.
- ``zscore_dbscan``: ``epochs=1`` (the prefilter is the preset's only
  strain event; further epochs repeat the same step).
- ``zscore_elbow``: ``max_synth=2048`` per source and only the prefilter
  (its only strain event).
- ``zscore``: ``max_synth=2048`` per source and epochs 0-3 (its one strain
  is at epoch 3).
- ``basic``: ``--max-synth 4480`` and one epoch (it never strains; 35
  steps: a sample-point step, a warm-up step and one chunk of 32).
- ``zscore_loss``: ``--max-synth 2560`` per source and epochs 0-3 (its
  first loss strain is at epoch 3; about 36 steps an epoch, so that an
  epoch holds a chunk); ``sample_every=0`` (a config JSON), so
  that its strain epoch is deferred, here and in the dp child.
- ``loss_gmm``, ``loss_ensemble``, ``autoencoder``: the first 16,384 of the
  ``zscore_dbscan`` phase's 40,000 staged images (their own data
  configuration, ``_CELEBA_CIFAR20K``), so nothing is staged twice; 2
  epochs for ``loss_gmm`` (strains at 0 and 1), 4 for the others (first
  strain at 3).
- ``batch_mask``: ``--epochs 11`` (epoch 10 is the first gated one) and
  ``--max-synth 4096`` (4,096 CelebA-like and 409 CIFAR-like images); in
  the chunked phase ``mask_start_epoch=1`` and 2 epochs on the same images
  (the gate within 2 epochs, for a run made twice; its configuration says
  2 epochs, so that the dp child's command-line run is the same run).
- ``in_batch_recycle``: ``--epochs 4`` (epoch 3 is its gate) and
  ``--max-synth 4500`` (36 steps an epoch with a 20-lane tail: after the
  run's first step, a sample point, a warm-up step and a chunk of 32).
- ``strainer_concat_fast``: ``--epochs 4`` (epoch 3 is its gate and first
  loss strain) and ``--max-synth 3400`` per source (6,800 images: about
  36 steps in epoch 3, after the prefilter and the strain, so that its
  resume still replays a chunk).
- ``mnist8``: ``--epochs 2`` of 300 (every epoch is the same step).
- ``mnist_full``: 3 epochs of 300 with ``fid_every_epochs=3`` (shipped
  100), through a config JSON: the periodic FID still fires on the shipped
  path, at epoch 3.  On an NVIDIA H100 80GB HBM3 (700 W) its 100 epochs
  took 48.5-56.1 s and its 20 epochs 17.6-22.6 s, most of it the eager
  remainder steps, and the script must stay well inside its time limit as
  phases are added.  Its data is whole (three synthetic
  60,000-image digit sources, as shipped).
- ``strainer_gan`` (eval): ``--epochs 1 --max-synth 2560`` per source (40
  steps, so that the epoch holds a chunk): the suite needs a trained G,
  not a long run.
- dp: world size 1 (the machine has one card); ``batch_mask`` and
  ``zscore_loss`` as their other phases cut them, each run twice there
  (replicated, then sample-sharded); the tp grid 1 x 1, one step a
  variant compared, and one chunk of the masked step.

The second-to-last lines are one JSON object of per-kernel results and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12  # HBM3, published
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, published
H100_3XTF32_FLOPS = 494.7e12 / 3  # float32 products as three TF32 products, published TF32
PR5_KEPT = 21_275  # zscore_dbscan prefilter kept, with the direct-form K3 on the same data
JAX_FIXTURE = HERE / "tests" / "fixtures" / "torch_port_jax_masks.npz"
FIXTURE_SEED = 7
JAX_LOSS_FIXTURE = HERE / "tests" / "fixtures" / "torch_port_jax_loss_masks.npz"
LOSS_FIXTURE_SEED = 11
LOSS_FIXTURE_TAIL = 77  # valid lanes of the fixture's partial score batch
LOSS_FIXTURE_RATIOS = (0.9, 0.7)  # loss_ensemble's clean ratios at epochs 3 and 7
FIXTURE_LOSS_RATIO = 0.8  # `final`'s clean-ratio schedule at epoch 3, passed as loss_ratio
# logits where sigmoid saturates to 1, or its float32 value is subnormal and flushed to 0
SATURATING_LOGITS = (30.0, -30.0, 120.0, -120.0, 99.5, -99.5, 87.5, -87.5,
                     100.0, -100.0, 87.3, -87.3, -88.0, 0.0)


def fixture_inputs(seed: int = FIXTURE_SEED) -> dict:
    """The inputs of the committed JAX outputs, made with numpy from ``seed``
    the same way on every machine.

    ``features``: 4,096 x 512 float32, clustered as ``k3_phase`` clusters
    (160-point clusters of spread 0.5 around centres of spread 4, 20% spread
    noise rows), about 1% outlier rows scaled by 3 and one constant column;
    standardised, the clusters lie far inside DBSCAN's eps = 20 and the
    noise rows far outside it, so the clean ratio is about 0.8.  ``valid``:
    about 90% of the rows.  ``logits``: 8,192 float32 D logits (spread 8,
    a uniform stretch over the -100 clamp, and ``SATURATING_LOGITS``);
    ``loss_valid``: about 90% of them.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    n, d = 4096, 512
    centers = rng.standard_normal((n // 160 + 1, d)) * 4.0
    x = centers[rng.integers(0, centers.shape[0], n)] + rng.standard_normal((n, d)) * 0.5
    noise = rng.random(n) < 0.2
    x[noise] = rng.standard_normal((int(noise.sum()), d)) * 4.0
    x[rng.choice(n, n // 100, replace=False)] *= 3.0
    x[:, 7] = 3.0
    m = 8192 - 1024 - len(SATURATING_LOGITS)
    logits = np.concatenate([rng.standard_normal(m) * 8.0, rng.uniform(-110.0, 110.0, 1024),
                             SATURATING_LOGITS])
    return dict(features=x.astype(np.float32), valid=rng.random(n) > 0.1,
                logits=logits.astype(np.float32), loss_valid=rng.random(8192) > 0.1)


def loss_fixture_inputs(seed: int = LOSS_FIXTURE_SEED) -> dict:
    """The inputs of the committed loss-space JAX outputs, made with numpy
    from ``seed``.

    ``losses``: 40,000 float32 BCE-like losses, a clean log-normal mode
    (80%, median 0.3) and a noisy one (20%, median 2.2), shuffled;
    ``loss_valid``: about 90% of them.  ``ae_errors``: 16,384 float32
    reconstruction errors (gamma, mean 0.04) with 2% of them tripled.
    ``batch_scores``: two 128-lane batches of D probabilities in (0, 1), the
    second one a partial tail whose first ``LOSS_FIXTURE_TAIL`` lanes are
    valid.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    n, k = 40_000, 8_000
    losses = np.concatenate([np.exp(rng.normal(np.log(0.3), 0.5, n - k)),
                             np.exp(rng.normal(np.log(2.2), 0.4, k))])
    rng.shuffle(losses)
    ae = rng.gamma(4.0, 0.01, 16_384)
    ae[rng.choice(ae.size, ae.size // 50, replace=False)] *= 3.0
    scores = 1.0 / (1.0 + np.exp(-rng.normal(0.0, 2.0, (2, 128))))
    return dict(losses=losses.astype(np.float32), loss_valid=rng.random(n) > 0.1,
                ae_errors=ae.astype(np.float32), batch_scores=scores.astype(np.float32))


JAX_ADAM_FIXTURE = HERE / "tests" / "fixtures" / "torch_port_jax_adam.npz"
ADAM_FIXTURE_SEED = 13
# a conv kernel (torch layout), a BatchNorm scale and a bias
ADAM_SHAPES = {"conv": (8, 4, 4, 4), "bn_scale": (16,), "bias": (16,)}
ADAM_BETAS = ((0.5, 0.999), (0.9, 0.999))  # the presets', torch's defaults
ADAM_RATES = (2e-4, 1e-4)
ADAM_UPDATES = 5
ADAM_CUT_AT = 3  # updates from this one on run at a tenth of the rate (the LR cut)
ADAM_TOL = 1e-5


def adam_rates(rate: float) -> list:
    """The rate of each update: ``rate``, then the cut ``rate * 0.1``, as
    ``train/schedules.py::lr_at`` gives it."""
    return [rate if t < ADAM_CUT_AT else rate * 0.1 for t in range(ADAM_UPDATES)]


def adam_fixture_inputs(seed: int = ADAM_FIXTURE_SEED) -> dict:
    """The inputs of the committed Adam updates, made with numpy from
    ``seed``: each tensor's initial value (``init_*``; the BatchNorm scale
    about 1, the others about 0.02) and one float32 gradient an update
    (``grads_*``, (updates,) + shape), its elements' magnitudes spread
    log-uniformly from 1e-7 to 1e-1, so that eps = 1e-8 matters for some."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in ADAM_SHAPES.items():
        init = rng.standard_normal(shape) * 0.02 + (1.0 if name == "bn_scale" else 0.0)
        scale = 10.0 ** rng.uniform(-7, -1, (ADAM_UPDATES,) + shape)
        out[f"init_{name}"] = init.astype(np.float32)
        out[f"grads_{name}"] = (rng.standard_normal(scale.shape) * scale).astype(np.float32)
    return out


def adam_gaps(torch, np, fixture, inputs: dict, device, replay: bool) -> dict:
    """``train/state.py::make_adam``'s optimizer (capturable on the card)
    run through the fixture's updates at every pair of betas and rate, with
    ``set_lr`` before each update; with ``replay`` the first update runs
    eagerly (it makes Adam's state) and every later one is a replay of one
    captured ``opt.step()``.  Returns the largest gap of each kind over
    every tensor and update: parameters absolute, Adam's moments relative
    to their tensor's largest magnitude."""
    from strainer_gan_tpu_torch.train.state import make_adam, set_lr
    from strainer_gan_tpu_torch.train.steps import capturing

    worst = dict(params=0.0, mu=0.0, nu=0.0)
    for bi, betas in enumerate(ADAM_BETAS):
        for ri, rate in enumerate(ADAM_RATES):
            mod = torch.nn.ParameterDict({
                n: torch.nn.Parameter(torch.tensor(inputs[f"init_{n}"], device=device))
                for n in ADAM_SHAPES})
            opt = make_adam(mod, rate, betas)
            for n, p in mod.items():
                p.grad = torch.zeros_like(p)
            graph = None
            for t, lr in enumerate(adam_rates(rate)):
                for n, p in mod.items():
                    p.grad.copy_(torch.from_numpy(inputs[f"grads_{n}"][t]))
                set_lr(opt, lr)
                if not replay or t == 0:
                    opt.step()
                else:
                    if graph is None:
                        graph = torch.cuda.CUDAGraph()
                        with capturing(graph):
                            opt.step()
                    graph.replay()
                for n, p in mod.items():
                    tag = f"{n}_b{bi}_r{ri}"
                    st = opt.state[p]
                    got = dict(params=p.detach(), mu=st["exp_avg"], nu=st["exp_avg_sq"])
                    for k, v in got.items():
                        want = fixture[f"{k}_{tag}"][t]
                        gap = float(np.abs(v.cpu().numpy().astype(np.float64) - want).max())
                        if k != "params":
                            gap /= max(float(np.abs(want).max()), 1e-30)
                        worst[k] = max(worst[k], gap)
    return worst


def input_digests(inputs: dict) -> dict:
    """SHA-256 of each input's bytes."""
    import hashlib

    return {k: hashlib.sha256(v.tobytes()).hexdigest() for k, v in inputs.items()}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


CARD = "unknown"  # nvidia-smi's "name, power.limit", set in main()


def graphs(tr, name: str) -> str:
    """The Trainer's CUDA graph counts as text; a phase that trained must
    have replayed at least one chunk."""
    gs = tr.graph_stats
    check(gs["replays"] > 0, f"{name}: no chunk was replayed from a CUDA graph")
    cap = ", ".join(f"{c:.2f}+{i:.2f}" for c, i in zip(gs["capture_s"], gs["instantiate_s"]))
    return (f"graphs: {gs['captures']} captured (capture+instantiate s: {cap}), "
            f"{gs['replays']} chunks of {tr.cfg.train.steps_per_dispatch} replayed")


STAGING = []  # (phase, images, host seconds) of every phase that staged a mixture


def staging(tr, name: str) -> None:
    """Print the host seconds the Trainer took to build its mixture (the
    synthetic generators, then resize, crop and gather through the port's
    host-staging library, ``native``)."""
    check(tr.staging_seconds is not None, f"{name}: the Trainer staged no mixture")
    STAGING.append((name, tr.dataset.n, tr.staging_seconds))
    phase(name, f"staging: native, {tr.staging_seconds:.2f} s for {tr.dataset.n} images "
          f"(host, {CARD})")


REPLAYED_CHUNKS = 2  # chunk executor calls a replay timing, after one


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int = 100, replays: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    cost per call is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(torch, graph.replay, iters=replays, warmup=2) / calls


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, port):
    """Each kernel at main-path shapes against its plain version."""
    import torch.nn.functional as F
    from strainer_gan_tpu_torch.kernels import bce as KB, zscore as KZ
    from strainer_gan_tpu_torch.strain import thresholds as TH

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = []

    # ---- K1: (N,) logits of the base subset, N = 70,000, incl. saturation
    n = 70_000
    x = torch.randn(n, generator=g, device=dev) * 8.0
    x[:len(SATURATING_LOGITS)] = torch.tensor(SATURATING_LOGITS)
    err = 0.0
    buf = torch.empty_like(x)
    for t in (1.0, 0.0, 0.9):
        got, ref = KB.bce_scores(x, t), KB.bce_scores_plain(x, t)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 non-finite at t={t}")
        bad = (got - ref).abs() > 2e-6 * ref.abs().clamp_min(1.0)
        check(not bool(bad.any()), f"K1 disagrees with its plain version at t={t}: "
              f"{int(bad.sum())} lanes beyond 2e-6 * max(1, |ref|)")
        err = max(err, float((got - ref).abs().max()))
        # into a given buffer, and over the logits themselves (the scoring pass)
        check(KB.bce_scores(x, t, out=buf) is buf and torch.equal(buf, got),
              f"K1 with out= differs at t={t}")
        inplace = x.clone()
        KB.bce_scores(inplace, t, out=inplace)
        check(torch.equal(inplace, got), f"K1 in place differs at t={t}")
    ones = torch.ones_like(x)

    def library():
        return F.binary_cross_entropy(torch.sigmoid(x), ones, reduction="none")

    # back to back (host and device), as the scoring pass calls it (out= its
    # logit buffer) and allocating; then device time alone, from CUDA graphs
    t_k = time_ms(torch, lambda: KB.bce_scores(x, 1.0, out=buf))
    t_ka = time_ms(torch, lambda: KB.bce_scores(x, 1.0))
    t_p = time_ms(torch, lambda: KB.bce_scores_plain(x, 1.0))
    t_l = time_ms(torch, library)
    g_k = graph_ms(torch, lambda: KB.bce_scores(x, 1.0, out=buf))
    g_l = graph_ms(torch, library)
    buf.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        KB.bce_scores(x, 1.0, out=buf)
    graph.replay()
    ref = KB.bce_scores_plain(x, 1.0)
    torch.cuda.synchronize()
    check(not bool(((buf - ref).abs() > 2e-6 * ref.abs().clamp_min(1.0)).any()),
          "K1 replayed from a CUDA graph disagrees with its plain version")
    b, by = bound_ms(8.0 * n, 12.0 * n)
    phase("kernels", f"K1 bce_scores N={n}: max_abs_err={err:.3g} (tol 2e-6*max(1,|ref|)); "
          f"out= and in place bit-equal to the allocating call; back to back: "
          f"kernel_ms={t_k:.5f} (out=) {t_ka:.5f} (allocating) plain_ms={t_p:.5f} "
          f"library_ms={t_l:.5f}; device only (CUDA graph of 100, replayed): "
          f"kernel_ms={g_k:.5f} library_ms={g_l:.5f}, so the host adds "
          f"{t_k - g_k:.5f} / {t_l - g_l:.5f} ms a call; bound_ms={b:.5f}; "
          f"graph replay agrees with plain")
    results.append(dict(name="bce_scores", route="cuda",
                        source="strainer_gan_tpu_torch/csrc/bce.cu",
                        replaces="strainer_gan_tpu/kernels/bce.py:22", max_abs_err=err,
                        ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=t_l))

    # ---- K2: (N, 512) features, ~10% invalid rows, one constant column
    n, d = 70_000, 512
    f = torch.randn((n, d), generator=g, device=dev) * 2.0 + 0.5
    f[torch.randperm(n, generator=g, device=dev)[:700]] *= 3.0  # outlier rows
    f[:, 7] = 3.0  # a constant column
    valid = torch.rand(n, generator=g, device=dev) > 0.1
    err_a = err_b = 0.0
    n_near = 0
    for mode in ("torch", "numpy_eps"):
        for v in (valid, None):
            mean, std = KZ.column_stats(f, v, mode)
            mean_p, std_p = KZ.column_stats_plain(f, v, mode)
            torch.cuda.synchronize()
            for got, ref, what in ((mean, mean_p, "mean"), (std, std_p, "std")):
                bad = (got - ref).abs() > 1e-5 * ref.abs().clamp_min(1.0)
                check(not bool(bad.any()), f"K2a {what} ({mode}) disagrees with plain")
                err_a = max(err_a, float((got - ref).abs().max()))
            # the constant column: std is exactly the mode's eps, so z = 0 there
            check(float(std[7]) == float(std_p[7]) == (0.0 if mode == "torch" else
                                                       float(torch.tensor(1e-7))),
                  f"K2a std of the constant column ({mode})")
            z = KZ.row_max_abs_z(f, mean, std)
            z_p = KZ.row_max_abs_z_plain(f, mean, std)
            torch.cuda.synchronize()
            err_b = max(err_b, float((z - z_p).abs().max()))
            check(torch.equal(z, z_p), f"K2b is not bit-equal to its plain version ({mode})")
            # the composed statistic and its mask at threshold 5.0
            mz = KZ.masked_max_abs_z(f, v, mode)
            mz_p = TH._masked_max_abs_z(f, v, mode)
            m, _ = TH.zscore_threshold_mask(mz, 5.0, True, v)
            m_p, _ = TH.zscore_threshold_mask(mz_p, 5.0, True, v)
            near = (mz_p - 5.0).abs() <= 1e-5 * 5.0
            diff = m != m_p
            check(not bool((diff & ~near).any()), f"K2 mask differs away from the threshold ({mode})")
            n_near += int(diff.sum())
            check(bool(torch.isfinite(mz).all()), "K2 non-finite max|z|")
    t_a = time_ms(torch, lambda: KZ.column_stats(f, None, "torch"), iters=20)
    t_ap = time_ms(torch, lambda: KZ.column_stats_plain(f, None, "torch"), iters=20)
    t_al = time_ms(torch, lambda: torch.std_mean(f, dim=0, correction=1), iters=20)
    mean, std = KZ.column_stats(f, None, "torch")
    t_b = time_ms(torch, lambda: KZ.row_max_abs_z(f, mean, std), iters=20)
    t_bp = time_ms(torch, lambda: KZ.row_max_abs_z_plain(f, mean, std), iters=20)
    # a yardstick of one read of F, not the same function: PyTorch's row max
    t_read = time_ms(torch, lambda: f.amax(dim=1), iters=20)
    ba, bya = bound_ms(4.0 * n * d + 8.0 * d, 4.0 * n * d)
    bb, byb = bound_ms(4.0 * n * d + 8.0 * d + 4.0 * n, 4.0 * n * d)
    phase("kernels", f"K2a zscore_column_stats {n}x{d}: max_abs_err={err_a:.3g} "
          f"(tol 1e-5*max(1,|ref|)) kernel_ms={t_a:.5f} plain_ms={t_ap:.5f} "
          f"library_ms={t_al:.5f} (torch.std_mean) bound_ms={ba:.5f}")
    phase("kernels", f"K2b zscore_row_max {n}x{d}: max_abs_err={err_b:.3g} (bit-equal) "
          f"kernel_ms={t_b:.5f} plain_ms={t_bp:.5f} bound_ms={bb:.5f} "
          f"(one read of F by torch.amax(f, dim=1): {t_read:.5f} ms); "
          f"mask at 5.0 differs only within 1e-5 of it: {n_near} lanes")
    results.append(dict(name="zscore_column_stats", route="cuda",
                        source="strainer_gan_tpu_torch/csrc/zscore.cu",
                        replaces="strainer_gan_tpu/kernels/zscore.py:30", max_abs_err=err_a,
                        ms=t_a, plain_ms=t_ap, bound_ms=ba, bound_by=bya, library_ms=t_al))
    results.append(dict(name="zscore_row_max", route="cuda",
                        source="strainer_gan_tpu_torch/csrc/zscore.cu",
                        replaces="strainer_gan_tpu/kernels/zscore.py:78", max_abs_err=err_b,
                        ms=t_b, plain_ms=t_bp, bound_ms=bb, bound_by=byb, library_ms=None))
    return results


def jax_fixture_phase(torch, np):
    """The card's strain decisions against the JAX package's, on the inputs
    of ``JAX_FIXTURE`` (written on the CPU by tests/test_torch_jax_fixture.py).

    The inputs are made again from their seed and must hash as stored.  On
    the card: max-|z| through K2a+K2b and its fixed (5.0), elbow and quantile
    masks; the clean ratio through K2a+K3 (standardise, two passes); the
    losses through K1 and their percentile mask.  A z-score flip must lie
    within 1e-5 (relative) of the JAX threshold; the clean ratio inside the
    stored float64 sandwich; the losses within K1's 2e-6 * max(1, |ref|) of
    the JAX losses, and the loss mask must flip nothing."""
    from strainer_gan_tpu_torch.kernels import bce as KB
    from strainer_gan_tpu_torch.ops import dbscan as DB
    from strainer_gan_tpu_torch.strain import thresholds as TH

    with np.load(JAX_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    inputs = fixture_inputs()
    for k, digest in input_digests(inputs).items():
        check(str(ref[f"sha256_{k}"]) == digest, f"fixture input {k} is not the one stored")
    dev = torch.device("cuda")
    f = torch.from_numpy(inputs["features"]).to(dev)
    valid = torch.from_numpy(inputs["valid"]).to(dev)

    def flips(key, mask, scores):
        """Lanes where ``mask`` differs from the stored one, and each one's
        distance to the JAX threshold, relative to it."""
        diff = mask.cpu().numpy() != ref[key]
        thr = float(ref[key.replace("_", "_thr_", 1)])
        dist = np.abs(scores[diff].astype(np.float64) - thr) / abs(thr)
        worst = float(dist.max()) if diff.any() else 0.0
        check(worst <= 1e-5, f"{key}: a flip lies {worst:.3g} (relative) from the JAX "
              f"threshold {thr}, beyond 1e-5")
        return f"{int(diff.sum())}" + (f" (at {', '.join(f'{x:.2g}' for x in dist)})"
                                        if diff.any() else "")

    for m in ("all", "valid"):
        v = valid if m == "valid" else None
        ratio = DB.dbscan_clean_ratio(f, 20.0, 3, v)
        k = round(float(ratio) * (int(valid.sum()) if v is not None else f.shape[0]))
        lo, hi = (int(c) for c in ref[f"sandwich_{m}"])
        check(lo <= k <= hi, f"clean ratio ({m}): {k} non-noise outside the float64 "
              f"sandwich [{lo}, {hi}]")
        for mode in ("torch", "numpy_eps"):
            tag = f"{mode}_{m}"
            mz = TH.masked_max_abs_z(f, v, mode)
            scores = mz.cpu().numpy()
            want = ref[f"mz_{tag}"]
            rel = float(np.max(np.abs(scores - want) / np.maximum(1.0, np.abs(want))))
            fixed = flips(f"fixed_{tag}", TH.zscore_threshold_mask(mz, 5.0, True, v)[0], scores)
            elbow_mask, elbow_thr = TH.zscore_elbow_mask(mz, v)
            elbow = flips(f"elbow_{tag}", elbow_mask, scores)
            quant_mask, quant_thr = TH.zscore_quantile_mask(mz, ratio, v)
            quant = flips(f"quantile_{tag}", quant_mask, scores)
            phase("jax_fixture", f"{mode} std, {m} rows: max|z| within {rel:.3g} of JAX's "
                  f"(relative to max(1, |ref|)); flips against JAX: fixed 5.0 {fixed}, "
                  f"elbow {elbow} (threshold {float(elbow_thr):.8g}, JAX "
                  f"{float(ref[f'elbow_thr_{tag}']):.8g}), quantile {quant} (clean ratio "
                  f"{float(ratio):.8g}, JAX {float(ref[f'ratio_{m}']):.8g}, {k} non-noise in "
                  f"[{lo}, {hi}]; threshold {float(quant_thr):.8g}, JAX "
                  f"{float(ref[f'quantile_thr_{tag}']):.8g})")
    x = torch.from_numpy(inputs["logits"]).to(dev)
    loss_valid = torch.from_numpy(inputs["loss_valid"]).to(dev)
    for t in (1.0, 0.9):
        losses = KB.bce_scores(x, t)
        want = torch.from_numpy(ref[f"loss_{t}"]).to(dev)
        err = float(((losses - want).abs() / want.abs().clamp_min(1.0)).max())
        check(err <= 2e-6, f"K1 losses at t={t} differ from JAX's by {err:.3g} of max(1, |ref|)")
        mask, thr = TH.percentile_refine_mask(losses, FIXTURE_LOSS_RATIO, loss_valid)
        n_flip = int((mask.cpu().numpy() != ref[f"loss_mask_{t}"]).sum())
        check(n_flip == 0, f"loss mask at t={t}: {n_flip} lanes flipped against JAX")
        phase("jax_fixture", f"K1 target {t}: losses within {err:.3g} of JAX's (relative to "
              f"max(1, |ref|), tol 2e-6); percentile mask at loss_ratio {FIXTURE_LOSS_RATIO} "
              f"flips 0 of {x.shape[0]} (threshold {float(thr):.8g}, JAX "
              f"{float(ref[f'loss_thr_{t}']):.8g})")


def k3_phase(torch):
    """K3 against a float64 sandwich at 40,000 rows; timed at 40,000 and at
    222,599 rows (CelebA's 202,599 + 20,000 CIFAR, the real mixture)."""
    from strainer_gan_tpu_torch.device import f32_math
    from strainer_gan_tpu_torch.kernels import pairwise as KP

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    d, delta = 512, 1e-4

    def clustered(n):
        # 160-point clusters (spread 0.5 per feature, so within-cluster
        # distances are about 16) plus 20% spread noise rows (about 128 away)
        centers = torch.randn((n // 160 + 1, d), generator=g, device=dev) * 4.0
        x = centers[torch.randint(0, centers.shape[0], (n,), generator=g, device=dev)]
        x = x + torch.randn((n, d), generator=g, device=dev) * 0.5
        noise = torch.rand(n, generator=g, device=dev) < 0.2
        x[noise] = torch.randn((int(noise.sum()), d), generator=g, device=dev) * 4.0
        valid = torch.rand(n, generator=g, device=dev) > 0.1
        return x.contiguous(), valid

    n = 40_000
    x, valid = clustered(n)
    eps = 16.0  # the typical within-cluster distance: many pairs near eps
    x64 = x.double()
    lo_eps, hi_eps = eps * (1 - delta) ** 0.5, eps * (1 + delta) ** 0.5
    n_band = n_clear = 0
    err = 0.0
    ratios = []
    redecided = []
    for v in (valid, None):
        got = KP.neighbor_counts(x, eps, v)
        redecided.append(KP.last_band_pairs)
        lo = KP.neighbor_counts_plain(x64, lo_eps, v)
        hi = KP.neighbor_counts_plain(x64, hi_eps, v)
        torch.cuda.synchronize()
        check(bool((lo <= got).all()) and bool((got <= hi).all()),
              "K3 counts outside the float64 sandwich")
        clear = lo == hi
        exact = KP.neighbor_counts_plain(x64, eps, v)
        check(torch.equal(got[clear], exact[clear]),
              "K3 counts differ from float64 on rows with no pair in the band")
        err = max(err, float((got - exact).abs().max()))
        n_band += int((~clear).sum())
        n_clear += int(clear.sum())
        mask = KP.dbscan_non_noise(x, eps, 3, v)
        m_lo = KP.dbscan_non_noise_plain(x64, lo_eps, 3, v)
        m_hi = KP.dbscan_non_noise_plain(x64, hi_eps, 3, v)
        check(not bool((m_lo & ~mask).any()) and not bool((mask & ~m_hi).any()),
              "K3 non-noise mask outside the float64 sandwich")
        denom = float(v.sum()) if v is not None else float(n)
        r, r_lo, r_hi = (float(m.sum()) / denom for m in (mask, m_lo, m_hi))
        check(r_lo <= r <= r_hi and 0.05 < r < 0.95, f"K3 ratio {r} vs [{r_lo}, {r_hi}]")
        ratios.append((r, r_lo, r_hi))
        if v is not None:
            check(not bool(got[~v].any()), "K3 counted an invalid row")
    phase("kernels", f"K3 neighbor_counts {n}x{d} eps={eps}: float64 sandwich at "
          f"eps^2 (1 -/+ {delta}) holds for counts and non-noise masks, with and without "
          f"valid; counts exact on {n_clear} rows with no pair in the band "
          f"({n_band} band rows, max |count - float64 count| {err:g}); non-noise ratio "
          f"(masked, unmasked) "
          + ", ".join(f"{r:.6f} in [{a:.6f}, {b:.6f}]" for r, a, b in ratios))
    # the 3xTF32 Gram's error on a sample of pairs (row tile 0 against the
    # first 8 column tiles), against float64, beside the band's half-width
    tile, n_tiles = KP.TILE, 8
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    _, _, d2 = KP._counts_cuda(x, eps, None, ones, want_adjacency=False,
                               sample_tiles=n_tiles)
    sq64 = (x64 * x64).sum(1)
    worst = 0.0
    for j in range(n_tiles):
        cols = slice(j * tile, (j + 1) * tile)
        s2 = sq64[:tile, None] + sq64[None, cols]
        exact = s2 - 2.0 * x64[:tile] @ x64[cols].T
        worst = max(worst, float(((d2[j].double() - exact).abs() / s2).max()))
    tau = KP.band_tau_coef(-(-d // KP.FEATURE_STEP) * KP.FEATURE_STEP)
    check(worst <= tau, f"K3's 3xTF32 d^2 error {worst:.3g} (sq_i + sq_j) exceeds its "
          f"band {tau:.3g}")
    t1 = -(-n // tile)
    mask_bytes = t1 * (t1 + 1) // 2 * KP.TILE_WORDS * 4
    phase("kernels", f"K3 pass 1 redecided {redecided[0]} (masked) / {redecided[1]} "
          f"(unmasked) band pairs by the direct form; max |d2_3xTF32 - d2_f64| / "
          f"(sq_i + sq_j) over {n_tiles * tile * tile} sampled pairs {worst:.4g} against "
          f"tau {tau:.4g}; adjacency bitmask {mask_bytes} bytes")

    def times(n, x, valid, iters, warmup):
        t_k = time_ms(torch, lambda: KP.dbscan_non_noise(x, eps, 3, valid), iters, warmup)
        t_p = time_ms(torch, lambda: KP.dbscan_non_noise_plain(x, eps, 3, valid), iters, warmup)

        def blocked_mm():
            with f32_math():
                for lo in range(0, n, KP.PLAIN_BLOCK):
                    torch.mm(x[lo:lo + KP.PLAIN_BLOCK], x.T)
        t_mm = 2 * time_ms(torch, blocked_mm, iters, warmup)  # two passes
        # The least work of the function: d^2 is symmetric, so the Gram of
        # the N(N+1)/2 pairs once (2D flops a pair); pass 2 only reweights
        # pass 1's adjacency, kept as a bitmask (written once, read once).
        flops = n * (n + 1.0) * d
        mask_bytes = 2 * (n * (n + 1.0) / 2 / 8)
        io_bytes = 4.0 * n * d + n + n  # features, valid in, non-noise out
        b, by = max((flops / H100_3XTF32_FLOPS * 1e3, "operations"),
                    ((io_bytes + mask_bytes) / H100_BYTES_PER_S * 1e3, "bytes"))
        phase("kernels", f"K3 dbscan_non_noise N={n}: kernel_ms={t_k:.3f} (2 launches; "
              f"{KP.last_band_pairs} band pairs redecided) plain_ms={t_p:.3f} "
              f"bound_ms={b:.3f} (by {by}: symmetric half once at 3xTF32 164.9 TFLOP/s "
              f"plus a bitmask of {mask_bytes / 2e9:.3f} GB; "
              f"{flops / H100_F32_FLOPS * 1e3:.3f} at the f32 CUDA-core 67 TFLOP/s) "
              f"library_ms=null; f32 torch.mm of the same products (TF32 off, 2 passes "
              f"of {KP.PLAIN_BLOCK}-row blocks): {t_mm:.3f} ms")
        return t_k, t_p, b, by

    t_k, t_p, b, by = times(n, x, valid, iters=5, warmup=1)
    del x64
    n_big = 222_599
    xb, vb = clustered(n_big)
    big = times(n_big, xb, vb, iters=1, warmup=0)
    del xb, vb
    torch.cuda.empty_cache()
    return dict(name="neighbor_counts", route="cuda",
                source="strainer_gan_tpu_torch/csrc/pairwise.cu",
                replaces="strainer_gan_tpu/kernels/pairwise.py:25", max_abs_err=err,
                ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=None,
                ms_222599=big[0], plain_ms_222599=big[1], bound_ms_222599=big[2])


def check_png(path: Path, width: int, height: int, channels: int = 3) -> None:
    """``path`` is a whole 8-bit RGB (or, with ``channels=1``, greyscale)
    PNG of ``width`` x ``height``: the signature, every chunk's CRC, IHDR,
    IEND, and IDAT inflating to one filter byte plus ``channels * width``
    bytes per row."""
    import struct
    import zlib

    data = path.read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path.name}: not a PNG")
    pos, ihdr, idat, end = 8, None, b"", False
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        check(zlib.crc32(tag + body) & 0xFFFFFFFF == crc, f"{path.name}: bad CRC in {tag}")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        end = tag == b"IEND"
        pos += 12 + length
    color = {3: 2, 1: 0}[channels]
    check(ihdr is not None and ihdr[:4] == (width, height, 8, color) and end,
          f"{path.name}: header {ihdr}, want {width}x{height}x{channels} 8-bit, ending in IEND")
    check(len(zlib.decompress(idat)) == height * (1 + channels * width),
          f"{path.name}: pixel data")


def grid_side(n: int, nrow: int, size: int = 64, padding: int = 2) -> tuple:
    """(width, height) of ``make_grid``'s grid of ``n`` images."""
    return nrow * (size + padding) + padding, -(-n // nrow) * (size + padding) + padding


def epoch_step_times(tr, bs: int) -> list:
    """The logger's host seconds per step, split by epoch (the epochs'
    step counts from their masks: drop_last=False batches)."""
    times, out, i = tr.logger.step_times, [], 0
    for m in tr.mask_history:
        steps = -(-int(m.sum()) // bs)
        out.append(times[i:i + steps])
        i += steps
    check(i == len(times), "step timings do not cover the epochs' steps")
    return out


def slice_phase(torch, np, out_dir: Path):
    """``final`` as shipped, through the port's command line."""
    from strainer_gan_tpu_torch import cli, get_preset, kernels
    from strainer_gan_tpu_torch.train.state import get_lr

    args = ["--preset", "final", "--epochs", "4", "--max-synth", "8192", "--out", str(out_dir),
            "--checkpoint-every", "1", "--save-samples-every", "2", "--parity-check"]
    phase("slice", "python -m strainer_gan_tpu_torch.cli " + " ".join(args))
    tee = Tee(sys.stdout)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        tr, results = cli.run(args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()

    staging(tr, "slice")
    cfg = tr.cfg
    shipped = get_preset("final")
    check(cfg == shipped.replace(train=dataclasses.replace(shipped.train, epochs=4)),
          "the final preset was changed beyond --epochs")
    check(cfg.strain.score_precision == "band_bf16", "final does not score by the band path")
    eng = tr.engine
    base = eng.base_active.cpu().numpy()
    refined = tr.mask_history[3]
    check(get_lr(tr.opt_d) == float(np.float32(cfg.train.lr_d * cfg.train.lr_decay_factor)),
          "no LR cut at epoch 3")
    check(0 < base.sum() <= tr.dataset.n, "empty prefilter mask")
    check(all(np.array_equal(m, base) for m in tr.mask_history[:3]), "strained before epoch 3")
    check(0 < refined.sum() < base.sum() and not refined[~base].any(),
          "strain mask empty or outside the prefilter base")
    n_steps = len(tr.logger.step_times)
    losses = tr.logger.D_losses + tr.logger.G_losses
    check(n_steps == results["summary"]["steps"] and len(losses) == 2 * n_steps
          and np.all(np.isfinite(losses)), "non-finite or missing losses")
    check(eng.last_score_path == "band", f"epoch 3 scored by the {eng.last_score_path} path")
    # the strain decision against numpy's percentile on the same (hybrid) scores
    scores = eng.last_scores.cpu().numpy()
    thr = float(eng.last_threshold)
    thr_np = float(np.percentile(scores[base].astype(np.float64), 20.0))
    check(abs(thr - thr_np) <= 1e-6 * max(1.0, abs(thr_np)), f"threshold {thr} vs numpy {thr_np}")
    check(np.array_equal(refined, base & (scores < thr)), "strain mask is not loss < threshold")
    parity = results.get("parity", {})
    check(parity.get("method") == "loss_percentile" and parity.get("agreement") == 1.0,
          f"parity report {parity}")
    with open(out_dir / "metrics.json") as f:
        check(json.load(f) == results, "metrics.json is not the printed result")
    check_png(out_dir / "samples.png", *grid_side(64, 8))
    for e in (2, 4):
        check_png(out_dir / f"samples_epoch{e}.png", *grid_side(25, 5))
    check(all((out_dir / "ckpt" / f"epoch_{e}" / "state.pt").exists() for e in range(4)),
          "a checkpoint is missing")
    te = cfg.train.sample_every
    want_grids = len(range(0, n_steps, te)) + ((n_steps - 1) % te != 0)
    check(len(tr.img_list) == want_grids and all(np.isfinite(g).all() for g in tr.img_list),
          f"{len(tr.img_list)} fixed-noise grids, want {want_grids}")
    check(len(tr.epoch_loss_history) == 4
          and [len(h) for h in tr.epoch_loss_history] == [int(m.sum()) for m in tr.mask_history],
          "per-epoch loss history")
    with torch.no_grad():
        fake = tr.gen(torch.randn((4, cfg.model.nz), device="cuda"), train=False)
    check(tuple(fake.shape) == (4, 3, 64, 64) and bool(torch.isfinite(fake).all()),
          "generator output")
    for name in ("bce_scores", "zscore_column_stats", "zscore_row_max"):
        check(launches[name] > 0, f"kernel {name} never launched on the main path")

    n_rescored, fell_back, drift = eng.last_band_stats.tolist()
    phase("slice", f"{tr.dataset.n} images, G/D at nz={cfg.model.nz} ngf={cfg.model.ngf} "
          f"ndf={cfg.model.ndf}, compute {cfg.model.compute_dtype}, batch "
          f"{cfg.data.batch_size}, score_precision {cfg.strain.score_precision}; "
          f"whole CLI run {total:.2f} s ({results['wall_s']} s by its own clock)")
    quality = "".join(f", removed {q['removed']} with precision {q['precision']:.4f} "
                      f"recall {q['recall']:.4f} against the contamination labels"
                      for q in tr.strain_quality)
    phase("slice", f"prefilter kept {int(base.sum())}/{tr.dataset.n} (threshold "
          f"{cfg.strain.z_threshold}); epoch 3 strain kept {int(refined.sum())}/"
          f"{int(base.sum())}, loss threshold {thr:.8g}{quality}; band: re-scored "
          f"{n_rescored:.0f}, fell back to f32 {fell_back:.0f}, max normalised drift "
          f"{drift:.3g} (half-band {cfg.strain.band_eps / 2}); parity {json.dumps(parity)}")
    per_epoch = epoch_step_times(tr, cfg.data.batch_size)
    for e, ts in enumerate(per_epoch):
        phase("slice", f"epoch {e}: {len(ts)} steps in {sum(ts):.3f} s (host clock between "
              f"step logs), {sum(ts) / max(len(ts), 1):.5f} s/step")
    steady = per_epoch[1] + per_epoch[2]
    phase("slice", f"steady s/step (epochs 1-2): {sum(steady) / len(steady):.5f}; the CLI's "
          f"mean_step_time {results['summary']['mean_step_time']:.5f}; outputs: samples.png, "
          f"samples_epoch2/4.png, metrics.json, ckpt/epoch_0-3, {len(tr.img_list)} grids")
    phase("slice", f"kernels {json.dumps(launches)}; {graphs(tr, 'slice')}")
    return tr, launches, tee.copy.getvalue()


def band_phase(torch, np, tr, out_dir: Path):
    """Resume from the ``final`` run's epoch-2 checkpoint, strain at epoch 3
    by the band path, and hold it to the uninterrupted run's mask and to the
    all-f32 path on the same D; time both paths."""
    from strainer_gan_tpu_torch import kernels
    from strainer_gan_tpu_torch.checkpoint import restore_checkpoint
    from strainer_gan_tpu_torch.config import ExperimentConfig
    from strainer_gan_tpu_torch.strain import score as SC, thresholds as TH
    from strainer_gan_tpu_torch.train.loop import Trainer
    from strainer_gan_tpu_torch.train.schedules import clean_ratio_at

    ckpt = out_dir / "ckpt"
    cfg = ExperimentConfig.from_json((ckpt / "config.json").read_text())
    check(cfg == tr.cfg, "the checkpoint's config is not the run's")
    fresh = Trainer(cfg, dataset=tr.dataset)
    fresh.setup()
    check(restore_checkpoint(str(ckpt), fresh, epoch=2) == 3, "restore did not resume at 3")
    eng = fresh.engine
    kernels.reset_launch_counts()
    mask = eng.on_epoch_start(3)
    torch.cuda.synchronize()
    k1 = kernels.launch_counts()["bce_scores"]
    check(eng.last_score_path == "band", "the resumed strain did not take the band path")
    check(k1 >= 2, f"K1 launched {k1} times in the band event, not at least 2")
    got = mask.cpu().numpy()
    check(np.array_equal(got, tr.mask_history[3]),
          f"resumed epoch-3 mask flips {int((got != tr.mask_history[3]).sum())} lanes against "
          "the uninterrupted run's")
    n_rescored, fell_back, drift = eng.last_band_stats.tolist()

    sc = cfg.strain
    ratio = clean_ratio_at(3, sc.clean_ratio_schedule)
    sub, n = eng._base_subset, fresh.dataset.n

    def f32_path():
        losses = SC.score_d_losses(eng.disc, eng.dataset, batch_size=eng.score_batch, subset=sub)
        full = torch.full((n,), float("inf"), device="cuda")
        full[sub] = losses
        return TH.percentile_refine_mask(full, ratio, valid=eng.base_active)

    def band_path():
        return SC.fused_percentile_refine(
            eng.disc, eng.dataset, ratio, eng.base_active, batch_size=eng.score_batch,
            subset=sub, band_eps=sc.band_eps, band_capacity_frac=sc.band_capacity_frac)[:2]

    f_mask, f_thr = f32_path()
    flips = int((f_mask != mask).sum())
    check(flips == 0, f"the band mask flips {flips} lanes against the f32 mask")
    check(float(f_thr) == float(eng.last_threshold),
          f"band threshold {float(eng.last_threshold)!r} vs f32 {float(f_thr)!r}")

    def best_of_3(fn):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
        return best

    t_band, t_f32 = best_of_3(band_path), best_of_3(f32_path)
    m = int(sub.shape[0]) if sub is not None else n
    phase("band", f"restored epoch 2 into a fresh Trainer: its epoch-3 band mask equals the "
          f"uninterrupted run's ({int(mask.sum())} kept of {m}); the f32 path on the same D "
          f"flips 0, threshold equal ({float(f_thr):.8g}); re-scored {n_rescored:.0f} of {m}, "
          f"fell back {fell_back:.0f}, max normalised drift {drift:.4g} (band_eps / 2 = "
          f"{sc.band_eps / 2}); K1 launched {k1} times in the band event")
    phase("band", f"scoring at N={m} (best of 3, synchronised): band path {t_band * 1e3:.2f} ms, "
          f"f32 path {t_f32 * 1e3:.2f} ms, ratio {t_band / t_f32:.3f}")


def basic_phase(torch, np):
    """``basic`` (no strainer) through the command line for one epoch."""
    from strainer_gan_tpu_torch import cli

    args = ["--preset", "basic", "--epochs", "1", "--max-synth", "4480"]
    t0 = time.perf_counter()
    tr, results = cli.run(args)
    torch.cuda.synchronize()
    staging(tr, "basic")
    check(tr.cfg.strain.method == "none" and tr.engine.last_mask is None
          and not tr.strain_quality, "basic strained")
    check(len(tr.mask_history) == 1 and tr.mask_history[0].all(), "basic mask is not all true")
    losses = tr.logger.D_losses + tr.logger.G_losses
    check(len(losses) == 2 * results["summary"]["steps"] > 0 and np.all(np.isfinite(losses)),
          "basic: non-finite or missing losses")
    phase("basic", f"{tr.dataset.n} images, {results['summary']['steps']} steps, batch "
          f"{tr.cfg.data.batch_size}, mean_step_time {results['summary']['mean_step_time']:.5f} "
          f"s, {time.perf_counter() - t0:.2f} s in all; no strain; {graphs(tr, 'basic')}")


def zscore_loss_args(tmp: Path) -> list:
    """``zscore_loss`` through the command line, epochs 0-3 on 2,560 images
    a source, with ``sample_every=0`` (a config JSON): no fixed-noise
    grids, so its epoch-3 strain takes the deferred-stats path."""
    from strainer_gan_tpu_torch import get_preset

    cfg = get_preset("zscore_loss")
    path = tmp / "zscore_loss_no_grids.json"
    if not path.exists():  # written once: the child reads it while the parent runs
        path.write_text(cfg.replace(
            train=dataclasses.replace(cfg.train, sample_every=0)).to_json())
    return ["--config", str(path), "--epochs", "4", "--max-synth", "2560", "--parity-check"]


def zscore_loss_phase(torch, np, tmp: Path):
    """``zscore_loss`` through the command line, epochs 0-3: the elbow
    prefilter (K2a, K2b), then the epoch-3 loss strain by the band path
    (K1), its epoch deferred (the stats fetched while its gated chunks
    run)."""
    from strainer_gan_tpu_torch import cli, kernels
    from strainer_gan_tpu_torch.parity import oracle
    from strainer_gan_tpu_torch.strain import thresholds as TH

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(Tee(sys.stdout)) as tee:
        tr, results = cli.run(zscore_loss_args(tmp))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    staging(tr, "zscore_loss")
    check(launches["zscore_column_stats"] >= 1 and launches["zscore_row_max"] >= 1,
          "K2 not launched on the zscore_loss path")
    check(launches["bce_scores"] >= 1, "K1 not launched on the zscore_loss path")
    eng = tr.engine
    base = eng.base_active.cpu().numpy()
    check(all(np.array_equal(m, base) for m in tr.mask_history[:3]), "strained before epoch 3")
    # the prefilter: K2's max-|z| and the elbow, against the numpy oracle
    mz = TH.masked_max_abs_z(eng._features, None, tr.cfg.strain.z_std_mode)
    mask, thr = TH.zscore_elbow_mask(mz)
    z = mz.cpu().numpy()
    check(np.array_equal(mask.cpu().numpy(), base), "the prefilter is not max|z| < elbow")
    thr_np, _, _ = oracle.find_elbow_threshold(z)
    agree = oracle.mask_agreement(base, z < thr_np)
    check(agree >= 0.99, f"elbow mask agrees {agree} with numpy's, under the repo's 0.99")
    # the loss strain, as the final phase checks it
    refined = tr.mask_history[3]
    scores = eng.last_scores.cpu().numpy()
    lthr = float(eng.last_threshold)
    lthr_np = float(np.percentile(scores[base].astype(np.float64), 80.0))
    check(abs(lthr - lthr_np) <= 1e-6 * max(1.0, abs(lthr_np)),
          f"loss threshold {lthr} vs numpy {lthr_np}")
    check(0 < refined.sum() < base.sum() and np.array_equal(refined, base & (scores < lthr)),
          "zscore_loss strain mask")
    parity = results.get("parity", {})
    check(parity.get("agreement") == 1.0, f"zscore_loss parity report {parity}")
    check(np.all(np.isfinite(tr.logger.D_losses)), "zscore_loss: non-finite losses")
    gs = tr.graph_stats
    check(gs["deferred_epochs"] == 1 and gs["conditional_nodes"] > 0,
          f"zscore_loss: {gs['deferred_epochs']} deferred epochs, want 1 (epoch 3)")
    n_rescored, fell_back, drift = (eng.last_band_stats.tolist()
                                    if eng.last_band_stats is not None else (0, 0, 0))
    phase("zscore_loss", f"{tr.dataset.n} images: elbow prefilter kept {int(base.sum())} at "
          f"{float(thr):.8g} (numpy {thr_np:.8g}, masks agree {agree}); epoch 3 by the "
          f"{eng.last_score_path} path kept {int(refined.sum())} at {lthr:.8g} (numpy "
          f"{lthr_np:.8g}; re-scored {n_rescored:.0f}, fell back {fell_back:.0f}, drift "
          f"{drift:.3g}); parity {parity.get('agreement')}; {results['summary']['steps']} "
          f"steps, {seconds:.2f} s in all; kernels {json.dumps(launches)}; "
          f"{graphs(tr, 'zscore_loss')}; epoch 3 deferred ({gs['gated_replays']} gated "
          f"launches, {gs['conditional_nodes']} conditional nodes)")
    return tr, tee.copy.getvalue()


def zscore_dbscan_phase(torch, np):
    """The zscore_dbscan preset at full width on its full synthetic mixture."""
    from strainer_gan_tpu_torch import get_preset, kernels
    from strainer_gan_tpu_torch.kernels import pairwise as KP
    from strainer_gan_tpu_torch.ops import dbscan as DB
    from strainer_gan_tpu_torch.strain import score as SC, thresholds as TH
    from strainer_gan_tpu_torch.train.loop import Trainer

    cfg = get_preset("zscore_dbscan")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=128),
                      train=dataclasses.replace(cfg.train, epochs=1))
    t0 = time.perf_counter()
    tr = Trainer(cfg)
    torch.cuda.synchronize()
    staging(tr, "zscore_dbscan")
    n = tr.dataset.n
    mb = tr.dataset.images.numel() / 1e6
    phase("zscore_dbscan", f"{n} images ({mb:.0f} MB uint8) staged on the card, G/D at "
          f"nz={cfg.model.nz} ngf={cfg.model.ngf} ndf={cfg.model.ndf}, "
          f"eps={cfg.strain.dbscan_eps} min_samples={cfg.strain.dbscan_min_samples} "
          f"({time.perf_counter() - t0:.1f} s)")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = tr.run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check(launches["neighbor_counts"] == 2, f"K3 launched {launches['neighbor_counts']} "
          "times on the zscore_dbscan path, not 2")
    check(launches["zscore_column_stats"] >= 1 and launches["zscore_row_max"] >= 1,
          "K2 not launched on the zscore_dbscan path")

    eng = tr.engine
    ratio = float(eng.last_clean_ratio)
    mz = eng.last_scores
    thr = eng.last_threshold
    base = eng.base_active
    kept = int(base.sum())
    check(0 < kept <= n, f"prefilter kept {kept} of {n}")
    check(torch.equal(base, mz <= thr), "the prefilter mask is not max|z| <= threshold")
    thr_np = float(np.quantile(mz.double().cpu().numpy(), ratio))
    check(abs(float(thr) - thr_np) <= 1e-6 * abs(thr_np),
          f"threshold {float(thr)} vs numpy quantile {thr_np}")
    # the clean ratio inside the float64 sandwich on the same standardised features
    xs = DB.standardize(eng._features).double()
    eps, ms = cfg.strain.dbscan_eps, cfg.strain.dbscan_min_samples
    k_lo = int(KP.dbscan_non_noise_plain(xs, eps * (1 - 1e-4) ** 0.5, ms).sum())
    k_hi = int(KP.dbscan_non_noise_plain(xs, eps * (1 + 1e-4) ** 0.5, ms).sum())
    k = round(ratio * n)  # the ratio is k times float32(1/n)
    r_lo, r_hi = k_lo / n, k_hi / n
    check(k_lo <= k <= k_hi, f"clean ratio {ratio} ({k} non-noise) outside [{r_lo}, {r_hi}]")
    del xs
    losses = tr.logger.D_losses + tr.logger.G_losses
    check(len(losses) == 2 * sum(o["steps"] for o in out) and np.all(np.isfinite(losses)),
          "non-finite or missing losses")

    setup_s = total - sum(o["seconds"] for o in out)
    # the prefilter's pieces again, each timed alone on the cached features
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t
    _, t_feat = timed(lambda: SC.score_features(tr.engine.feature_fn, tr.dataset,
                                                cfg.strain.score_batch))
    mz2, t_k2 = timed(lambda: TH.masked_max_abs_z(eng._features, None, cfg.strain.z_std_mode))
    r2, t_k3 = timed(lambda: DB.dbscan_clean_ratio(eng._features, eps, ms))
    _, t_q = timed(lambda: TH.zscore_quantile_mask(mz2, r2))
    quality = "".join(f"; removed {q['removed']} with precision {q['precision']:.4f} "
                      f"recall {q['recall']:.4f} against the contamination labels"
                      for q in tr.strain_quality)
    phase("zscore_dbscan", f"prefilter: DBSCAN clean ratio {ratio:.6f} (float64 sandwich "
          f"[{r_lo:.6f}, {r_hi:.6f}]; K3 redecided {KP.last_band_pairs} band pairs), "
          f"threshold {float(thr):.6g} (numpy {thr_np:.6g}), kept {kept}/{n} "
          f"({kept - PR5_KEPT:+d} against the {PR5_KEPT} the direct-form K3 kept){quality}")
    phase("zscore_dbscan", f"prefilter {setup_s:.3f} s in the run; its pieces again alone: "
          f"features {t_feat:.3f} s, K2 max|z| {t_k2:.4f} s, standardise + K3 x2 + ratio "
          f"{t_k3:.4f} s, quantile + mask {t_q:.4f} s")
    for e, o in enumerate(out):
        train_s = o["seconds"] - o["strain_seconds"]
        phase("zscore_dbscan", f"epoch {e}: {o['steps']} steps in {train_s:.3f} s, "
              f"{train_s / max(o['steps'], 1):.5f} s/step")
    phase("zscore_dbscan", f"kernels {json.dumps(launches)}; {graphs(tr, 'zscore_dbscan')}")
    return launches, tr.dataset


def zscore_short_phases(torch, np):
    """zscore_elbow (its prefilter) and zscore (epochs 0-3) at full width."""
    from strainer_gan_tpu_torch import get_preset, kernels
    from strainer_gan_tpu_torch.train.loop import Trainer

    for name, epochs in (("zscore_elbow", 0), ("zscore", 4)):
        cfg = get_preset(name)
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=128))
        tr = Trainer(cfg, max_synth=2048)
        staging(tr, name)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if epochs:
            out = tr.run(epochs)
            check(all(m.all() for m in tr.mask_history[:3]), f"{name}: strained before epoch 3")
            mask, prev = tr.mask_history[3], tr.mask_history[2]
            check(all(np.isfinite(tr.logger.D_losses)), f"{name}: non-finite losses")
        else:
            tr.setup()
            mask = tr.engine.active.cpu().numpy()
            prev = np.ones_like(mask)
            out = []
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        check(launches["zscore_column_stats"] >= 1 and launches["zscore_row_max"] >= 1,
              f"K2 not launched on the {name} path")
        check(0 < mask.sum() and not mask[~prev].any(), f"{name}: mask empty or outside its base")
        steps = sum(o["steps"] for o in out)
        phase(name, f"{tr.dataset.n} images: strain kept {int(mask.sum())}/{int(prev.sum())} "
              f"at threshold {float(tr.engine.last_threshold):.6g}; {len(out)} epochs, "
              f"{steps} steps, {seconds:.2f} s in all; kernels {json.dumps(launches)}"
              + (f"; {graphs(tr, name)}" if epochs else "; no training step"))

def loss_fixture_phase(torch, np):
    """The card's loss-space, AE and in-step decisions against the JAX
    package's, on the inputs of ``JAX_LOSS_FIXTURE`` (written on the CPU by
    tests/test_torch_jax_loss_fixture.py): the GMM and ensemble masks, with
    and without ``valid``, within 1e-5 (relative) of the JAX thresholds and
    every flip within 1e-5 of it; the IQR fence, the in-step quantiles and
    the truncation counts exactly; the AE mask within 1e-6."""
    from strainer_gan_tpu_torch.ops import stats as S
    from strainer_gan_tpu_torch.strain import engine as E, thresholds as TH

    with np.load(JAX_LOSS_FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    inputs = loss_fixture_inputs()
    for k, digest in input_digests(inputs).items():
        check(str(ref[f"sha256_{k}"]) == digest, f"loss fixture input {k} is not the one stored")
    dev = torch.device("cuda")

    def flips(key, mask, thr, scores, rel):
        """``mask`` against the stored one: its threshold's distance to JAX's
        and each flipped lane's distance to JAX's threshold, relative."""
        want = float(ref[key.replace("_", "_thr_", 1) if "_" in key else key + "_thr"])
        d_thr = abs(float(thr) - want) / abs(want)
        check(d_thr <= rel, f"{key}: threshold {float(thr)!r} is {d_thr:.3g} from JAX's {want!r}")
        diff = mask.cpu().numpy() != ref[key]
        dist = np.abs(scores[diff].astype(np.float64) - want) / abs(want)
        worst = float(dist.max()) if diff.any() else 0.0
        check(worst <= rel, f"{key}: a flip lies {worst:.3g} from the JAX threshold")
        return (f"{key} {int(diff.sum())} flips"
                + (f" (at {', '.join(f'{x:.2g}' for x in dist)})" if diff.any() else "")
                + f", threshold {float(thr):.9g} (JAX {want:.9g})")

    x = torch.from_numpy(inputs["losses"]).to(dev)
    parts = []
    for m in ("all", "valid"):
        v = torch.from_numpy(inputs["loss_valid"]).to(dev) if m == "valid" else None
        for name, fn in (("gmm", TH.gmm_mask), ("ensemble", TH.ensemble_mask)):
            mask, thr = fn(x, v)
            parts.append(flips(f"{name}_{m}", mask, thr, inputs["losses"], 1e-5))
            if name == "ensemble" and m == "all":
                for r in LOSS_FIXTURE_RATIOS:
                    count = E.keep_count(mask, r)
                    kept = E._truncate_in_order(mask, count).cpu().numpy()
                    check(int(count) == int(ref[f"trunc_count_{r}"]),
                          f"truncation count at {r}: {int(count)} vs JAX "
                          f"{int(ref[f'trunc_count_{r}'])}")
                    n_flip = int((kept != ref[f"trunc_{r}"]).sum())
                    parts.append(f"truncation at {r}: keeps {int(count)}, {n_flip} flips")
        iqr = S.iqr_threshold(x, v).cpu().numpy()
        check(iqr.tobytes() == ref[f"iqr_{m}"].tobytes(), f"IQR fence ({m}) {iqr} vs JAX")
    mask, thr = TH.ae_error_mask(torch.from_numpy(inputs["ae_errors"]).to(dev), 2.0)
    parts.append(flips("ae", mask, thr, inputs["ae_errors"], 1e-6))
    full, tail = (torch.from_numpy(b).to(dev) for b in inputs["batch_scores"])
    valid = torch.arange(tail.shape[0], device=dev) < LOSS_FIXTURE_TAIL
    thr_full, thr_tail = S.quantile(full, 0.1), S.masked_quantile(tail, valid, 0.1)
    for key, thr, keep in (("full", thr_full, full >= thr_full),
                           ("tail", thr_tail, (tail >= thr_tail) & valid)):
        check(thr.cpu().numpy().tobytes() == ref[f"keep_thr_{key}"].tobytes()
              and np.array_equal(keep.cpu().numpy(), ref[f"keep_{key}"]),
              f"in-step keep ({key}) differs from JAX's")
    phase("jax_fixture", "loss space on the card: " + "; ".join(parts)
          + "; IQR fences and in-step quantile keeps (full, 77-lane tail) bit-equal")


class Tee(io.TextIOBase):
    """Writes to a stream and keeps a copy."""

    def __init__(self, stream):
        self.stream, self.copy = stream, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


EAGER_STEPS = 8  # eager masked steps a timing (host-bound, so a few suffice)
TRACED_STEPS = 5  # masked steps in the profiler trace


def batch_mask_phase(torch, np):
    """``batch_mask`` through the command line across its gate epoch, then
    timed and traced steps of the masked step."""
    from strainer_gan_tpu_torch import cli, get_preset, kernels
    from strainer_gan_tpu_torch.data import normalize_u8
    from strainer_gan_tpu_torch.obs import profiler
    from strainer_gan_tpu_torch.train.steps import train_step

    args = ["--preset", "batch_mask", "--epochs", "11", "--max-synth", "4096", "--parity-check"]
    phase("batch_mask", "python -m strainer_gan_tpu_torch.cli " + " ".join(args))
    tee = Tee(sys.stdout)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        tr, results = cli.run(args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    staging(tr, "batch_mask")
    cfg = tr.cfg
    shipped = get_preset("batch_mask")
    check(cfg == shipped.replace(train=dataclasses.replace(shipped.train, epochs=11)),
          "the batch_mask preset was changed beyond --epochs")
    gate = cfg.strain.mask_start_epoch
    n_contam = int((tr.dataset.source_id != 0).sum())
    res = tr.epoch_results
    check(len(res) == 11 and all(r["total_contam"] == 0 for r in res[:gate]),
          "contamination counted before the gate epoch")
    r = res[gate]
    lines = [ln for ln in tee.copy.getvalue().splitlines() if "Filtered CIFAR-10" in ln]
    want = f"Epoch {gate}: Filtered CIFAR-10 images: {r['filtered_contam']}/{r['total_contam']}"
    check(lines == [want], f"contamination lines {lines}, want [{want!r}]")
    check(r["total_contam"] == n_contam and 0 <= r["filtered_contam"] <= n_contam,
          f"epoch {gate} counted {r['total_contam']} contaminants of {n_contam}")
    eng = tr.engine
    kept, nv = int(eng.last_batch_mask.sum()), eng.last_batch_valid
    check(0 < kept < nv and not bool(eng.last_batch_mask[nv:].any()),
          f"the last gated step kept {kept} of {nv} valid lanes")
    parity = results.get("parity", {})
    check(parity.get("method") == "batch_quantile_mask" and parity.get("agreement") == 1.0,
          f"parity report {parity}")
    losses = tr.logger.D_losses + tr.logger.G_losses
    check(np.all(np.isfinite(losses)), "batch_mask: non-finite losses")
    per_epoch = epoch_step_times(tr, cfg.data.batch_size)
    ungated = [t for ts in per_epoch[1:gate] for t in ts]
    phase("batch_mask", f"{tr.dataset.n} images ({n_contam} CIFAR-like), G/D at nz="
          f"{cfg.model.nz} ngf={cfg.model.ngf} ndf={cfg.model.ndf}, {cfg.model.compute_dtype}, "
          f"batch {cfg.data.batch_size}, mask_quantile {cfg.strain.mask_quantile} from epoch "
          f"{gate}; whole CLI run {total:.2f} s; {want}; the last gated step kept {kept} of "
          f"{nv} valid lanes; parity {json.dumps(parity)}; kernels {json.dumps(launches)}; "
          f"{graphs(tr, 'batch_mask')}")
    phase("batch_mask", f"s/step (host clock between step logs): ungated epochs 1-{gate - 1} "
          f"{sum(ungated) / len(ungated):.5f} over {len(ungated)} steps; epoch {gate} (masked) "
          f"{sum(per_epoch[gate]) / len(per_epoch[gate]):.5f} over {len(per_epoch[gate])} "
          f"steps; epoch 0 {sum(per_epoch[0]) / len(per_epoch[0]):.5f}")

    # ---- the step alone: timed (synchronised) and traced
    ds, bs, nz = tr.dataset, cfg.data.batch_size, cfg.model.nz
    idx = tr.epoch_indices(11, torch.ones((ds.n,), dtype=torch.bool, device="cuda"), 24)
    g = torch.Generator(device="cuda").manual_seed(5)
    lr = cfg.train.lr_d
    d_train = not eng.d_bn_eval

    def run_steps(k, **kw):
        for i in range(k):
            ids = idx[i % idx.shape[0]]
            train_step(tr.gen, tr.disc, tr.opt_g, tr.opt_d, normalize_u8(ds.gather(ids)),
                       ds.source_id[ids], torch.randn((bs, nz), generator=g, device="cuda"),
                       lr, lr, tr.scfg, d_train=d_train, **kw)

    def ms_per_step(**kw):
        run_steps(2, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_steps(EAGER_STEPS, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / EAGER_STEPS * 1e3

    variants = (("masked", dict(mask_on=True)), ("unmasked", {}),
                ("masked without stem sharing", dict(mask_on=True, stem_share=False)),
                ("masked", dict(mask_on=True)))
    times = [(label, ms_per_step(**kw)) for label, kw in variants]
    phase("batch_mask", f"ms/step, {EAGER_STEPS} steps each, synchronised, in this order: "
          + ", ".join(f"{label} {t:.3f}" for label, t in times))
    with tempfile.TemporaryDirectory() as log_dir:
        t = time.perf_counter()
        with profiler.trace(log_dir) as prof:
            run_steps(TRACED_STEPS, mask_on=True)
        traced = time.perf_counter() - t
        summary = profiler.summarize(prof, steps=TRACED_STEPS)
        summarised = time.perf_counter() - t - traced
        size = (Path(log_dir) / "trace.json").stat().st_size
    check(summary["device_busy_ms"] > 0, "the trace holds no device time")
    phase("batch_mask", f"trace of {TRACED_STEPS} masked steps ({traced:.2f} s traced and "
          f"exported, {summarised:.2f} s to summarise, Chrome trace "
          f"{size / 1e6:.1f} MB, not kept): {summary['launches_per_step']:.1f} device "
          f"operations per step; device busy {summary['device_busy_ms']:.2f} ms of "
          f"{summary['wall_ms']:.2f} ms traced ({summary['busy_share']:.3f}); busy per step "
          f"{summary['device_busy_ms'] / TRACED_STEPS:.3f} ms")
    for op in summary["top"]:
        phase("batch_mask", f"  {op['ms']:9.3f} ms  x{op['count']:5d}  {op['name'][:110]}")
    return tr


def host_staging_phase(np):
    """The host-staging pieces alone on this host: 5,000 CelebA-like images
    generated, 5,000 CIFAR-like ones generated at 32x32 and resized to 64
    by the host-staging library (``native``), the first 500 of them by the
    numpy plain version, and how many bytes the two differ by (0 where the
    library's compiled roundings are the ones the plain version repeats)."""
    from strainer_gan_tpu_torch.data import datasets as D

    n, m = 5_000, 500
    t0 = time.perf_counter()
    D._synthetic("faces", n, 64, 3, 5)
    t1 = time.perf_counter()
    objects = D._synthetic("objects", n, 32, 3, 5).images
    t2 = time.perf_counter()
    native = D.resize_bilinear_u8(objects, 64)
    t3 = time.perf_counter()
    plain = D.resize_bilinear_u8_plain(objects[:m], 64)
    t4 = time.perf_counter()
    diff = int((native[:m] != plain).sum())
    phase("host_staging", f"on this host ({CARD}'s): {n} CelebA-like images generated in "
          f"{t1 - t0:.2f} s, {n} CIFAR-like at 32x32 in {t2 - t1:.2f} s; resize 32 -> 64 by "
          f"native {t3 - t2:.3f} s for {n}, by the numpy plain version {t4 - t3:.3f} s for "
          f"{m}; bytes differing on those {m}: {diff}")


def adam_phase(torch, np):
    """The card's capturable Adam (``train/state.py::make_adam``) against the
    JAX package's ``optax.scale_by_adam`` updates in ``JAX_ADAM_FIXTURE``
    (written on the CPU by tests/test_torch_adam.py), eagerly and replayed
    from a CUDA graph: parameters within ``ADAM_TOL``, moments within
    ``ADAM_TOL`` of their tensor's largest magnitude."""
    with np.load(JAX_ADAM_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = adam_fixture_inputs()
    for k, digest in input_digests(inputs).items():
        check(str(fixture[f"sha256_{k}"]) == digest, f"Adam fixture input {k} is not the one stored")
    parts = []
    for replay in (False, True):
        t0 = time.perf_counter()
        gaps = adam_gaps(torch, np, fixture, inputs, torch.device("cuda"), replay)
        label = "replayed" if replay else "eager"
        check(all(g <= ADAM_TOL for g in gaps.values()),
              f"capturable Adam ({label}) misses the JAX fixture: {gaps}")
        parts.append(f"{label} ({time.perf_counter() - t0:.2f} s): parameters "
                     f"{gaps['params']:.3g}, mu {gaps['mu']:.3g}, nu {gaps['nu']:.3g}")
    phase("adam", f"capturable Adam against optax.scale_by_adam with the rate applied, "
          f"{ADAM_UPDATES} updates at betas {ADAM_BETAS} and rates {ADAM_RATES} cut to a "
          f"tenth from update {ADAM_CUT_AT} (largest gaps, parameters absolute, moments "
          f"relative to their tensor's largest; tolerance {ADAM_TOL}): " + "; ".join(parts))


def replay_ms(torch, ex, idx, z, lr, rows=None, concat_on=False) -> float:
    """ms/step of ``REPLAYED_CHUNKS`` calls of a chunk executor (its graph
    replays, with the inputs' copies), synchronised, after one call."""
    ex(idx, z, lr, lr, pool_idx=rows, concat_on=concat_on)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPLAYED_CHUNKS):
        ex(idx, z, lr, lr, pool_idx=rows, concat_on=concat_on)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / (REPLAYED_CHUNKS * idx.shape[0]) * 1e3


def in_batch_recycle_phase(torch, np):
    """``in_batch_recycle`` through the command line across its gate epoch
    (3), against the same run at steps_per_dispatch=1 bit for bit; then the
    recycled lanes of each step of a replayed gated chunk, and its time."""
    from strainer_gan_tpu_torch import cli, get_preset, kernels
    from strainer_gan_tpu_torch.train.loop import Trainer

    args = ["--preset", "in_batch_recycle", "--epochs", "4", "--max-synth", "4500"]
    phase("in_batch_recycle", "python -m strainer_gan_tpu_torch.cli " + " ".join(args))
    tee = Tee(sys.stdout)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        tr, results = cli.run(args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    staging(tr, "in_batch_recycle")
    cfg = tr.cfg
    shipped = get_preset("in_batch_recycle")
    check(cfg == shipped.replace(train=dataclasses.replace(shipped.train, epochs=4)),
          "the in_batch_recycle preset was changed beyond --epochs")
    gate = cfg.strain.fake_concat_start_epoch
    check(gate == 3 and {k[1] for k in tr._executors} == {False, True},
          "in_batch_recycle: no capture before and after its gate")
    eng = tr.engine
    kept, nv = int(eng.last_batch_mask.sum()), eng.last_batch_valid
    check(0 < kept < nv and not bool(eng.last_batch_mask[nv:].any()),
          f"the last gated step kept {kept} of {nv} valid lanes")
    losses = tr.logger.D_losses + tr.logger.G_losses
    check(np.all(np.isfinite(losses)), "in_batch_recycle: non-finite losses")
    phase("in_batch_recycle", f"{tr.dataset.n} images, G/D at nz={cfg.model.nz} "
          f"ngf={cfg.model.ngf} ndf={cfg.model.ndf}, {cfg.model.compute_dtype}, batch "
          f"{cfg.data.batch_size}, recycle quantile {cfg.strain.in_batch_recycle_quantile} from "
          f"epoch {gate}; whole CLI run {total:.2f} s; the last (tail) step recycled "
          f"{nv - kept} of {nv} valid lanes; kernels {json.dumps(launches)}; "
          f"{graphs(tr, 'in_batch_recycle')}")

    eager = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, steps_per_dispatch=1)),
                    dataset=tr.dataset)
    eager.logger.stream = io.StringIO()
    eager.setup()
    for e in range(cfg.train.epochs):
        eager.run_epoch(e)
    check(eager.graph_stats["replays"] == 0, "the per-step run replayed a graph")
    phase("in_batch_recycle", same_run(
        torch, np, tr, eager, tee.copy.getvalue(), eager.logger.stream.getvalue(),
        f"in_batch_recycle steps_per_dispatch={cfg.train.steps_per_dispatch} vs 1, epochs "
        f"0-{gate - 1} plain, {gate} recycling"))

    # a gated chunk again: its recycled lanes step by step, and its time
    ds, bs, nz, chunk = tr.dataset, cfg.data.batch_size, cfg.model.nz, cfg.train.steps_per_dispatch
    idx = tr.epoch_indices(9, torch.ones((ds.n,), dtype=torch.bool, device="cuda"), chunk)
    z = torch.randn((chunk, bs, nz), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    lr = cfg.train.lr_d
    key = (chunk, True, not eng.d_bn_eval, True, cfg.model.compute_dtype)
    m = tr._executors[key](idx, z, lr, lr)
    recycled = (bs - m["keep_mask"].sum(1)).tolist()
    check(all(0 < r < bs for r in recycled), f"recycled lanes per step {recycled}")
    t_on = replay_ms(torch, tr._executors[key], idx, z, lr)
    t_off = replay_ms(torch, tr._executors[key[:1] + (False,) + key[2:]], idx, z, lr)
    phase("in_batch_recycle", f"a replayed gated chunk of {chunk} steps recycled "
          f"{min(recycled)}-{max(recycled)} (mean {sum(recycled) / len(recycled):.2f}) of {bs} "
          f"lanes a step; ms/step replayed ({CARD}): recycling {t_on:.3f}, before the gate "
          f"{t_off:.3f}")


def fake_pool_phase(torch, np, out_dir: Path):
    """``strainer_concat_fast`` (prefilter, outlier pool, loss refinement)
    through the command line across its gate epoch (3): K2a and K2b score
    the prefilter and the pool's outliers, K1 the epoch-3 strain; against
    the same run at steps_per_dispatch=1 bit for bit; a resume from epoch 2
    to the same epoch-3 mask and pool; replayed ms/step with the pool
    against the same step without it."""
    from strainer_gan_tpu_torch import cli, get_preset, kernels
    from strainer_gan_tpu_torch.checkpoint import restore_checkpoint
    from strainer_gan_tpu_torch.train import steps as ST
    from strainer_gan_tpu_torch.train.loop import Trainer

    args = ["--preset", "strainer_concat_fast", "--epochs", "4", "--max-synth", "3400",
            "--out", str(out_dir), "--checkpoint-every", "1", "--parity-check"]
    phase("fake_pool", "python -m strainer_gan_tpu_torch.cli " + " ".join(args))
    tee = Tee(sys.stdout)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        tr, results = cli.run(args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    staging(tr, "fake_pool")
    cfg = tr.cfg
    shipped = get_preset("strainer_concat_fast")
    check(cfg == shipped.replace(train=dataclasses.replace(shipped.train, epochs=4)),
          "the strainer_concat_fast preset was changed beyond --epochs")
    for name in ("bce_scores", "zscore_column_stats", "zscore_row_max"):
        check(launches[name] >= 1, f"{name} not launched on the fake_pool path")
    eng = tr.engine
    n = tr.dataset.n
    pool, rows = tr.fake_pool, tr.fake_pool_rows
    outliers = eng.outlier_mask()
    n_out = int(outliers.sum())
    num = max(int(n * cfg.strain.fake_pool_fraction), 1)
    check(tuple(pool.shape) == (num, 64, 64, 3) and pool.dtype == torch.uint8
          and pool.device.type == "cuda", f"pool {tuple(pool.shape)} {pool.dtype}")
    check(torch.equal(pool, tr.dataset.gather(rows)), "the pool is not its rows' images")
    check(n_out == 0 or bool(outliers[rows].all()), "a pool row is not an outlier")
    check(len(set(rows.tolist())) == min(max(n_out, 1), num),
          "pool rows repeat before the outliers end")
    contam = float((tr.dataset.source_id[rows] != 0).float().mean())
    anime_all = float((tr.dataset.source_id != 0).float().mean())
    parity = results.get("parity", {})
    check(parity.get("method") == "loss_percentile" and parity.get("agreement") == 1.0,
          f"parity report {parity}")
    check(0 < tr.mask_history[3].sum() < tr.mask_history[2].sum(), "no loss strain at epoch 3")
    losses = tr.logger.D_losses + tr.logger.G_losses
    check(np.all(np.isfinite(losses)), "fake_pool: non-finite losses")
    check({k[1] for k in tr._executors} == {False}, "the pool's gate made a capture key")
    phase("fake_pool", f"{n} images ({int((tr.dataset.source_id != 0).sum())} anime-like), "
          f"prefilter kept {int(eng.base_active.sum())}; pool of {num} rows from {n_out} "
          f"z-score outliers (z >= {cfg.strain.z_threshold}); anime-like share {contam:.4f} "
          f"in the pool, {anime_all:.4f} in the data; concat from epoch "
          f"{cfg.strain.fake_concat_start_epoch}; epoch 3 kept {int(tr.mask_history[3].sum())} "
          f"by the {eng.last_score_path} path; parity {parity.get('agreement')}; whole CLI run "
          f"{total:.2f} s; kernels {json.dumps(launches)}; {graphs(tr, 'fake_pool')}")

    eager = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, steps_per_dispatch=1)),
                    dataset=tr.dataset)
    eager.logger.stream = io.StringIO()
    eager.setup()
    for e in range(cfg.train.epochs):
        eager.run_epoch(e)
    check(eager.graph_stats["replays"] == 0, "the per-step run replayed a graph")
    check(torch.equal(eager.fake_pool, pool), "the per-step run built another pool")
    phase("fake_pool", same_run(
        torch, np, tr, eager, tee.copy.getvalue(), eager.logger.stream.getvalue(),
        f"strainer_concat_fast steps_per_dispatch={cfg.train.steps_per_dispatch} vs 1, epochs "
        "0-2 pool at weight 0, 3 pooled and strained"))

    fresh = Trainer(cfg, dataset=tr.dataset)
    fresh.logger.stream = io.StringIO()
    fresh.setup()
    fresh.fake_pool.zero_()  # the restore must bring the bytes back
    ptr = fresh.fake_pool.data_ptr()
    check(restore_checkpoint(str(out_dir / "ckpt"), fresh, epoch=2) == 3,
          "restore did not resume at 3")
    check(fresh.fake_pool.data_ptr() == ptr and torch.equal(fresh.fake_pool, pool),
          "the restored pool moved or differs")
    fresh.run_epoch(3)
    torch.cuda.synchronize()
    diffs = state_diffs(torch, fresh, tr)
    check(not diffs, f"resumed strainer_concat_fast: {len(diffs)} tensors differ")
    check(np.array_equal(fresh.mask_history[-1], tr.mask_history[3])
          and torch.equal(fresh.fake_pool, pool), "resumed: epoch-3 mask or pool differs")
    phase("fake_pool", f"resumed from epoch 2: epoch-3 mask ({int(fresh.mask_history[-1].sum())}"
          f" kept), pool and state bit-equal to the uninterrupted run's; "
          f"{graphs(fresh, 'resumed strainer_concat_fast')}")

    # the pooled step replayed, against loss_concat_fast's step before its
    # gate (the pool at weight 0) and the same step with no pool at all
    ds, bs, nz, chunk = tr.dataset, cfg.data.batch_size, cfg.model.nz, cfg.train.steps_per_dispatch
    idx = tr.epoch_indices(9, eng.base_active, chunk)
    g = torch.Generator(device="cuda").manual_seed(5)
    z = torch.randn((chunk, bs, nz), generator=g, device="cuda")
    pool_rows = torch.stack([tr.step_pool_rows(9, i) for i in range(chunk)])
    lr = cfg.train.lr_d
    (ex,) = tr._executors.values()
    like = {k: v[0] for k, v in ex.out.items()}
    plain = ST.ChunkedStep(tr.gen, tr.disc, tr.opt_g, tr.opt_d, ds,
                           tr.scfg._replace(pool_concat=False), chunk, like, mask_on=False,
                           d_train=ex.d_train, stats=tr.graph_stats,
                           graph_pool=tr._graph_pool)
    t_pool = replay_ms(torch, ex, idx, z, lr, pool_rows, True)
    t_gate_off = replay_ms(torch, ex, idx, z, lr, pool_rows, False)
    t_plain = replay_ms(torch, plain, idx, z, lr)
    phase("fake_pool", f"ms/step replayed, batch {bs} ({CARD}): with the pool (2x{bs} fake "
          f"lanes) {t_pool:.3f}; before the gate (pool lanes at weight 0, as "
          f"loss_concat_fast's epochs 0-2) {t_gate_off:.3f}; no pool ({bs} fake lanes) "
          f"{t_plain:.3f}")


LOGGER_LINE = re.compile(r"^(\[\d+/\d+\]\[\d+/\d+\]\t|Epoch \d+: |Epoch \[\d+/\d+\] Step )")


def logger_text(text: str) -> str:
    """The Trainer's console lines (step logs, strain and contamination
    lines) out of a run's output."""
    return "\n".join(ln for ln in text.splitlines() if LOGGER_LINE.match(ln))


def state_diffs(torch, a, b) -> list:
    """Names of the tensors that differ between two Trainers: G's and D's
    parameters and BatchNorm buffers, both Adams' moments and step counts."""
    out = []
    for name in ("gen", "disc", "opt_g", "opt_d"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        if name.startswith("opt"):
            sa = {f"{i}.{k}": v for i, st in sa["state"].items() for k, v in st.items()}
            sb = {f"{i}.{k}": v for i, st in sb["state"].items() for k, v in st.items()}
        out += [f"{name}.{k}" for k in sa if not torch.equal(sa[k], sb[k])]
    return out


def same_run(torch, np, a, b, text_a: str, text_b: str, what: str) -> str:
    """Check two runs bit for bit: state, loss series, per-sample loss
    history, strain masks, epoch results, the parity report's last batch,
    fixed-noise grids and console text.  Returns a summary."""
    diffs = state_diffs(torch, a, b)
    check(not diffs, f"{what}: {len(diffs)} tensors differ, first {diffs[:4]}")
    check(a.logger.G_losses == b.logger.G_losses and a.logger.D_losses == b.logger.D_losses,
          f"{what}: loss series differ")
    check(len(a.epoch_loss_history) == len(b.epoch_loss_history) and all(
        np.array_equal(x, y) for x, y in zip(a.epoch_loss_history, b.epoch_loss_history)),
        f"{what}: per-sample loss history differs")
    check(all(np.array_equal(x, y) for x, y in zip(a.mask_history, b.mask_history)),
          f"{what}: strain masks differ")
    keys = ("steps", "active", "lr_g", "lr_d", "filtered_contam", "total_contam")
    check([[r[k] for k in keys] for r in a.epoch_results]
          == [[r[k] for k in keys] for r in b.epoch_results], f"{what}: epoch results differ")
    check(all(torch.equal(ra["last"][k], rb["last"][k])
              for ra, rb in zip(a.epoch_results, b.epoch_results) for k in ra["last"]),
          f"{what}: an epoch's last metrics differ")
    ea, eb = a.engine, b.engine
    for k in ("last_batch_scores", "last_batch_mask"):
        va, vb = getattr(ea, k), getattr(eb, k)
        check((va is None and vb is None) or torch.equal(va, vb), f"{what}: {k} differs")
    check(ea.last_batch_valid == eb.last_batch_valid, f"{what}: last_batch_valid differs")
    check(len(a.img_list) == len(b.img_list) and all(
        np.array_equal(x, y) for x, y in zip(a.img_list, b.img_list)),
        f"{what}: fixed-noise grids differ")
    ta, tb = logger_text(text_a), logger_text(text_b)
    check(ta == tb and ta, f"{what}: console text differs")
    n = sum(r["steps"] for r in a.epoch_results)
    return (f"{what}: bit-equal over {len(a.epoch_results)} epochs, {n} steps (state "
            f"tensors, losses, per-sample history, masks, results, grids, "
            f"{len(ta.splitlines())} console lines)")


def chunked_final(torch, np, tr, console: str, ckpt: Path):
    """``final``'s CLI run (steps_per_dispatch=32; ``console`` its output)
    against the same run at steps_per_dispatch=1, and a resume through the
    executor; the strain event's round trip on the host."""
    from strainer_gan_tpu_torch.checkpoint import restore_checkpoint
    from strainer_gan_tpu_torch.train import loop as LP
    from strainer_gan_tpu_torch.train import steps as ST

    t = tr.cfg.train
    eager = LP.Trainer(tr.cfg.replace(train=dataclasses.replace(t, steps_per_dispatch=1)),
                       dataset=tr.dataset)
    eager.logger.stream = io.StringIO()
    eager.setup()
    for e in range(t.epochs):
        eager.run_epoch(e)
    check(eager.graph_stats["replays"] == 0, "the per-step run replayed a graph")
    check(tr.engine.d_bn_eval and {k[2] for k in tr._executors} <= {True, False},
          "final's strain did not turn D's batch statistics off")
    phase("chunked", same_run(torch, np, tr, eager, console, eager.logger.stream.getvalue(),
                              f"final steps_per_dispatch={t.steps_per_dispatch} vs 1, epochs "
                              "0-3 (strain, LR cut, d_train flip at 3)"))
    steady = [sum(ts[1] + ts[2]) / len(ts[1] + ts[2])
              for ts in (epoch_step_times(r, tr.cfg.data.batch_size) for r in (tr, eager))]
    phase("chunked", f"final's steady s/step (epochs 1-2, host clock between step logs, "
          f"{CARD}): {steady[0]:.5f} with graph replays, {steady[1]:.5f} eager")

    # resume from epoch 1 through the executor, timing the strain's round trip
    fresh = LP.Trainer(tr.cfg, dataset=tr.dataset)
    fresh.logger.stream = io.StringIO()
    fresh.setup()
    check(restore_checkpoint(str(ckpt), fresh, epoch=1) == 2, "restore did not resume at 2")
    marks = {}
    strain, fetch = fresh.engine.on_epoch_start, fresh._fetch_epoch_stats
    step, call = LP.train_step, ST.ChunkedStep.__call__

    def timed(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            marks.setdefault(name, time.perf_counter())
            return out
        return wrapped

    def first_launch(kind, fn):
        def wrapped(*a, **kw):
            marks.setdefault("launch", (time.perf_counter(), kind))
            return fn(*a, **kw)
        return wrapped

    fresh.run_epoch(2)
    fresh.engine.on_epoch_start = timed("strain", strain)
    fresh._fetch_epoch_stats = timed("fetch", fetch)
    LP.train_step = first_launch("an eager step", step)
    ST.ChunkedStep.__call__ = first_launch("a replay", call)
    try:
        fresh.run_epoch(3)
    finally:
        LP.train_step, ST.ChunkedStep.__call__ = step, call
    torch.cuda.synchronize()
    diffs = state_diffs(torch, fresh, tr)
    check(not diffs, f"resumed final: {len(diffs)} tensors differ from the uninterrupted run's")
    check(np.array_equal(fresh.mask_history[-1], tr.mask_history[3])
          and np.array_equal(fresh.epoch_loss_history[-1], tr.epoch_loss_history[3]),
          "resumed final: epoch-3 mask or losses differ")
    t_launch, kind = marks["launch"]
    phase("chunked", f"final resumed from epoch 1 through the executor: epoch-3 mask "
          f"({int(fresh.mask_history[-1].sum())} kept) and state bit-equal to the "
          f"uninterrupted run's; {graphs(fresh, 'resumed final')}")
    phase("chunked", f"strain-event round trip (final epoch 3, {CARD}): the band scoring "
          f"returned to the host, then {(marks['fetch'] - marks['strain']) * 1e3:.3f} ms to "
          f"the end of _fetch_epoch_stats, {(t_launch - marks['strain']) * 1e3:.3f} ms to the "
          f"first training launch ({kind}: epoch 3 trains {fresh.epoch_results[-1]['steps']} "
          f"steps with a new capture key, d_train off)")


# final's strain keeps 40, 30 and 20 % of its base at epochs 3, 4 and 5 (its
# ratio inversion): a shrinking count, so each deferred guess overshoots
DEFERRED_SCHEDULE = ((0, 1.0), (3, 0.6), (4, 0.7), (5, 0.8))
DEFERRED_EPOCHS = 6


def first_launches(LP, ST, run, marks: list):
    """Instrument ``run``: each strain's return on the host appends a mark,
    and the end of the epoch's stats dispatch, of its fetch and of its
    index draw, and its first training launch (an eager step, a replay or
    a gated launch) are recorded in it.  Returns the undo."""
    strain = run.engine.on_epoch_start
    saved = LP.train_step, ST.ChunkedStep.__call__, ST.GatedChunkedStep.__call__

    def strained(*a, **kw):
        out = strain(*a, **kw)
        marks.append({"strain": time.perf_counter()})
        return out

    def first(kind, fn):
        def wrapped(*a, **kw):
            if marks:
                marks[-1].setdefault("launch", (time.perf_counter(), kind))
            return fn(*a, **kw)
        return wrapped

    def marked(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if marks:
                marks[-1].setdefault(name, time.perf_counter())
            return out
        return wrapped

    run.engine.on_epoch_start = strained
    run._dispatch_epoch_stats = marked("dispatch", run._dispatch_epoch_stats)
    run._fetch_epoch_stats = marked("fetch", run._fetch_epoch_stats)
    run.epoch_indices = marked("indices", run.epoch_indices)
    LP.train_step = first("an eager step", saved[0])
    ST.ChunkedStep.__call__ = first("a replay", saved[1])
    ST.GatedChunkedStep.__call__ = first("a gated launch", saved[2])

    def undo():
        LP.train_step, ST.ChunkedStep.__call__, ST.GatedChunkedStep.__call__ = saved
    return undo


def deferred_phase(torch, np, tr):
    """``final`` with the no-history logger and no grids for 6 epochs on the
    slice phase's staged dataset, strained every epoch from 3 with a
    shrinking count and a partial tail: deferred (epochs 4 and 5 through
    the gated chunks) against blocking, bit for bit; the strain's return
    to the first launch on both paths; the gated chunk's own costs."""
    from strainer_gan_tpu_torch import kernels
    from strainer_gan_tpu_torch.kernels.gated_graph import GatedGraph
    from strainer_gan_tpu_torch.obs.metrics import MetricsLogger
    from strainer_gan_tpu_torch.train import loop as LP
    from strainer_gan_tpu_torch.train import steps as ST

    base = tr.cfg
    cfg = base.replace(
        train=dataclasses.replace(base.train, epochs=DEFERRED_EPOCHS, sample_every=0),
        strain=dataclasses.replace(base.strain, clean_ratio_schedule=DEFERRED_SCHEDULE))
    runs = {}
    for defer in (True, False):
        run = LP.Trainer(
            cfg.replace(train=dataclasses.replace(cfg.train, defer_epoch_stats=defer)),
            dataset=tr.dataset,
            logger=MetricsLogger(log_every=cfg.train.log_every, stream=io.StringIO(),
                                 collect=False))
        marks = []
        undo = first_launches(LP, ST, run, marks)
        kernels.reset_launch_counts()
        GatedGraph.launches = 0
        t0 = time.perf_counter()
        try:
            run.run()
        finally:
            undo()
        torch.cuda.synchronize()
        runs[defer] = (run, time.perf_counter() - t0, kernels.launch_counts(),
                       GatedGraph.launches, marks)
    (d, d_s, d_k, d_g, d_marks), (b, b_s, b_k, _, b_marks) = runs[True], runs[False]
    gs = d.graph_stats
    check(gs["deferred_epochs"] == 2 and gs["blocking_epochs"] == 2,
          f"deferred run: {gs['deferred_epochs']} deferred, {gs['blocking_epochs']} blocking "
          "strain epochs, want 2 and 2 (epochs 0 and 3 warm their capture keys up)")
    check(gs["conditional_nodes"] > 0 and gs["gated_replays"] > 0 and d_g > 0,
          f"no conditional node or gated launch: {gs['conditional_nodes']} nodes, {d_g} "
          "launches")
    check(b.graph_stats["deferred_epochs"] == 0, "the blocking run deferred an epoch")
    for k in (d_k, b_k):
        check(k["bce_scores"] >= 3 and k["zscore_column_stats"] >= 1
              and k["zscore_row_max"] >= 1, f"deferred phase launches {k}")
    active = [r["active"] for r in d.epoch_results]
    bs = cfg.data.batch_size
    check(active[3] > active[4] > active[5] and all(a % bs for a in active[3:]),
          f"active counts {active}: want a shrinking count with a partial tail")
    check(d.mask_history == d.epoch_loss_history == d.img_list == []
          and d.logger.G_losses == [], "the no-history run kept a history")
    phase("deferred", same_run(torch, np, d, b, d.logger.stream.getvalue(),
                               b.logger.stream.getvalue(),
                               f"final deferred vs blocking ({DEFERRED_EPOCHS} epochs, "
                               f"collect=False, sample_every=0)"))
    cap = ", ".join(f"{c:.2f}+{i:.2f}" for c, i in zip(gs["capture_s"], gs["instantiate_s"]))
    phase("deferred", f"{tr.dataset.n} images, active per epoch {active}; deferred epochs "
          f"{gs['deferred_epochs']}, blocking strain epochs {gs['blocking_epochs']}; "
          f"{gs['captures']} graphs captured (capture+instantiate s: {cap}) with "
          f"{gs['conditional_nodes']} conditional nodes; {gs['replays']} launches, "
          f"{gs['gated_replays']} of them gated; K1 {d_k['bce_scores']}, K2a "
          f"{d_k['zscore_column_stats']}, K2b {d_k['zscore_row_max']}; whole run {d_s:.2f} s "
          f"deferred, {b_s:.2f} s blocking ({CARD})")

    def to_launch(marks):
        def ms(m, k):
            return (m[k] - m["strain"]) * 1e3

        return ", ".join(
            f"epoch {e}: {(m['launch'][0] - m['strain']) * 1e3:.3f} ms ({m['launch'][1]}; "
            f"stats dispatched {ms(m, 'dispatch'):.3f}, fetched {ms(m, 'fetch'):.3f}, "
            f"indices drawn {ms(m, 'indices'):.3f} ms)"
            for e, m in enumerate(marks) if e >= 3 and "launch" in m)

    phase("deferred", f"the strain's return on the host to the epoch's first training launch "
          f"(host clock, {CARD}): "
          f"deferred run {to_launch(d_marks)}; blocking run {to_launch(b_marks)}")

    # the gated chunk's own costs, on its static buffers (after the checks:
    # these launches train on)
    key = next(iter(d._gated))
    gated, plain = d._gated[key], d._executors[key]
    chunk = key[0]
    gated.c0.fill_(0)
    gated.bound.fill_(0)
    dead = time_ms(torch, gated.graph.launch, iters=200, warmup=10)
    gated.bound.fill_(chunk)
    live, ungated = [], []
    for order in ("gu", "ug", "gu"):
        for which in order:
            fn, out = ((gated.graph.launch, live) if which == "g"
                       else (plain.graph.replay, ungated))
            out.append(time_ms(torch, fn, iters=REPLAYED_CHUNKS, warmup=1) / chunk)
    phase("deferred", f"a wholly dead gated chunk of {chunk}: {dead:.4f} ms a launch (CUDA "
          f"events, 200 back to back); a live gated step "
          f"{' / '.join(f'{v:.4f}' for v in live)} ms, the ungated replay's step "
          f"{' / '.join(f'{v:.4f}' for v in ungated)} ms (CUDA events, {REPLAYED_CHUNKS} chunks a "
          f"measurement, in the order g u u g g u; {CARD})")


EAGER_TIMED = 8  # eager steps timed beside the replays (host-bound, so a few suffice)


BM_EPOCHS = 2  # the chunked phase's and the dp child's batch_mask: epoch 0, then gated


def chunked_batch_mask(torch, np, bm):
    """``batch_mask`` at steps_per_dispatch 32 and 1 on the CLI phase's
    images, gated from epoch 1, for ``BM_EPOCHS`` epochs; then replayed against eager
    steps, timed, and the device-busy share of a replayed chunk.  Returns
    the first run's snapshot (``run_snapshot``, taken before the timing)
    and its Trainer."""
    from strainer_gan_tpu_torch.data import normalize_u8
    from strainer_gan_tpu_torch.obs import profiler
    from strainer_gan_tpu_torch.train.loop import Trainer
    from strainer_gan_tpu_torch.train.steps import train_step

    base = bm.cfg.replace(strain=dataclasses.replace(bm.cfg.strain, mask_start_epoch=1),
                          train=dataclasses.replace(bm.cfg.train, epochs=BM_EPOCHS))
    runs = []
    for spd in (base.train.steps_per_dispatch, 1):
        tr = Trainer(base.replace(train=dataclasses.replace(base.train, steps_per_dispatch=spd)),
                     dataset=bm.dataset)
        tr.logger.stream = io.StringIO()
        tr.setup()
        for e in range(BM_EPOCHS):
            tr.run_epoch(e)
        runs.append(tr)
    a, b = runs
    check(a.epoch_results[1]["total_contam"] > 0, "batch_mask: no contaminant counted")
    phase("chunked", same_run(torch, np, a, b, a.logger.stream.getvalue(),
                              b.logger.stream.getvalue(),
f"batch_mask steps_per_dispatch={a.cfg.train.steps_per_dispatch} vs "
                              "1, epoch 0 ungated, 1 masked")
          + f"; {graphs(a, 'chunked batch_mask')}")
    # the dp phase's run with no group: this run, before the timing below
    snapshot = run_snapshot(torch, a, a.logger.stream.getvalue(), {})

    ds, bs, nz, chunk = a.dataset, base.data.batch_size, base.model.nz, a.cfg.train.steps_per_dispatch
    idx = a.epoch_indices(9, torch.ones((ds.n,), dtype=torch.bool, device="cuda"), chunk)
    g = torch.Generator(device="cuda").manual_seed(7)
    lr = base.train.lr_d
    d_train = not a.engine.d_bn_eval
    times = {}
    for mask_on in (True, False):
        ex = a._executors[(chunk, mask_on, d_train, True, base.model.compute_dtype)]

        def replayed(k):
            for _ in range(k):
                ex(idx, torch.randn((chunk, bs, nz), generator=g, device="cuda"), lr, lr)

        def eager(k):
            for i in range(k):
                ids = idx[i % chunk]
                train_step(a.gen, a.disc, a.opt_g, a.opt_d, normalize_u8(ds.gather(ids)),
                           ds.source_id[ids], torch.randn((bs, nz), generator=g, device="cuda"),
                           lr, lr, a.scfg, d_train=d_train, mask_on=mask_on)

        def ms(fn, k, steps):
            fn(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(k)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / steps * 1e3

        label = "masked" if mask_on else "unmasked"
        times[label] = (ms(replayed, REPLAYED_CHUNKS, REPLAYED_CHUNKS * chunk),
                        ms(eager, EAGER_TIMED, EAGER_TIMED),
                        ms(replayed, REPLAYED_CHUNKS, REPLAYED_CHUNKS * chunk))
        if mask_on:
            # the replay alone, between CUDA events: the chunk's device time
            ex(idx, torch.randn((chunk, bs, nz), generator=g, device="cuda"), lr, lr)
            dev_ms = time_ms(torch, ex.graph.replay, iters=REPLAYED_CHUNKS, warmup=1) / chunk
            t_trace = time.perf_counter()
            with tempfile.TemporaryDirectory() as log_dir:
                with profiler.trace(log_dir) as prof:
                    replayed(1)
                summary = profiler.summarize(prof, steps=chunk)
            t_trace = time.perf_counter() - t_trace
    parts = ", ".join(f"{k} {r0:.3f} / {r1:.3f} replayed, {e:.3f} eager"
                      for k, (r0, e, r1) in times.items())
    phase("chunked", f"ms/step, synchronised, batch {bs} ({CARD}; replayed = "
          f"{REPLAYED_CHUNKS} chunks of "
          f"{chunk} with their noise draws and copies, before / after {EAGER_TIMED} eager "
          "steps): "
          + parts)
    r_masked = (times["masked"][0] + times["masked"][2]) / 2
    traced = (f"the trace of 1 replayed chunk ({t_trace:.2f} s with its export and summary) "
              f"shows {summary['launches_per_step']:.1f} device "
              f"operations per step, device busy {summary['device_busy_ms']:.2f} ms of "
              f"{summary['wall_ms']:.2f} ms traced ({summary['busy_share']:.3f})"
              if summary["device_busy_ms"] > 0 else
              "the trace of 1 replayed chunk shows no device operation (a replay is one "
              "graph launch to the profiler)")
    phase("chunked", f"a replayed masked chunk: {dev_ms:.3f} ms a step of device time "
          f"(CUDA events around the replay alone) against {r_masked:.3f} ms a step through the "
          f"executor: device busy {dev_ms / r_masked:.3f} of the step; {traced}")
    if summary["device_busy_ms"] > 0:
        for op in summary["top"][:6]:
            phase("chunked", f"  {op['ms']:9.3f} ms  x{op['count']:5d}  {op['name'][:110]}")
    return snapshot, a


def serve_phase(torch, np, ckpt: Path):
    """A Sampler from the ``final`` run's checkpoint: 256 images at batch 64,
    one graph replay a batch after an eager warm-up batch."""
    from strainer_gan_tpu_torch.serve import Sampler

    s = Sampler.from_checkpoint(str(ckpt), batch_size=64)
    t0 = time.perf_counter()
    imgs = s.sample(256, seed=0)
    first = time.perf_counter() - t0
    check(imgs.shape == (256, 64, 64, 3) and imgs.dtype == np.uint8 and imgs.std() > 1,
          f"sampler output {imgs.shape} {imgs.dtype}")
    check(s.replays == 3, f"{s.replays} of 4 batches replayed, want 3 after the warm-up")
    g = torch.Generator().manual_seed(3)
    zs = [torch.randn((64, s.cfg.model.nz), generator=g) for _ in range(4)]
    for z in zs:
        check(torch.equal(s._run(z), s._sample_batch(z.cuda())),
              "a replayed batch differs from the eager batch on the same noise")

    def per_batch(fn):
        fn(zs[0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(20):
            fn(zs[i % 4])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 20 * 1e3

    rep, eag = per_batch(s._run), per_batch(lambda z: s._sample_batch(z.cuda()))
    phase("serve", f"Sampler.from_checkpoint (final, epoch 3), 256 images at batch 64 in "
          f"{first:.3f} s (warm-up and capture included); replayed batches bit-equal to "
          f"eager ones; latency a batch, synchronised, 20 batches ({CARD}): replayed "
          f"{rep:.3f} ms, eager {eag:.3f} ms")


def gmm_sensitivity(GM, fit) -> float:
    """The GMM threshold's largest relative move when one of the fitted
    means or variances moves by 1e-6 (relative)."""
    base = float(GM.gaussian_intersection_threshold(fit))
    worst = 0.0
    for field in ("means", "vars"):
        for i in range(2):
            for sign in (1.0, -1.0):
                t = getattr(fit, field).clone()
                t[i] = t[i] * (1.0 + sign * 1e-6)
                moved = float(GM.gaussian_intersection_threshold(fit._replace(**{field: t})))
                worst = max(worst, abs(moved - base) / abs(base))
    return worst


def loss_space_phases(torch, np, staged):
    """``loss_gmm``, ``loss_ensemble`` and ``autoencoder`` at full width on the
    first 16,384 images of the ``zscore_dbscan`` phase's staged mixture (the
    presets' own data configuration), viewed on the card, not staged again."""
    from strainer_gan_tpu_torch import get_preset, kernels
    from strainer_gan_tpu_torch.ops import gmm as GM
    from strainer_gan_tpu_torch.parity.agreement import agreement_report
    from strainer_gan_tpu_torch.strain import engine as E, thresholds as TH
    from strainer_gan_tpu_torch.train.loop import Trainer
    from strainer_gan_tpu_torch.train.schedules import clean_ratio_at

    ds = staged.head(16_384)
    for name, epochs in (("loss_gmm", 2), ("loss_ensemble", 4), ("autoencoder", 4)):
        cfg = get_preset(name)
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=epochs))
        sc = cfg.strain
        tr = Trainer(cfg, dataset=ds)
        eng = tr.engine
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tr.setup()
        events = []
        for e in range(epochs):
            k1 = kernels.launch_counts()["bce_scores"]
            out = tr.run_epoch(e)
            k1 = kernels.launch_counts()["bce_scores"] - k1
            check(eng.active is eng.base_active and bool(eng.active.all()),
                  f"{name}: reset_each_epoch did not restore the full set after epoch {e}")
            if e < sc.start_epoch:
                check(tr.mask_history[e].all(), f"{name}: strained before epoch {sc.start_epoch}")
                continue
            mask = tr.mask_history[e]
            text = (f"epoch {e}: kept {int(mask.sum())}/{ds.n} at {float(eng.last_threshold):.8g}"
                    f" in {out['strain_seconds']:.3f} s (strain event), {out['steps']} steps in "
                    f"{out['seconds'] - out['strain_seconds']:.3f} s")
            if name != "autoencoder":
                check(k1 >= 1, f"{name}: K1 not launched in the epoch-{e} strain event")
                # the card's threshold and mask against the CPU plain path on
                # the same losses, unless the fit is degenerate: D's losses
                # all near one value (an untrained D scores every image near
                # log 2) give two coinciding components, whose intersection
                # is a ratio of rounding errors on any device
                fit = GM.fit_gmm2(eng.last_scores)
                gap = float((fit.means[1] - fit.means[0]).abs() / fit.vars.max().sqrt())
                if gap < 1e-3:
                    check(name == "loss_ensemble" or np.array_equal(
                        mask, (eng.last_scores < eng.last_threshold).cpu().numpy()),
                        f"{name} epoch {e}: the mask is not loss < threshold")
                    events.append(text + f"; K1 launched {k1}; the GMM's components coincide "
                                  f"(means {gap:.2g} std apart): its threshold is not compared "
                                  "with the CPU's")
                    check(k1 >= 1, f"{name}: K1 not launched in the epoch-{e} strain event")
                    continue
                cpu = eng.last_scores.cpu()
                fn = TH.gmm_mask if name == "loss_gmm" else TH.ensemble_mask
                c_mask, c_thr = fn(cpu)
                g_mask, g_thr = fn(eng.last_scores)
                # the EM on both devices: its parameters agree to the rounding
                # of 16,384-term sums, and the intersection inherits their
                # condition: the tolerance is 1e-5 (relative) or 100 times the
                # threshold's move when one fitted mean or variance moves by
                # 1e-6 (relative), whichever is larger
                fit_c = GM.fit_gmm2(cpu)
                p_rel = max(float(((a.cpu() - b).abs() / b.abs()).max())
                            for a, b in zip(fit, fit_c))
                kappa = gmm_sensitivity(GM, fit_c)
                tol = max(1e-5, 100 * kappa) if name == "loss_gmm" else 1e-5
                rel = abs(float(g_thr) - float(c_thr)) / abs(float(c_thr))
                check(rel <= tol, f"{name} epoch {e}: card threshold {float(g_thr)!r} vs the "
                      f"CPU's {float(c_thr)!r}: {rel:.3g} (relative) against {tol:.3g}")
                lo, hi = sorted((float(g_thr), float(c_thr)))
                flipped = (g_mask.cpu() != c_mask).numpy()
                f_loss = cpu.numpy()[flipped].astype(np.float64)
                check(bool(np.all((f_loss >= lo) & (f_loss <= hi))),
                      f"{name} epoch {e}: a flip lies outside the two thresholds")
                if name == "loss_ensemble":
                    ratio = clean_ratio_at(e, sc.clean_ratio_schedule)
                    c_mask = E._truncate_in_order(c_mask, E.keep_count(c_mask, ratio))
                check(np.array_equal(mask, c_mask.numpy()) or flipped.any(),
                      f"{name} epoch {e}: the strain mask is not the CPU path's")
                dist = np.abs(f_loss - float(c_thr)) / abs(float(c_thr))
                text += (f"; K1 launched {k1}; GMM parameters within {p_rel:.2g} of the CPU "
                         f"fit's; threshold {float(g_thr):.8g} vs the CPU plain path's "
                         f"{float(c_thr):.8g} (relative {rel:.2g}, tolerance {tol:.2g}; the GMM "
                         f"threshold moves {kappa:.2g} for 1e-6 in a parameter), "
                         f"{int(flipped.sum())} flips"
                         + (f" at {', '.join(f'{x:.2g}' for x in dist[:8])}"
                            + (f", ... up to {float(dist.max()):.2g}" if dist.size > 8 else "")
                            + " (relative to the CPU threshold, all between the two)"
                            if flipped.any() else ""))
            events.append(text)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        check(events, f"{name}: no strain event")
        extra = ""
        if name == "autoencoder":
            report = agreement_report(tr, epoch=epochs - 1)
            check(report.get("agreement") == 1.0, f"autoencoder parity report {report}")
            extra = (f"; AE trained in {eng.ae_train_seconds:.3f} s ({sc.ae_train_epochs} "
                     f"epochs); parity against the numpy oracle {json.dumps(report)}")
        else:
            check(launches["bce_scores"] >= len(events), f"{name}: K1 launches {launches}")
        check(np.all(np.isfinite(tr.logger.D_losses)), f"{name}: non-finite losses")
        phase(name, f"{ds.n} images (the first 16,384 of zscore_dbscan's mixture), "
              f"{epochs} epochs in {seconds:.2f} s; " + "; ".join(events) + extra
              + f"; kernels {json.dumps(launches)}; {graphs(tr, name)}")


# ---- the MNIST family and FID


def trained_tensors(torch, tr) -> list:
    """Every tensor a step writes: G's and D's parameters and buffers and
    both Adams' state."""
    ts = [*tr.gen.parameters(), *tr.gen.buffers(), *tr.disc.parameters(), *tr.disc.buffers()]
    for opt in (tr.opt_g, tr.opt_d):
        ts += [t for st in opt.state.values() for t in st.values()
               if isinstance(t, torch.Tensor)]
    return ts


def mlp_chunk_inputs(torch, tr, seed: int):
    """Sample indices, noise and (with dropout) keep masks for one chunk,
    the masks drawn step by step from the Trainer's own generator."""
    chunk, bs = tr.cfg.train.steps_per_dispatch, tr.cfg.data.batch_size
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, tr.dataset.n, (chunk, bs), generator=g, device="cuda")
    z = torch.randn((chunk, bs, tr.cfg.model.nz), generator=g, device="cuda")
    drops = [tr.step_dropout(0, j) for j in range(chunk)]
    return idx, z, [torch.stack(ms) for ms in zip(*drops)]


def mlp_eager_steps(torch, tr, idx, z, drop, lr_g, lr_d) -> list:
    """The chunk's steps one by one through ``train_step``; their metrics."""
    from strainer_gan_tpu_torch.data import normalize_u8
    from strainer_gan_tpu_torch.train.steps import train_step

    ds, out = tr.dataset, []
    for j in range(idx.shape[0]):
        out.append(train_step(tr.gen, tr.disc, tr.opt_g, tr.opt_d,
                              normalize_u8(ds.gather(idx[j]), torch.float32),
                              ds.source_id[idx[j]], z[j], lr_g, lr_d, tr.scfg,
                              drop_masks=[m[j] for m in drop] or None))
    return out


def mlp_step_ms(torch, tr, idx, z, drop, lr_g, lr_d) -> tuple:
    """ms/step, synchronised, of ``REPLAYED_CHUNKS`` replayed chunks (the
    inputs' copies included) and of one chunk's steps run eagerly, on one
    input."""
    ex = tr._executors[next(iter(tr._executors))]
    ex(idx, z, lr_g, lr_d, drop=drop)
    mlp_eager_steps(torch, tr, idx[:2], z[:2], [m[:2] for m in drop], lr_g, lr_d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPLAYED_CHUNKS):
        ex(idx, z, lr_g, lr_d, drop=drop)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mlp_eager_steps(torch, tr, idx, z, drop, lr_g, lr_d)
    torch.cuda.synchronize()
    n = idx.shape[0]
    return (t1 - t0) / (REPLAYED_CHUNKS * n) * 1e3, (time.perf_counter() - t1) / n * 1e3


def mnist8_phase(torch, np, out_dir: Path):
    """``mnist8`` through the command line for 2 epochs (the G-first MLP
    step, the auto batch), the same run at steps_per_dispatch=1 bit-equal,
    its 28x28 grids, ms/step replayed and eager, and the Sampler serving
    its checkpoint."""
    from strainer_gan_tpu_torch import cli, get_preset
    from strainer_gan_tpu_torch.serve import Sampler
    from strainer_gan_tpu_torch.train.loop import Trainer

    args = ["--preset", "mnist8", "--epochs", "2", "--out", str(out_dir),
            "--checkpoint-every", "2", "--save-samples-every", "1"]
    phase("mnist8", "python -m strainer_gan_tpu_torch.cli " + " ".join(args))
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        tr, results = cli.run(args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    staging(tr, "mnist8")
    cfg, shipped = tr.cfg, get_preset("mnist8")
    bs = min(max(tr.dataset.n // shipped.data.auto_batch_divisor, 16), 64)
    check(bs == 64 and cfg == shipped.replace(
        data=dataclasses.replace(shipped.data, batch_size=bs),
        train=dataclasses.replace(shipped.train, epochs=2)),
        f"mnist8 ran another config than the preset at --epochs 2 (batch {cfg.data.batch_size})")
    check(tr.scfg.g_before_d and tr.scfg.flatten and not tr.scfg.dropout,
          "mnist8 is not the G-first plain MLP step")
    losses = tr.logger.D_losses + tr.logger.G_losses
    check(np.all(np.isfinite(losses)), "mnist8: non-finite losses")
    phase("mnist8", f"{tr.dataset.n} images (28x28x1, digits 8), G 100-256-512-1024-784 / D "
          f"784-1024-512-256-1, {cfg.model.compute_dtype}, auto batch {bs}, "
          f"{sum(r['steps'] for r in tr.epoch_results)} steps G first; whole CLI run "
          f"{total:.2f} s; {graphs(tr, 'mnist8')}")
    check_png(out_dir / "samples.png", *grid_side(64, 8, 28), channels=1)
    for e in (1, 2):
        check_png(out_dir / f"samples_epoch{e}.png", *grid_side(25, 5, 28), channels=1)

    eager = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, steps_per_dispatch=1)),
                    dataset=tr.dataset)
    eager.logger.stream = io.StringIO()
    eager.setup()
    for e in range(cfg.train.epochs):
        eager.run_epoch(e)
    check(eager.graph_stats["replays"] == 0, "the per-step run replayed a graph")
    phase("mnist8", same_run(torch, np, tr, eager, tee.copy.getvalue(),
                             eager.logger.stream.getvalue(),
                             "mnist8 steps_per_dispatch=32 vs 1, epochs 0-1"))

    s = Sampler.from_checkpoint(str(out_dir / "ckpt"), batch_size=64)
    imgs = s.sample(256, seed=0)
    check(imgs.shape == (256, 28, 28, 1) and imgs.dtype == np.uint8 and imgs.std() > 1,
          f"mnist8 sampler output {imgs.shape} {imgs.dtype}")
    check(s.replays == 3, f"{s.replays} of 4 batches replayed, want 3 after the warm-up")
    g = torch.Generator().manual_seed(3)
    zs = [torch.randn((64, 100), generator=g) for _ in range(4)]
    for z in zs:
        check(torch.equal(s._run(z), s._sample_batch(z.cuda())),
              "a replayed mnist8 batch differs from the eager batch on the same noise")

    def per_batch(fn):
        fn(zs[0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(20):
            fn(zs[i % 4])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 20 * 1e3

    rep, eag = per_batch(s._run), per_batch(lambda z: s._sample_batch(z.cuda()))
    idx, z, drop = mlp_chunk_inputs(torch, tr, 5)
    lr = cfg.train.lr_g
    t_rep, t_eag = mlp_step_ms(torch, tr, idx, z, drop, lr, lr)
    phase("mnist8", f"ms/step, synchronised, batch {bs} ({CARD}): replayed {t_rep:.4f} "
          f"({REPLAYED_CHUNKS} chunks of {idx.shape[0]}), eager {t_eag:.4f}; Sampler (epoch 1 "
          "checkpoint), "
          f"256 images as (28, 28, 1) uint8, replayed batches bit-equal to eager ones; "
          f"ms a batch of 64: replayed {rep:.3f}, eager {eag:.3f}")


MNIST_FULL_EPOCHS = 3  # and its periodic FID every 3 epochs (shipped: 300 and 100)


def mnist_full_phase(torch, np, out_dir: Path):
    """``mnist_full`` through the command line for ``MNIST_FULL_EPOCHS``
    epochs (a config JSON with its FID every as many): the 1-channel
    z-score prefilter (K2a,
    K2b at numpy_eps) held to the plain path on the card, the D-first
    dropout step (a replayed chunk bit-equal to its 32 eager steps, fresh
    masks every replay), the periodic FID at the last epoch and the parity
    report."""
    from strainer_gan_tpu_torch import cli, get_preset, kernels
    from strainer_gan_tpu_torch.eval import fid as FID
    from strainer_gan_tpu_torch.kernels import zscore as KZ
    from strainer_gan_tpu_torch.strain import score as SC
    from strainer_gan_tpu_torch.strain import thresholds as TH
    from strainer_gan_tpu_torch.train import steps as ST

    shipped = get_preset("mnist_full")
    want = shipped.replace(
        train=dataclasses.replace(shipped.train, epochs=MNIST_FULL_EPOCHS),
        eval=dataclasses.replace(shipped.eval, fid_every_epochs=MNIST_FULL_EPOCHS))
    config = out_dir / "mnist_full.json"
    config.write_text(want.to_json())
    args = ["--config", str(config), "--out", str(out_dir), "--parity-check"]
    phase("mnist_full", "python -m strainer_gan_tpu_torch.cli " + " ".join(args)
          + f" (mnist_full with epochs={MNIST_FULL_EPOCHS}, "
          f"fid_every_epochs={MNIST_FULL_EPOCHS})")
    # the masks of the first replays' first steps, to see that they change
    seen, call = [], ST.ChunkedStep.__call__

    def watched(self, idx, z, lr_g, lr_d, **kw):
        out = call(self, idx, z, lr_g, lr_d, **kw)
        if len(seen) < 4:
            check(all(torch.equal(b, m) for b, m in zip(self.drop, kw["drop"])),
                  "a chunk's keep-mask buffers do not hold the masks it was given")
            seen.append(kw["drop"][0][:, 0].clone())
        return out

    ST.ChunkedStep.__call__ = watched
    n_fid = len(FID.calls)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(Tee(sys.stdout)) as tee:
            tr, results = cli.run(args)
        torch.cuda.synchronize()
    finally:
        ST.ChunkedStep.__call__ = call
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    staging(tr, "mnist_full")
    cfg = tr.cfg
    check(cfg == want, "the mnist_full preset was changed beyond its epochs and FID cadence")
    check(launches["zscore_column_stats"] >= 1 and launches["zscore_row_max"] >= 1,
          f"mnist_full's prefilter did not launch K2a and K2b: {launches}")
    check(results["parity"]["agreement"] == 1.0, f"mnist_full parity {results['parity']}")
    sd = tr.scfg
    check(sd.dropout == 0.3 and not sd.g_before_d and sd.real_label == 0.9
          and sd.fake_label == 0.1, "mnist_full is not the D-first dropout step")
    check(len(seen) >= 2 and all(not torch.equal(a, b) for a, b in zip(seen, seen[1:])),
          "consecutive replays saw the same keep masks")
    losses = tr.logger.D_losses + tr.logger.G_losses
    check(np.all(np.isfinite(losses)), "mnist_full: non-finite losses")
    check_png(out_dir / "samples.png", *grid_side(64, 8, 28), channels=1)

    # the prefilter: K2a + K2b against the plain path on the same features
    feats = tr.engine._features
    n, d = feats.shape
    mask = tr.mask_history[0]
    z_k = KZ.masked_max_abs_z(feats, None, "numpy_eps")
    z_p = TH._masked_max_abs_z(feats, None, "numpy_eps")
    m_p = (z_p < cfg.strain.z_threshold).cpu().numpy()
    check(np.array_equal(mask, m_p), f"mnist_full's prefilter mask differs from the plain "
          f"path's on the card: {int((mask != m_p).sum())} flips")
    mean, std = KZ.column_stats(feats, None, "numpy_eps")
    mean_p, std_p = KZ.column_stats_plain(feats, None, "numpy_eps")
    err_a = max(float((mean - mean_p).abs().max()), float((std - std_p).abs().max()))
    check(err_a <= 1e-5 * max(1.0, float(mean_p.abs().max()), float(std_p.abs().max())),
          f"K2a at numpy_eps off its plain version by {err_a}")
    check(torch.equal(z_k, KZ.row_max_abs_z_plain(feats, mean, std)),
          "K2b is not bit-equal to its plain version at mnist_full's shape")
    t_a = time_ms(torch, lambda: KZ.column_stats(feats, None, "numpy_eps"), iters=20)
    t_ap = time_ms(torch, lambda: KZ.column_stats_plain(feats, None, "numpy_eps"), iters=20)
    t_al = time_ms(torch, lambda: torch.std_mean(feats, dim=0, correction=0), iters=20)
    t_b = time_ms(torch, lambda: KZ.row_max_abs_z(feats, mean, std), iters=20)
    t_bp = time_ms(torch, lambda: KZ.row_max_abs_z_plain(feats, mean, std), iters=20)
    ba, _ = bound_ms(4.0 * n * d + 8.0 * d, 4.0 * n * d)
    bb, _ = bound_ms(4.0 * n * d + 8.0 * d + 4.0 * n, 4.0 * n * d)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    SC.score_features(tr.engine.feature_fn, tr.dataset)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t1
    phase("mnist_full", f"{tr.dataset.n} images (8s, 10% 1s, 10% 2s; "
          f"{int((tr.dataset.source_id != 0).sum())} contaminants), prefilter on 1-channel "
          f"ResNet18 features at numpy_eps, threshold {cfg.strain.z_threshold}: kept "
          f"{int(mask.sum())}, mask equal to the plain path's on the card; K2a "
          f"{n}x{d}: max_abs_err={err_a:.3g} kernel_ms={t_a:.5f} plain_ms={t_ap:.5f} "
          f"library_ms={t_al:.5f} bound_ms={ba:.5f}; K2b bit-equal kernel_ms={t_b:.5f} "
          f"plain_ms={t_bp:.5f} bound_ms={bb:.5f}; the feature pass {feat_s * 1e3:.1f} ms "
          f"({CARD}); kernels {json.dumps(launches)}")
    phase("mnist_full", f"whole CLI run {total:.2f} s, {sum(r['steps'] for r in tr.epoch_results)}"
          f" steps over {MNIST_FULL_EPOCHS} epochs, batch {cfg.data.batch_size}, D dropout {sd.dropout}, labels "
          f"{sd.real_label}/{sd.fake_label}; parity {results['parity']['agreement']}; "
          f"{graphs(tr, 'mnist_full')}")

    # one replayed chunk against its 32 eager steps, from the same state
    lr_g, lr_d = cfg.train.lr_g, cfg.train.lr_d
    idx, z, drop = mlp_chunk_inputs(torch, tr, 7)
    ts = trained_tensors(torch, tr)
    before = [t.detach().clone() for t in ts]
    ex = tr._executors[next(iter(tr._executors))]
    m_rep = ex(idx, z, lr_g, lr_d, drop=drop)
    after_rep = [t.detach().clone() for t in ts]
    with torch.no_grad():
        for t, b in zip(ts, before):
            t.copy_(b)
    m_eag = mlp_eager_steps(torch, tr, idx, z, drop, lr_g, lr_d)
    check(all(torch.equal(t, a) for t, a in zip(ts, after_rep)),
          "a replayed mnist_full chunk differs from its 32 eager steps (state)")
    check(all(torch.equal(m_rep[k][j], m[k]) for j, m in enumerate(m_eag) for k in m),
          "a replayed mnist_full chunk differs from its 32 eager steps (metrics)")
    t_rep, t_eag = mlp_step_ms(torch, tr, idx, z, drop, lr_g, lr_d)
    phase("mnist_full", f"a replayed chunk of {idx.shape[0]} steps bit-equal to the same steps "
          f"eager (state and metrics, same noise and keep masks); {len(seen)} consecutive "
          f"replays each with fresh masks; ms/step, synchronised, batch "
          f"{cfg.data.batch_size} ({CARD}): replayed {t_rep:.4f}, eager {t_eag:.4f}")

    # the periodic FID of the last epoch
    check([e for e, _ in tr.fid_history] == [MNIST_FULL_EPOCHS - 1],
          f"FID history {tr.fid_history}")
    calls = FID.calls[n_fid:]
    check(len(calls) == 2, f"{len(calls)} FID computations, want real and contaminant")
    check(all(np.isfinite(c["fid"]) for c in calls), f"non-finite periodic FID {calls}")
    check(tr.fid_history[0][1] == calls[0]["fid"]
          and f"Epoch {MNIST_FULL_EPOCHS}: FID = {calls[0]['fid']}" in tee.copy.getvalue(),
          "the periodic FID's console line is missing")
    phase("mnist_full", f"periodic FID (epoch {MNIST_FULL_EPOCHS}, L2-normalised activations, "
          "synthetic "
          "InceptionV3 weights): " + "; ".join(
              f"{name} {c['fid']:.6g} on {c['n']} images, activations {c['activations_s']:.3f} s,"
              f" sqrtm {c['distance_s']:.3f} s ({c['branch']})"
              for name, c in zip(("real", "contaminant"), calls)) + f" ({CARD})")


def fid_phase(torch, np):
    """The port's FID chain on the card on ``tests/fixtures/backbones.npz``
    (written by a torch oracle with scipy): activations, the whole chain,
    and the Newton-Schulz square root against eigh at 2048 dimensions."""
    from strainer_gan_tpu_torch.eval import fid as FID
    from strainer_gan_tpu_torch.models.inception import InceptionV3Features
    from strainer_gan_tpu_torch.models.synth_weights import load_synth_weights
    from strainer_gan_tpu_torch.ops import sqrtm as SQ

    fx = np.load(HERE / "tests" / "fixtures" / "backbones.npz")
    model = load_synth_weights(InceptionV3Features()).eval().cuda()

    def nchw(u8):
        x = ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5
        return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().cuda()

    a, b = nchw(fx["fid_a_u8"]), nchw(fx["fid_b_u8"])
    acts = FID.get_activations(a, model, batch_size=16)
    err = float(np.abs(acts.cpu().numpy() - fx["inception_acts_a"]).max())
    check(err <= 2e-3, f"InceptionV3 activations off the fixture by {err}")
    fid = FID.calculate_fid(a, b, model, batch_size=16)
    rel = abs(fid - float(fx["fid_value"])) / abs(float(fx["fid_value"]))
    check(rel <= 2e-2, f"FID {fid} off the fixture's {float(fx['fid_value'])} by {rel:.3g}")
    c = FID.calls[-1]
    g = torch.Generator(device="cuda").manual_seed(0)
    pair = []
    for _ in range(2):
        x = torch.randn((4096, 2048), generator=g, device="cuda")
        pair.append(x.T @ x / 4096 + 0.1 * torch.eye(2048, device="cuda"))
    times = {}
    for name, fn in (("ns", SQ.trace_sqrtm_product_ns), ("eigh", SQ.trace_sqrtm_product)):
        fn(*pair)
        torch.cuda.synchronize()
        t = time.perf_counter()
        times[name] = (float(fn(*pair)), time.perf_counter() - t)
    ns, eig = times["ns"][0], times["eigh"][0]
    check(abs(ns - eig) <= 1e-3 * abs(eig), f"NS trace {ns} vs eigh {eig}")
    imgs = torch.rand((500, 3, 28, 28), generator=g, device="cuda") * 2 - 1
    FID.get_activations(imgs[:50], model)
    torch.cuda.synchronize()
    t = time.perf_counter()
    FID.get_activations(imgs, model)
    torch.cuda.synchronize()
    per_img = (time.perf_counter() - t) / 500 * 1e3
    phase("fid", f"backbones.npz on the card (float32, TF32 off): InceptionV3 activations "
          f"within {err:.3g} of the fixture (tol 2e-3); FID {fid:.6g} vs {float(fx['fid_value']):.6g}"
          f" (rel {rel:.3g}, tol 2e-2; {c['branch']} branch, 16 samples); 2048-dim "
          f"well-conditioned pair: NS trace {ns:.7g} vs eigh {eig:.7g} "
          f"(rel {abs(ns - eig) / abs(eig):.3g}, tol 1e-3), NS {times['ns'][1] * 1e3:.1f} ms, "
          f"eigh {times['eigh'][1] * 1e3:.1f} ms; InceptionV3 at batch 50 (299x299): "
          f"{per_img:.3f} ms an image ({CARD})")


EVAL_ARGS = ["--preset", "strainer_gan", "--epochs", "1", "--max-synth", "2560", "--eval",
             "--eval-samples", "500"]
EVAL_KEYS = ("feature_distance_real", "wasserstein_real", "feature_distance_contaminant",
             "wasserstein_contaminant", "fid_real", "fid_contaminant")


def spectrum_features(np, rng, n: int, basis) -> "np.ndarray":
    """``n`` seeded 2048-dim feature rows with a decaying spectrum (64
    directions, each 0.9 of the last, plus a little noise), so that the top
    50 principal components are well separated."""
    k = basis.shape[0]
    x = (rng.standard_normal((n, k)) * 0.9 ** np.arange(k)) @ basis
    return (x + 0.01 * rng.standard_normal((n, basis.shape[1]))).astype(np.float32)


def numpy_pca_wasserstein(np, f1, f2, k: int = 50) -> float:
    """The suite's PCA-Wasserstein distance in float64 numpy: an SVD of the
    centred ``f1``, sklearn's svd_flip signs, ``f2`` projected, and the mean
    over components of scipy's 1-D Wasserstein distance."""
    from scipy.stats import wasserstein_distance

    f1, f2 = f1.astype(np.float64), f2.astype(np.float64)
    mean = f1.mean(0)
    _, _, vt = np.linalg.svd(f1 - mean, full_matrices=False)
    comps = vt[:k]
    comps = comps * np.sign(comps[np.arange(k), np.abs(comps).argmax(1)])[:, None]
    p1, p2 = (f1 - mean) @ comps.T, (f2 - mean) @ comps.T
    return float(np.mean([wasserstein_distance(p1[:, i], p2[:, i]) for i in range(k)]))


def eval_phase(torch, np, out_dir: Path):
    """The eval suite on the card: ResNet50 on the backbone fixture, the
    distances against float64 numpy, then ``strainer_gan`` through the
    command line with ``--eval``."""
    from strainer_gan_tpu_torch import cli, kernels
    from strainer_gan_tpu_torch.eval import distances as DI
    from strainer_gan_tpu_torch.eval import fid as FID
    from strainer_gan_tpu_torch.eval import suite as SU
    from strainer_gan_tpu_torch.models.features import build_feature_fn

    # ResNet50 (synthetic weights) against the torch oracle's features
    fx = np.load(HERE / "tests" / "fixtures" / "backbones.npz")
    x = ((fx["resnet_input_u8"].astype(np.float32) / 255.0) - 0.5) / 0.5
    t0 = time.perf_counter()
    ffn = build_feature_fn("resnet50", 3, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got = ffn(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().cuda()).cpu().numpy()
    want = fx["resnet50_features"]
    err = np.abs(got - want)
    check(bool(np.all(err <= 1e-2 + 1e-3 * np.abs(want))),
          f"ResNet50 off the fixture: max abs {err.max():.3g}")
    g = torch.Generator(device="cuda").manual_seed(3)
    imgs = torch.rand((256, 3, 64, 64), generator=g, device="cuda") * 2 - 1
    rn_ms = time_ms(torch, lambda: ffn(imgs), iters=5, warmup=1) / 256

    # the distances against float64 numpy, at the suite's shapes
    rng = np.random.default_rng(17)
    basis = rng.standard_normal((64, 2048))
    fake, cont = spectrum_features(np, rng, 500, basis), spectrum_features(np, rng, 409, basis)
    fake[:, :64] += 0.5  # a shifted distribution
    tf, tc = torch.from_numpy(fake).cuda(), torch.from_numpy(cont).cuda()
    w = float(DI.pca_wasserstein_distance(tc, tf))
    d = float(DI.mean_feature_distance(tc, tf))
    w_np = numpy_pca_wasserstein(np, cont, fake)
    d_np = float(np.linalg.norm(cont.astype(np.float64).mean(0) - fake.astype(np.float64).mean(0)))
    rel_w, rel_d = abs(w - w_np) / abs(w_np), abs(d - d_np) / abs(d_np)
    check(rel_w <= 1e-3, f"PCA-Wasserstein {w} vs float64 numpy {w_np} (rel {rel_w:.3g})")
    check(rel_d <= 1e-5, f"mean feature distance {d} vs float64 numpy {d_np} (rel {rel_d:.3g})")
    svd_ms = time_ms(torch, lambda: torch.linalg.svd(tc - tc.mean(0), full_matrices=False),
                     iters=5, warmup=1)
    pw_ms = time_ms(torch, lambda: DI.pca_wasserstein_distance(tc, tf), iters=5, warmup=1)
    phase("eval", f"ResNet50 (synthetic weights, float32, TF32 off) on backbones.npz: max abs "
          f"err {err.max():.3g} (tol 1e-2 + 1e-3|ref|), built in {build_s:.2f} s, "
          f"{rn_ms:.4f} ms an image at batch 256 (64x64); 409 vs 500 x 2048 features: "
          f"PCA-50 Wasserstein {w:.7g} vs float64 numpy {w_np:.7g} (rel {rel_w:.3g}, tol 1e-3), "
          f"feature distance rel {rel_d:.3g} (tol 1e-5); SVD of 409x2048 {svd_ms:.2f} ms, the "
          f"whole PCA-Wasserstein {pw_ms:.2f} ms ({CARD})")

    # the suite through the command line
    args = EVAL_ARGS + ["--out", str(out_dir)]
    phase("eval", "python -m strainer_gan_tpu_torch.cli " + " ".join(args))
    n_su, n_fid = len(SU.calls), len(FID.calls)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr, results = cli.run(args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    staging(tr, "eval")
    ev = results.get("eval", {})
    check(set(ev) == set(EVAL_KEYS) and all(np.isfinite(ev[k]) for k in EVAL_KEYS),
          f"--eval gave {ev}")
    with open(out_dir / "metrics.json") as f:
        check(json.load(f).get("eval") == ev, "metrics.json does not hold the eval results")
    su, fids = SU.calls[n_su:], FID.calls[n_fid:]
    check(len(su) == 1 and len(fids) == 2, f"{len(su)} suite calls, {len(fids)} FIDs")
    phase("eval", f"{tr.dataset.n} images, 1 epoch, then the suite on 500 samples: "
          + ", ".join(f"{k} {ev[k]:.6g}" for k in EVAL_KEYS)
          + f"; ResNet50 feature passes {su[0]['features_s']:.3f} s on {su[0]['n']} images, "
          f"the distances (two SVDs) {su[0]['distances_s']:.3f} s; FIDs: "
          + "; ".join(f"activations {c['activations_s']:.3f} s, sqrtm {c['distance_s']:.3f} s "
                      f"({c['branch']}, {c['n']} images)" for c in fids)
          + f"; whole CLI run {total:.2f} s ({CARD}); kernels {json.dumps(launches)}; "
          f"{graphs(tr, 'eval')}")


DP_CHILD = "--dp-child"


def dp_config(tmp: Path) -> list:
    """The dp phase's runs: ``batch_mask`` gated from epoch 1 for ``BM_EPOCHS`` epochs
    (the chunked phase's configuration, through a config JSON), and
    ``zscore_loss`` as its phase runs it (its epoch-3 strain deferred)."""
    from strainer_gan_tpu_torch import get_preset

    cfg = get_preset("batch_mask")
    cfg = cfg.replace(strain=dataclasses.replace(cfg.strain, mask_start_epoch=1))
    path = tmp / "batch_mask_gate1.json"
    if not path.exists():  # written once: the child reads it while the parent runs
        path.write_text(cfg.to_json())
    return [("batch_mask", ["--config", str(path), "--epochs", str(BM_EPOCHS), "--max-synth",
                            "4096"]),
            ("zscore_loss", zscore_loss_args(tmp))]


def run_snapshot(torch, tr, text: str, launches: dict) -> dict:
    """What the dp phase compares of a run, on the host."""
    out = dict(text=logger_text(text), G=tr.logger.G_losses, D=tr.logger.D_losses,
               history=tr.epoch_loss_history, masks=tr.mask_history, launches=launches,
               results=[{k: r[k] for k in ("steps", "active", "filtered_contam",
                                           "total_contam")} for r in tr.epoch_results],
               last=[{k: v.cpu() for k, v in r["last"].items()} for r in tr.epoch_results],
               grids=tr.img_list, graphs=dict(tr.graph_stats))
    out.update(host_state(torch, tr.gen, tr.disc, tr.opt_g, tr.opt_d))
    return out


def masked_replay_ms(torch, tr) -> float:
    """ms/step of the Trainer's masked chunk replayed on seeded indices and
    noise (``REPLAYED_CHUNKS`` chunks after one, synchronised)."""
    cfg, chunk = tr.cfg, tr.cfg.train.steps_per_dispatch
    key = (chunk, True, not tr.engine.d_bn_eval, True, cfg.model.compute_dtype)
    g = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(0, tr.dataset.n, (chunk, cfg.data.batch_size), generator=g,
                        device="cuda")
    z = torch.randn((chunk, cfg.data.batch_size, cfg.model.nz), generator=g, device="cuda")
    return replay_ms(torch, tr._executors[key], idx, z, cfg.train.lr_d)


def sharded_run(torch, np, tr):
    """``tr``'s run again, from the same configuration, on a copy of its
    images staged by ``DeviceDataset.from_rank_local`` (in a group of one
    rank, the rank's shard is every row): the step's lanes, the scoring
    passes' blocks and the contamination counts go the sample-sharded way,
    and every strain event blocks."""
    from strainer_gan_tpu_torch.data import DeviceDataset, Mixture
    from strainer_gan_tpu_torch.train.loop import Trainer

    ds = tr.dataset
    local = Mixture(ds.images.cpu().numpy(), ds.source_id.cpu().numpy(),
                    np.zeros((ds.n,), np.int64))
    sh = Trainer(tr.cfg, dataset=DeviceDataset.from_rank_local(local, ds.n))
    check(sh.dataset.sharded, "the dataset is not sample-sharded")
    sh.logger.stream = io.StringIO()
    sh.setup()
    for e in range(tr.cfg.train.epochs):
        sh.run_epoch(e)
    torch.cuda.synchronize()
    return sh


def sharded_strain(torch, np, tr) -> dict:
    """``tr``'s prefilter and its first loss strain (``start_epoch``) made
    again by fresh StrainerEngines with ``tr``'s trained D, on ``tr``'s
    dataset and on a copy staged by ``from_rank_local``: there the feature
    and D-loss passes read the rank's block and the base subset's rows come
    in through the exchange.  The base, the mask, the threshold and the
    scores must be bit-equal; returns the sharded engine's kernel
    launches and the base and mask sizes."""
    from strainer_gan_tpu_torch import kernels
    from strainer_gan_tpu_torch.data import DeviceDataset, Mixture
    from strainer_gan_tpu_torch.strain.engine import StrainerEngine

    ds = tr.dataset
    local = Mixture(ds.images.cpu().numpy(), ds.source_id.cpu().numpy(),
                    np.zeros((ds.n,), np.int64))
    out = {}
    for name, d in (("replicated", ds), ("sharded", DeviceDataset.from_rank_local(local, ds.n))):
        kernels.reset_launch_counts()
        eng = StrainerEngine(tr.cfg, tr.disc, d, feature_fn=tr.engine.feature_fn,
                             score_batch=tr.cfg.strain.score_batch)
        base = eng.prefilter().clone()
        mask = eng.on_epoch_start(tr.cfg.strain.start_epoch)
        torch.cuda.synchronize()
        out[name] = dict(base=base.cpu(), mask=mask.cpu(), scores=eng.last_scores.cpu(),
                         thr=eng.last_threshold.cpu(), launches=kernels.launch_counts(),
                         path=eng.last_score_path)
    a, b = out["sharded"], out["replicated"]
    for k in ("base", "mask", "scores", "thr"):
        check(torch.equal(a[k], b[k]), f"sharded strain: {k} differs from the replicated one")
    check(a["path"] == b["path"] and not a["mask"].all() and a["mask"].sum() < a["base"].sum(),
          f"sharded strain: path {a['path']}, kept {int(a['mask'].sum())} of "
          f"{int(a['base'].sum())}")
    return dict(launches=a["launches"], base=int(a["base"].sum()), kept=int(a["mask"].sum()),
                n=ds.n, path=a["path"])


def tp_model(torch, preset: str, grid=None):
    """``preset`` as shipped (bf16 for the DCGAN and the MLP) at full width,
    seeded weights on the card, its optimizers and StepConfig; the state
    placed on ``grid`` by ``put_state_tp`` where one is given."""
    from strainer_gan_tpu_torch import get_preset
    from strainer_gan_tpu_torch.models import build_models
    from strainer_gan_tpu_torch.parallel import mesh as M
    from strainer_gan_tpu_torch.train.state import make_optimizers
    from strainer_gan_tpu_torch.train.steps import step_config_from

    cfg = get_preset(preset)
    gen, disc = (m.cuda() for m in build_models(cfg.model, seed=cfg.train.seed))
    opt_g, opt_d = make_optimizers(cfg, gen, disc)
    if grid is not None:
        M.put_state_tp(grid, [gen, disc], [opt_g, opt_d])
    return cfg, gen, disc, opt_g, opt_d, step_config_from(cfg)


def host_state(torch, gen, disc, opt_g, opt_d) -> dict:
    """Parameters, buffers and optimizer state, on the host."""
    out = {}
    for name, obj in (("gen", gen), ("disc", disc), ("opt_g", opt_g), ("opt_d", opt_d)):
        sd = obj.state_dict()
        if name.startswith("opt"):
            sd = {f"{i}.{k}": v for i, st in sd["state"].items() for k, v in st.items()}
        out.update({f"{name}.{k}": torch.as_tensor(v).cpu() for k, v in sd.items()})
    return out


def digests(torch, tensors: dict) -> dict:
    """Each tensor's dtype, shape and SHA-256 of its bytes: equal digests
    are equal bits, and a process hands over a few bytes a tensor."""
    import hashlib

    return {k: (str(t.dtype), tuple(t.shape), hashlib.sha256(
        t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        .hexdigest()) for k, t in tensors.items()}


def tp_step(torch, grid=None, steps: int = 3) -> dict:
    """``basic`` at full width (nz=100, ngf=ndf=64, batch 128, bf16 as
    shipped), seeded weights, images and noise: one step on ``grid`` (a 1 x
    1 dp x tp grid under the dp child's group) through ``put_state_tp``, or
    with no grid, its metrics and state; then the ms of ``steps`` more
    steps, synchronised."""
    from strainer_gan_tpu_torch.data import normalize_u8
    from strainer_gan_tpu_torch.train.steps import train_step

    cfg, gen, disc, opt_g, opt_d, scfg = tp_model(torch, "basic", grid)
    g = torch.Generator(device="cuda").manual_seed(21)
    bs, lr = cfg.data.batch_size, cfg.train.lr_d
    x = normalize_u8(torch.randint(0, 256, (bs, 64, 64, 3), generator=g, device="cuda",
                                   dtype=torch.uint8))
    src = torch.zeros((bs,), dtype=torch.int32, device="cuda")
    zs = torch.randn((steps + 1, bs, cfg.model.nz), generator=g, device="cuda")
    ctx = grid if grid is not None else contextlib.nullcontext()

    def one(i):
        with ctx:
            return train_step(gen, disc, opt_g, opt_d, x, src, zs[i], lr, lr, scfg)

    m = one(0)
    torch.cuda.synchronize()
    out = dict(metrics={k: v.cpu() for k, v in m.items()},
               state=host_state(torch, gen, disc, opt_g, opt_d))
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        one(i)
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) / steps * 1e3
    return out


# the step variants the tp phase holds to their twins with no group: preset
# as shipped, and the step's gates (the in-step keep on, the pool's gate on)
TP_VARIANTS = (("batch_mask", dict(mask_on=True)), ("in_batch_recycle", dict(mask_on=True)),
               ("strainer_concat_fast", dict(concat_on=True)), ("mnist8", {}),
               ("mnist_full", {}))
TP_POOL_ROWS = 512


def tp_variants(torch, grid=None) -> dict:
    """One step of each of ``TP_VARIANTS`` at full width from seeded
    weights, images, source ids, noise, pool rows (the pool step) and D's
    keep masks (``mnist_full``, from a seeded ``torch.Generator``): on
    ``grid`` (the dp child's 1 x 1 grid) or with no grid.  Each step's
    metrics, and its state's digests."""
    from strainer_gan_tpu_torch.data import normalize_u8
    from strainer_gan_tpu_torch.train.steps import drop_shape, train_step

    out = {}
    for preset, gates in TP_VARIANTS:
        cfg, gen, disc, opt_g, opt_d, scfg = tp_model(torch, preset, grid)
        g = torch.Generator(device="cuda").manual_seed(23)
        bs, d = cfg.data.batch_size, cfg.data
        u8 = torch.randint(0, 256, (bs, d.image_size, d.image_size, d.channels), generator=g,
                           device="cuda", dtype=torch.uint8)
        src = (torch.rand((bs,), generator=g, device="cuda") < 0.3).to(torch.int32)
        z = torch.randn((bs, cfg.model.nz), generator=g, device="cuda")
        kw = dict(gates)
        if scfg.pool_concat:
            kw.update(fake_pool=torch.randint(0, 256, (TP_POOL_ROWS,) + tuple(u8.shape[1:]),
                                              generator=g, device="cuda", dtype=torch.uint8),
                      pool_idx=torch.randint(0, TP_POOL_ROWS, (bs,), generator=g, device="cuda"))
        if scfg.dropout > 0:
            kw["drop_masks"] = [torch.rand(drop_shape(scfg, bs, w), generator=g, device="cuda")
                                >= scfg.dropout for w in scfg.drop_widths]
        with grid if grid is not None else contextlib.nullcontext():
            m = train_step(gen, disc, opt_g, opt_d, normalize_u8(u8), src, z, cfg.train.lr_g,
                           cfg.train.lr_d, scfg, **kw)
        torch.cuda.synchronize()
        out[preset] = dict(metrics={k: v.cpu() for k, v in m.items()},
                           state=digests(torch, host_state(torch, gen, disc, opt_g, opt_d)))
    return out


TP_CHUNK = 8  # steps in the grid's captured chunk (a preset's chunk is 32)


def tp_chunk(torch, grid, counts: dict) -> dict:
    """``batch_mask`` at full width (batch 128, bf16), its keep on, on
    ``grid`` (the dp child's 1 x 1 grid), on 4,096 seeded images on the
    card: from seeded weights a warm-up step, then one chunk of
    ``TP_CHUNK`` steps through ``ChunkedStep`` (captured once with its tp
    and dp collectives, replayed), and from the same weights the same
    warm-up and ``TP_CHUNK`` steps eagerly on the grid.  Returns the
    tensors where the two runs differ (none, for bit-equality), the
    collectives the capture recorded, the ms/step of the eager steps and
    of ``REPLAYED_CHUNKS`` replayed chunks (after one), each synchronised."""
    from strainer_gan_tpu_torch.data import DeviceDataset, normalize_u8
    from strainer_gan_tpu_torch.parallel import mesh as M
    from strainer_gan_tpu_torch.train.steps import ChunkedStep, train_step

    g = torch.Generator(device="cuda").manual_seed(29)
    n = 4096
    ds = DeviceDataset.from_tensors(
        torch.randint(0, 256, (n, 64, 64, 3), generator=g, device="cuda", dtype=torch.uint8),
        (torch.rand((n,), generator=g, device="cuda") < 0.2).to(torch.int32))
    runs, out = {}, {}
    for mode in ("eager", "replayed"):
        cfg, gen, disc, opt_g, opt_d, scfg = tp_model(torch, "batch_mask", grid)
        chunk, bs, lr = TP_CHUNK, cfg.data.batch_size, cfg.train.lr_d
        if mode == "eager":  # the same draws for both runs
            idx = torch.stack([torch.randperm(n, generator=g, device="cuda")[:bs]
                               for _ in range(chunk + 1)])
            z = torch.randn((chunk + 1, bs, cfg.model.nz), generator=g, device="cuda")

        def step(j):
            u8, src = ds.batch(idx[j])
            return train_step(gen, disc, opt_g, opt_d, normalize_u8(u8, torch.float32), src,
                              M.lanes(z[j]), lr, lr, scfg, mask_on=True)

        with grid:
            like = step(0)  # the warm-up: Adam's state and cuDNN's plans exist
            torch.cuda.synchronize()
            if mode == "eager":
                t0 = time.perf_counter()
                ms = [step(j) for j in range(1, chunk + 1)]
                torch.cuda.synchronize()
                out["eager_ms"] = (time.perf_counter() - t0) / chunk * 1e3
                metrics = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
            else:
                ex = ChunkedStep(gen, disc, opt_g, opt_d, ds, scfg, chunk, like, mask_on=True,
                                 d_train=True, stats=dict(captures=0, replays=0, capture_s=[],
                                                          instantiate_s=[]))
                before = dict(counts)
                metrics = ex(idx[1:], z[1:], lr, lr)
                torch.cuda.synchronize()
                out["recorded"] = {k: counts[k] - before[k] for k in counts}
                out["capture_s"] = sum(ex.stats["capture_s"] + ex.stats["instantiate_s"])
        runs[mode] = dict(metrics, **{f"state.{k}": v for k, v in
                                      host_state(torch, gen, disc, opt_g, opt_d).items()})
    a, b = runs["replayed"], runs["eager"]
    out["diffs"] = [k for k, v in b.items() if not torch.equal(a[k].cpu(), v.cpu())]
    out["tensors"], out["chunk"] = len(b), chunk
    out["kept"] = [int(k) for k in b["keep_mask"].sum(1)]
    # replays need no grid around them: the graph holds the collectives
    out["replayed_ms"] = replay_ms(torch, ex, idx[1:], z[1:], lr)
    return out


def dp_child(out_dir: str) -> int:
    """The dp phase's child: under the launcher's environment of one rank,
    ``--dp 1`` joins an NCCL group on the card, and each run goes the rank
    path; saves what the parent compares."""
    t0 = time.perf_counter()
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    from strainer_gan_tpu_torch import cli, kernels
    from strainer_gan_tpu_torch.parallel import mesh as M
    from strainer_gan_tpu_torch.parallel import multihost as MH

    counts = {"all_reduce": 0, "all_gather_into_tensor": 0, "broadcast": 0,
              "reduce_scatter_tensor": 0, "all_gather": 0}
    for name in counts:  # collectives issued eagerly or recorded into a graph
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        setattr(dist, name, counted)
    out, trainers = {}, {}
    try:
        for name, args in dp_config(Path(out_dir)):
            kernels.reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainers[name], _ = cli.run(args + ["--dp", "1"])
            torch.cuda.synchronize()
            check(MH.grouped() and dist.get_backend() == "nccl" and MH.world() == 1,
                  "the dp child is not in an NCCL group of one rank")
            out[name] = run_snapshot(torch, trainers[name], buf.getvalue(),
                                     kernels.launch_counts())
            out[name]["collectives"] = dict(counts)
        # batch_mask on a dataset staged by from_rank_local: each step's
        # lanes come in through the exchange (a reduce-scatter)
        before = dict(counts)
        kernels.reset_launch_counts()
        sh = trainers["batch_mask_sharded"] = sharded_run(torch, np, trainers["batch_mask"])
        out["batch_mask_sharded"] = run_snapshot(torch, sh, sh.logger.stream.getvalue(),
                                                 kernels.launch_counts())
        out["batch_mask_sharded"]["collectives"] = {k: counts[k] - before[k] for k in counts}
        # zscore_loss's prefilter and loss strain on such a dataset
        before = dict(counts)
        out["strain_sharded"] = sharded_strain(torch, np, trainers["zscore_loss"])
        out["strain_sharded"]["collectives"] = {k: counts[k] - before[k] for k in counts}
        # timed alone: the parent says go once its own phases have stopped
        out["ready_s"] = time.perf_counter() - t0
        (Path(out_dir) / "ready").write_text("")
        deadline = time.perf_counter() + DP_WAIT_S
        while not (Path(out_dir) / "go").exists():
            check(time.perf_counter() < deadline, "the dp child was never told to go")
            time.sleep(0.05)
        for name in ("batch_mask", "batch_mask_sharded"):
            out[name]["masked_ms"] = masked_replay_ms(torch, trainers[name])
        ds = trainers["batch_mask_sharded"].dataset
        out["batch_mask_sharded"]["exchange_bytes"] = ds.exchange_bytes(
            trainers["batch_mask"].cfg.data.batch_size)
        before = dict(counts)
        grid = M.make_mesh_2d(1, 1)
        out["tp"] = tp_step(torch, grid)
        out["tp"]["collectives"] = {k: counts[k] - before[k] for k in counts}
        out["tp_variants"] = tp_variants(torch, grid)
        out["tp_chunk"] = tp_chunk(torch, grid, counts)
        torch.save(out, Path(out_dir) / "child.pt")
    finally:
        MH.shutdown()
    return 0


def dp_start(tmp: Path, rdv):
    """Start the dp phase's child (rank 0 of the launcher's environment of
    ``rdv``, a ``parallel.multihost.Rendezvous`` of one rank that the caller
    holds until the child has ended) in the background, its output to files
    in ``tmp``; returns it and its start time."""
    import os

    dp_config(tmp)
    env = dict(os.environ, **rdv.env(0))
    with open(tmp / "child.out", "w") as out, open(tmp / "child.err", "w") as err:
        proc = subprocess.Popen([sys.executable, str(HERE / "chip_smoke.py"), DP_CHILD,
                                 str(tmp)], env=env, stdout=out, stderr=err)
    return proc, time.perf_counter()


DP_WAIT_S = 600  # the longest either side of the dp phase waits for the other


def dp_failure(tmp: Path, rc) -> str:
    return (f"the dp child failed ({rc}): {(tmp / 'child.out').read_text()[-1500:]} "
            f"{(tmp / 'child.err').read_text()[-3000:]}")


def dp_wait_ready(child_proc, tmp: Path) -> None:
    """Wait until the dp child has trained both runs and waits for its go,
    so that it is idle while the next phases time the card."""
    proc, _ = child_proc
    deadline = time.perf_counter() + DP_WAIT_S
    while not (tmp / "ready").exists():
        rc = proc.poll()
        check(rc is None, dp_failure(tmp, rc))
        check(time.perf_counter() < deadline, "the dp child was not ready in time")
        time.sleep(0.05)


def same_snapshot(torch, np, got: dict, want: dict, what: str) -> None:
    """Two ``run_snapshot``s bit for bit: state tensors, console text, loss
    series, epoch results, per-sample history, masks, grids, last metrics;
    ``got`` replayed a chunk."""
    diffs = [k for k, v in want.items() if isinstance(v, torch.Tensor)
             and not torch.equal(got[k], v)]
    check(not diffs, f"{what}: {len(diffs)} tensors differ, first {diffs[:4]}")
    for k in ("text", "G", "D", "results"):
        check(got[k] == want[k] and (k != "text" or want[k]), f"{what}: {k} differs")
    for k in ("history", "masks", "grids"):
        check(len(got[k]) == len(want[k]) and all(
            np.array_equal(a, b) for a, b in zip(got[k], want[k])), f"{what}: {k} differ")
    check(all(torch.equal(a[k], b[k]) for a, b in zip(got["last"], want["last"]) for k in a),
          f"{what}: an epoch's last metrics differ")
    check(got["graphs"]["replays"] > 0, f"{what}: no chunk replayed")


def dp_phase(torch, np, child_proc, tmp: Path, zl, zl_text: str, bm_run):
    """The rank path under an NCCL group of one rank (``dp_start``'s child,
    which trained beside the loss-space to zscore_loss phases and then
    waited) against the same runs with no group, bit for bit: ``zl`` and
    ``zl_text`` are the zscore_loss phase's Trainer and output, ``bm_run``
    the chunked phase's ``batch_mask`` snapshot and Trainer.  The child
    times its replayed masked step on its go, alone on the card."""
    proc, t0 = child_proc
    snapshot, bm = bm_run
    plain = {"batch_mask": snapshot, "zscore_loss": run_snapshot(torch, zl, zl_text, {})}
    torch.cuda.synchronize()
    (tmp / "go").write_text("")
    try:
        rc = proc.wait(timeout=DP_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    child_s = time.perf_counter() - t0
    check(rc == 0, dp_failure(tmp, rc))
    child = torch.load(tmp / "child.pt", weights_only=False)
    plain_ms = masked_replay_ms(torch, bm)  # the child has ended: the card is this one's
    for name, want in plain.items():
        same_snapshot(torch, np, child[name], want, f"dp {name}")
    # the sample-sharded run against the child's replicated one
    bms = child["batch_mask_sharded"]
    same_snapshot(torch, np, bms, child["batch_mask"], "dp batch_mask sharded")
    check(bms["graphs"]["deferred_epochs"] == 0 and bms["graphs"]["blocking_epochs"] > 0,
          f"dp batch_mask sharded: {bms['graphs']['deferred_epochs']} deferred epochs")
    check(bms["collectives"]["reduce_scatter_tensor"] > 0, "dp batch_mask sharded: no exchange")
    fd = child["zscore_loss"]["graphs"]
    check(fd["deferred_epochs"] == 1 and fd["conditional_nodes"] > 0,
          f"dp zscore_loss: {fd['deferred_epochs']} epochs deferred, "
          f"{fd['conditional_nodes']} conditional nodes")
    gz = child["zscore_loss"]["launches"]
    check(gz["bce_scores"] >= 1 and gz["zscore_column_stats"] >= 1
          and gz["zscore_row_max"] >= 1, f"dp zscore_loss launches {gz}")
    bmc = child["batch_mask"]
    phase("dp", f"child (RANK=0 WORLD_SIZE=1, NCCL; {child['ready_s']:.1f} s to the end of its runs "
          f"beside phases 5-9, {child_s:.1f} s in all): batch_mask gated from "
          f"epoch 1 for {BM_EPOCHS} epochs ({sum(r['steps'] for r in bmc['results'])} steps, "
          f"{bmc['graphs']['replays']} chunks replayed) and zscore_loss epochs 0-3 "
          f"({child['zscore_loss']['graphs']['replays']} replayed) on the rank path: bit-equal "
          f"to the same runs with no group (parameters, BatchNorm buffers, Adam state, losses, "
          f"per-sample history, masks, last metrics, grids, console text); collectives issued "
          f"or recorded: batch_mask {json.dumps(bmc['collectives'])}, both runs "
          f"{json.dumps(child['zscore_loss']['collectives'])}; zscore_loss launches on the "
          f"rank path: K1 {gz['bce_scores']}, K2a {gz['zscore_column_stats']}, K2b "
          f"{gz['zscore_row_max']}")
    phase("dp", f"zscore_loss's deferred epoch 3 on the rank path ({fd['gated_replays']} gated "
          f"launches, {fd['conditional_nodes']} conditional nodes around the NCCL "
          f"collectives): bit-equal to the zscore_loss phase's deferred run with no group")
    phase("dp", f"the replayed masked step, batch 128, synchronised ({CARD}): "
          f"{bmc['masked_ms']:.3f} ms with the NCCL collectives (world size 1), "
          f"{plain_ms:.3f} ms without a group")
    st = child["strain_sharded"]
    gs = st["launches"]
    check(gs["bce_scores"] >= 1 and gs["zscore_column_stats"] >= 1
          and gs["zscore_row_max"] >= 1, f"dp sharded strain launches {gs}")
    phase("dp", f"sample-sharded staging (DeviceDataset.from_rank_local, every row the one "
          f"rank's shard): batch_mask again from its configuration, bit-equal to the child's "
          f"replicated run (its strain event blocking, {bms['graphs']['replays']} chunks "
          f"replayed), collectives issued or recorded {json.dumps(bms['collectives'])}; "
          f"zscore_loss's prefilter and {st['path']} loss strain made again with its trained D "
          f"on such a copy of its {st['n']} images, bit-equal to the same on its own dataset "
          f"(base {st['base']}, kept {st['kept']}; scores, threshold), collectives "
          f"{json.dumps(st['collectives'])}, launches on the sharded path: K1 "
          f"{gs['bce_scores']}, K2a {gs['zscore_column_stats']}, K2b {gs['zscore_row_max']}")
    phase("dp", f"the replayed masked step, batch 128, synchronised ({CARD}): "
          f"{bms['masked_ms']:.3f} ms on the sharded dataset (its lanes through a "
          f"reduce-scatter of {bms['exchange_bytes']:,} bytes a step), {bmc['masked_ms']:.3f} ms "
          f"replicated, both under the child's NCCL group")
    tp, plain_tp = child["tp"], tp_step(torch)
    for part in ("metrics", "state"):
        diffs = [k for k, v in plain_tp[part].items() if not torch.equal(tp[part][k], v)]
        check(not diffs, f"dp tp: {len(diffs)} {part} tensors differ from the step with no "
              f"group, first {diffs[:4]}")
    phase("dp", f"basic at full width (batch 128, bf16) on a 1 x 1 dp x tp grid through "
          f"put_state_tp: one step bit-equal to the step with no group ({len(tp['state'])} state "
          f"tensors, {len(tp['metrics'])} metrics); collectives {json.dumps(tp['collectives'])}; "
          f"{tp['ms']:.3f} ms a step on the grid, {plain_tp['ms']:.3f} ms with no group "
          f"(3 eager steps, synchronised, {CARD})")
    plain_v = tp_variants(torch)
    parts = []
    for preset, _ in TP_VARIANTS:
        got, want = child["tp_variants"][preset], plain_v[preset]
        diffs = [k for k, v in want["state"].items() if got["state"][k] != v]
        diffs += [k for k, v in want["metrics"].items() if not torch.equal(got["metrics"][k], v)]
        check(not diffs, f"dp tp {preset}: {len(diffs)} tensors differ from the step with no "
              f"group, first {diffs[:4]}")
        keep = want["metrics"]["keep_mask"]
        if preset in ("batch_mask", "in_batch_recycle"):
            check(0 < int(keep.sum()) < keep.numel(), f"dp tp {preset}: kept {int(keep.sum())}")
        parts.append(f"{preset} ({len(want['state'])} state tensors, kept "
                     f"{int(keep.sum())}/{keep.numel()})")
    phase("dp", "one step each at full width as shipped (bf16) on the 1 x 1 grid, bit-equal to "
          "the same seeded step with no group (metrics, parameters, BatchNorm buffers, Adam "
          "state): " + ", ".join(parts) + "; the in-step keeps on, the pool step's gate on with "
          f"{TP_POOL_ROWS} seeded pool rows, mnist_full's keep masks seeded")
    tc = child["tp_chunk"]
    check(not tc["diffs"], f"dp tp chunk: {len(tc['diffs'])} of {tc['tensors']} tensors differ "
          f"between the replayed chunk and the eager steps, first {tc['diffs'][:4]}")
    recorded = sum(tc["recorded"].values())
    check(recorded > 0, "dp tp chunk: the capture recorded no collective")
    phase("dp", f"batch_mask at full width (batch 128, bf16, keep on) on the 1 x 1 grid: one "
          f"chunk of {tc['chunk']} steps captured ({tc['capture_s']:.2f} s to record and "
          f"instantiate) and replayed, bit-equal to {tc['chunk']} eager steps on the grid "
          f"({tc['tensors']} tensors: metrics, parameters, buffers, Adam state; kept "
          f"{min(tc['kept'])}-{max(tc['kept'])} of 128); collectives recorded by the capture "
          f"{json.dumps(tc['recorded'])} ({recorded / tc['chunk']:.1f} a step)")
    phase("dp", f"the masked step, ms/step synchronised ({CARD}): {tc['replayed_ms']:.3f} replayed "
          f"on the 1 x 1 grid, {tc['eager_ms']:.3f} eager on the grid, {plain_ms:.3f} replayed "
          f"with no group (the chunked phase's executor), {bmc['masked_ms']:.3f} replayed on the "
          f"rank path (world size 1, no grid)")


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import strainer_gan_tpu_torch as port

    check(Path(port.__file__).resolve().parent.parent == HERE,
          "strainer_gan_tpu_torch must come from this checkout")
    from strainer_gan_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    built = _build.build_seconds
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    global CARD
    CARD = smi[0] if smi else "unknown"
    phase("build", f"{len(_build.SOURCES)} sources with nvcc for sm_90a: "
          f"{'cached library' if built is None else f'{built:.1f} s'} "
          f"(load {time.perf_counter() - t0:.1f} s); card: {smi[0] if smi else 'unknown'}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())

    laps = [("build", time.perf_counter())]

    def lap(name: str) -> None:  # the host seconds since the previous lap
        laps.append((name, time.perf_counter()))

    host_staging_phase(np)
    lap("host_staging")
    results = kernel_phase(torch, port)
    lap("kernels")
    adam_phase(torch, np)
    lap("adam")
    jax_fixture_phase(torch, np)
    loss_fixture_phase(torch, np)
    lap("fixtures")
    k3 = k3_phase(torch)
    lap("k3")
    with tempfile.TemporaryDirectory() as tmp:
        tr, launches, console = slice_phase(torch, np, Path(tmp))
        lap("slice")
        band_phase(torch, np, tr, Path(tmp))
        lap("band")
        chunked_final(torch, np, tr, console, Path(tmp) / "ckpt")
        lap("chunked final")
        serve_phase(torch, np, Path(tmp) / "ckpt")
        lap("serve")
        deferred_phase(torch, np, tr)
        lap("deferred")
    del tr
    for r in results:
        r["launches"] = launches[r["name"]]
    from strainer_gan_tpu_torch.parallel.multihost import Rendezvous

    with tempfile.TemporaryDirectory() as tmp, Rendezvous(1) as rdv:
        # the dp child trains beside the next phases, then waits for its go
        child = dp_start(Path(tmp), rdv)
        try:
            dbscan_launches, staged = zscore_dbscan_phase(torch, np)
            k3["launches"] = dbscan_launches["neighbor_counts"]
            results.append(k3)
            lap("zscore_dbscan")
            loss_space_phases(torch, np, staged)
            del staged
            lap("loss space")
            zscore_short_phases(torch, np)
            lap("zscore_elbow, zscore")
            basic_phase(torch, np)
            lap("basic")
            zl, zl_text = zscore_loss_phase(torch, np, Path(tmp))
            lap("zscore_loss")
            dp_wait_ready(child, Path(tmp))
            lap("waiting for the dp child")
            bm = batch_mask_phase(torch, np)
            lap("batch_mask")
            bm_run = chunked_batch_mask(torch, np, bm)
            del bm
            lap("chunked batch_mask")
            dp_phase(torch, np, child, Path(tmp), zl, zl_text, bm_run)
            lap("dp")
        finally:
            if child[0].poll() is None:
                child[0].kill()
                child[0].wait()
    del zl, bm_run
    in_batch_recycle_phase(torch, np)
    lap("in_batch_recycle")
    with tempfile.TemporaryDirectory() as tmp:
        fake_pool_phase(torch, np, Path(tmp))
    lap("fake_pool")
    with tempfile.TemporaryDirectory() as tmp:
        mnist8_phase(torch, np, Path(tmp))
    lap("mnist8")
    with tempfile.TemporaryDirectory() as tmp:
        mnist_full_phase(torch, np, Path(tmp))
    lap("mnist_full")
    fid_phase(torch, np)
    lap("fid")
    with tempfile.TemporaryDirectory() as tmp:
        eval_phase(torch, np, Path(tmp))
    lap("eval")
    phase("staging", "host seconds a mixture, native: " + ", ".join(
        f"{name} {s:.2f} ({n})" for name, n, s in STAGING)
        + f"; {sum(s for _, _, s in STAGING):.2f} s in all")
    phase("times", "host seconds by phases: " + ", ".join(
        f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in zip(laps, laps[1:])))
    phase("total", f"{time.perf_counter() - t_start:.1f} s from start to here")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(smi[0] if smi else "unknown")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [DP_CHILD]:
        sys.exit(dp_child(sys.argv[2]))
    sys.exit(main())
