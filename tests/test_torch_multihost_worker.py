"""One rank of the port's multi-host staging checks (tests/test_torch_multihost.py).

``run_rank`` gets a launcher's environment in which every rank is a host
of its own (``LOCAL_WORLD_SIZE=1``), joins the gloo group, loads the
inputs the test wrote (``inputs.pt``) and saves what it computed to
``out_<rank>.pt``:

* ``steps``: a ``basic`` step and a ``batch_mask`` step with the in-step
  keep on, each twice: as tests/test_torch_dp_worker.py's replicated rank
  runs it (the rank's lanes of the whole batch), and on a dataset staged by
  ``DeviceDataset.from_rank_local`` in which the batch's rows are shuffled,
  so that each rank's lanes come from both shards through the exchange;
* ``trainers``: tiny ``final`` (prefilter and loss strain, the JAX draws
  and initial state injected), ``autoencoder`` and ``strainer_concat_fast``
  trained on a dataset the Trainer stages itself (sharded: the group spans
  two hosts) and on the replicated trimmed mixture;
* ``cli``: ``cli.run`` with ``--dp 2 --eval`` on a tiny ``final`` whose
  periodic FID fires every epoch, with ``evaluate_run`` replaced by a
  recorder (the suite's own arithmetic is tests/test_torch_eval_suite.py's):
  the shard staged, and the rows every rank gathered for rank 0.

It imports no JAX, so a spawned rank starts quickly, and holds no test of
its own.
"""
from __future__ import annotations

import dataclasses
import io
import os

import numpy as np
import torch

import test_torch_dp_worker as W

B = 8  # the global batch: 4 lanes a rank
MAX_SYNTH = 25  # 25 primary + 12 contaminant images: 37, trimmed to 36 at world 2
TIMEOUT_S = 60
PRESETS = ("final", "autoencoder", "strainer_concat_fast")


def tiny_cfg(preset: str):
    """``preset`` at width 8, batch 8, float32, 2 epochs of chunks of 2 with
    no grids; its second source half the primary's size (an odd total);
    every strain, gate and AE training at epoch 1, scored 16 at a time."""
    from strainer_gan_tpu_torch import get_preset

    cfg = W.tiny(get_preset(preset), batch_size=B)
    primary, other = cfg.data.sources
    other = dataclasses.replace(other, count=None, fraction_of_primary=0.5)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, sources=(primary, other)),
        train=dataclasses.replace(cfg.train, epochs=2, log_every=2, sample_every=0,
                                  steps_per_dispatch=2),
        strain=dataclasses.replace(cfg.strain, start_epoch=1, score_batch=16,
                                   ae_train_epoch=1, ae_train_epochs=2,
                                   fake_concat_start_epoch=1,
                                   clean_ratio_schedule=((0, 1.0), (1, 0.6))))


def step_cases(inputs) -> dict:
    """The ``basic`` and ``batch_mask`` steps, replicated and sharded."""
    from strainer_gan_tpu_torch import get_preset
    from strainer_gan_tpu_torch.data import DeviceDataset, Mixture, normalize_u8
    from strainer_gan_tpu_torch.parallel import multihost as MH
    from strainer_gan_tpu_torch.train.steps import rank_inputs, step_config_from, train_step

    batch, src, z, order = inputs["batch"], inputs["src"], inputs["z"], inputs["order"]
    n = batch.shape[0]
    lo, hi, _ = MH.shard_bounds(n, MH.rank(), MH.world())
    # the dataset holds the batch's rows in ``order``; index ``where[j]``
    # is batch row j
    shuffled = Mixture(batch[order].numpy(), src[order].numpy(), np.zeros(n, np.int64))
    ds = DeviceDataset.from_rank_local(
        Mixture(shuffled.images[lo:hi], shuffled.source_id[lo:hi], shuffled.labels[lo:hi]),
        n, "cpu")
    where = torch.argsort(order)
    out = {}
    for case, preset, mask_on in (("full", "basic", False), ("mask", "batch_mask", True)):
        cfg = W.tiny(get_preset(preset))
        scfg = step_config_from(cfg)
        for kind in ("replicated", "sharded"):
            gen, disc, opt_g, opt_d = W.modules(cfg, inputs)
            if kind == "replicated":  # tests/test_torch_dp_worker.py's run
                rid, rz, _, _ = rank_inputs(scfg, torch.arange(n), z)
                x, s = batch[rid], src[rid]
            else:
                _, rz, _, _ = rank_inputs(scfg, where, z)
                x, s = ds.batch(where)
            m = train_step(gen, disc, opt_g, opt_d, normalize_u8(x), s, rz, inputs["lr"],
                           inputs["lr"], scfg, mask_on=mask_on)
            out[(case, kind)] = dict(
                metrics={k: v.detach().clone() for k, v in m.items()},
                state=W.state_of(gen, disc, opt_g, opt_d), lanes=x.clone())
    return out


def snapshot(tr) -> dict:
    """What a bit-for-bit comparison of two runs reads."""
    out = dict(text=tr.logger.stream.getvalue(), G=tr.logger.G_losses, D=tr.logger.D_losses,
               masks=tr.mask_history, history=tr.epoch_loss_history,
               results=[(r["steps"], r["active"], r["filtered_contam"], r["total_contam"])
                        for r in tr.epoch_results],
               paths=(tr.graph_stats["deferred_epochs"], tr.graph_stats["blocking_epochs"]),
               pool=tr.fake_pool, pool_rows=tr.fake_pool_rows,
               ae=None if tr.engine.ae is None else tr.engine.ae.state_dict(),
               scores=tr.engine.last_scores, stats=tr._stats)
    for name in ("gen", "disc"):
        out.update({f"{name}.{k}": v.clone() for k, v in getattr(tr, name).state_dict().items()})
    for name in ("opt_g", "opt_d"):
        st = getattr(tr, name).state_dict()["state"]
        out.update({f"{name}.{i}.{k}": torch.as_tensor(v).clone()
                    for i, s in st.items() for k, v in s.items()})
    return out


def train(preset: str, inputs, dataset=None):
    """``tiny_cfg(preset)`` trained by a Trainer on ``dataset`` (None: the
    Trainer stages the mixture itself); for ``final`` the JAX Trainer's
    initial state, epoch permutations and noise are injected."""
    from strainer_gan_tpu_torch.data import epoch_batch_indices
    from strainer_gan_tpu_torch.obs.metrics import MetricsLogger
    from strainer_gan_tpu_torch.train.loop import Trainer

    tr = Trainer(tiny_cfg(preset), device="cpu", max_synth=MAX_SYNTH, dataset=dataset,
                 logger=MetricsLogger(log_every=2, stream=io.StringIO()))
    if preset == "final":
        tr.gen.load_state_dict(inputs["jax_gen"])
        tr.disc.load_state_dict(inputs["jax_disc"])
        perms, zs = inputs["jax_perms"], inputs["jax_z"]
        tr.epoch_indices = lambda e, active, s: epoch_batch_indices(active, s, B, perm=perms[e])
        tr.step_noise = lambda e, i: zs[e][i].clone()
    tr.run()
    return tr


def trainer_cases(inputs) -> dict:
    from strainer_gan_tpu_torch.data import DeviceDataset, build_mixture

    out = {}
    for preset in PRESETS:
        sharded = train(preset, inputs)
        ds = sharded.dataset
        full = build_mixture(tiny_cfg(preset).data, max_synth=MAX_SYNTH)
        n = ds.n
        full.images, full.source_id = full.images[:n], full.source_id[:n]
        replicated = train(preset, inputs, DeviceDataset(full, "cpu"))
        out[preset] = dict(sharded=snapshot(sharded), replicated=snapshot(replicated),
                           shard=(ds.sharded, ds.lo, ds.images.clone(), ds.source_id.clone(),
                                  n))
    return out


def cli_case(tmp: str) -> dict:
    """``cli.run`` with ``--dp 2 --eval`` on a tiny ``final`` whose periodic
    FID fires every epoch; ``evaluate_run`` records the rows it is given."""
    from strainer_gan_tpu_torch import cli
    from strainer_gan_tpu_torch.eval import suite

    cfg = tiny_cfg("final")
    cfg = cfg.replace(
        strain=dataclasses.replace(cfg.strain, prefilter=False, score_precision="f32"),
        eval=dataclasses.replace(cfg.eval, fid=True, fid_every_epochs=1, fid_n_samples=6))
    path = os.path.join(tmp, "cli_final.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    seen = []

    def record(cfg, gen, dataset, n_samples=500, **kw):
        seen.append((dataset.images.clone(), dataset.source_id.clone(), n_samples))
        return {"fid_real": 0.0}

    suite.evaluate_run = record
    tr, results = cli.run(["--config", path, "--device", "cpu", "--max-synth", str(MAX_SYNTH),
                           "--dp", "2", "--eval", "--eval-samples", "5"], stdout=io.StringIO())
    ds = tr.dataset
    return dict(seen=seen, shard=(ds.sharded, ds.lo, ds.images.clone(), ds.n),
                eval=results.get("eval"), masks=tr.mask_history)


def run_rank(rank: int, tmp: str) -> None:
    from strainer_gan_tpu_torch.parallel import multihost as MH

    torch.set_num_threads(1)
    assert MH.initialize("cpu", timeout_s=TIMEOUT_S)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = dict(hosts=MH.host_count(), steps=step_cases(inputs),
                   trainers=trainer_cases(inputs), cli=cli_case(tmp))
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        MH.shutdown()
