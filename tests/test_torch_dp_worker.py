"""One rank of the port's data-parallel checks (tests/test_torch_dp.py).

``run_rank`` joins the gloo group of its launcher's environment, loads the
inputs the test wrote (``inputs.pt``: G/D weights, a uint8 batch, its
source ids, the global noise), runs the cases below and saves what each
rank computed to ``out_<tag>_<rank>.pt``:

* ``full``: one ``basic`` step on the whole batch;
* ``mask``: one ``batch_mask`` step with the in-step keep on;
* ``tail``: the same on a partial tail of ``TAIL`` valid lanes, which
  leaves every lane of rank 1 (of 2) padding;
* ``score``: the eval-mode D-loss pass over a small dataset;
* ``divisible``: the Trainer's error for a batch the ranks cannot share;
* ``deferred``: a tiny ``final`` Trainer for three strain epochs (a
  shrinking count, then a growing one, each with a partial tail), with
  ``defer_epoch_stats`` on and off (``deferred_snapshot``).

``run_cli_rank`` runs the command line as one rank of a launcher's group
(tests/test_torch_dp_cli.py); ``card_rank_runs`` trains a narrow
``batch_mask`` on the card under an NCCL group of one rank, replayed and
eager (tests/test_torch_cuda.py).  It imports no JAX, so a spawned rank
starts quickly, and it holds no test of its own.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

WIDTH, B, TAIL = 8, 16, 5
TIMEOUT_S = 60


def tiny(cfg, batch_size=B):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=batch_size),
        model=dataclasses.replace(cfg.model, ngf=WIDTH, ndf=WIDTH, compute_dtype="float32"))


def modules(cfg, weights):
    from strainer_gan_tpu_torch.models import Discriminator64, Generator64
    from strainer_gan_tpu_torch.train.state import make_optimizers

    gen, disc = Generator64(100, WIDTH), Discriminator64(WIDTH)
    gen.load_state_dict(weights["gen"])
    disc.load_state_dict(weights["disc"])
    return gen, disc, *make_optimizers(cfg, gen, disc)


def state_of(gen, disc, opt_g, opt_d):
    out = {f"G.{k}": v.clone() for k, v in gen.state_dict().items()}
    out.update({f"D.{k}": v.clone() for k, v in disc.state_dict().items()})
    for name, module, opt in (("G", gen, opt_g), ("D", disc, opt_d)):
        for pname, p in module.named_parameters():
            st = opt.state[p]
            out[f"{name}.mu.{pname}"] = st["exp_avg"].clone()
            out[f"{name}.nu.{pname}"] = st["exp_avg_sq"].clone()
    return out


def run_cases(inputs):
    from strainer_gan_tpu_torch import get_preset
    from strainer_gan_tpu_torch.data import DeviceDataset, Mixture, normalize_u8
    from strainer_gan_tpu_torch.strain.score import score_d_losses
    from strainer_gan_tpu_torch.train.loop import Trainer
    from strainer_gan_tpu_torch.train.steps import rank_inputs, step_config_from, train_step

    out = {}
    batch, src, z = inputs["batch"], inputs["src"], inputs["z"]
    ids = torch.arange(B)
    for case, preset, mask_on, lane_count in (("full", "basic", False, None),
                                              ("mask", "batch_mask", True, None),
                                              ("tail", "batch_mask", True, TAIL)):
        cfg = tiny(get_preset(preset))
        scfg = step_config_from(cfg)
        gen, disc, opt_g, opt_d = modules(cfg, inputs)
        rid, rz, _, _ = rank_inputs(scfg, ids, z)
        m = train_step(gen, disc, opt_g, opt_d, normalize_u8(batch[rid]), src[rid], rz,
                       inputs["lr"], inputs["lr"], scfg, lane_count=lane_count,
                       mask_on=mask_on)
        out[case] = dict(metrics={k: v.detach().clone() for k, v in m.items()},
                         state=state_of(gen, disc, opt_g, opt_d))
    cfg = tiny(get_preset("basic"))
    _, disc, _, _ = modules(cfg, inputs)
    mix = Mixture(inputs["score_images"], np.zeros(len(inputs["score_images"]), np.int32),
                  np.zeros(len(inputs["score_images"]), np.int32))
    out["score"] = score_d_losses(disc, DeviceDataset(mix, "cpu"), batch_size=8)
    try:
        Trainer(tiny(get_preset("basic"), batch_size=B - 1), device="cpu",
                dataset=DeviceDataset(mix, "cpu"))
        out["divisible"] = ""
    except ValueError as e:
        out["divisible"] = str(e)
    out["deferred"] = {defer: deferred_snapshot(defer) for defer in (True, False)}
    return out


def deferred_cfg(defer: bool):
    """``final`` at batch 8, its strain from epoch 0 keeping about 50 %,
    10 % and 50 % of the samples (its ratio inversion), chunks of 4."""
    from strainer_gan_tpu_torch import get_preset

    cfg = tiny(get_preset("final"), batch_size=8)
    return cfg.replace(
        train=dataclasses.replace(cfg.train, epochs=3, log_every=2, sample_every=0,
                                  steps_per_dispatch=4, defer_epoch_stats=defer),
        strain=dataclasses.replace(cfg.strain, start_epoch=0, prefilter=False,
                                   score_precision="f32", score_batch=32,
                                   clean_ratio_schedule=((0, 0.5), (1, 0.9), (2, 0.5))))


def deferred_snapshot(defer: bool) -> dict:
    """Run ``deferred_cfg(defer)`` on 100 seeded images on the CPU and
    return what a bit-for-bit comparison reads."""
    import io

    from strainer_gan_tpu_torch.data import DeviceDataset, Mixture
    from strainer_gan_tpu_torch.obs.metrics import MetricsLogger
    from strainer_gan_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(11)
    n = 100
    mix = Mixture(rng.integers(0, 256, (n, 64, 64, 3)).astype(np.uint8),
                  (rng.random(n) < 0.2).astype(np.int32), np.zeros(n, np.int64))
    tr = Trainer(deferred_cfg(defer), device="cpu", dataset=DeviceDataset(mix, "cpu"),
                 logger=MetricsLogger(log_every=2, stream=io.StringIO()))
    tr.run()
    out = dict(text=tr.logger.stream.getvalue(), G=tr.logger.G_losses, masks=tr.mask_history,
               history=tr.epoch_loss_history,
               results=[(r["steps"], r["active"]) for r in tr.epoch_results],
               paths=(tr.graph_stats["deferred_epochs"], tr.graph_stats["blocking_epochs"]))
    for name in ("gen", "disc"):
        out.update({f"{name}.{k}": v.clone() for k, v in getattr(tr, name).state_dict().items()})
    for name in ("opt_g", "opt_d"):
        st = getattr(tr, name).state_dict()["state"]
        out.update({f"{name}.{i}.{k}": torch.as_tensor(v).clone()
                    for i, s in st.items() for k, v in s.items()})
    return out


def run_rank(rank: int, tmp: str, tag: str) -> None:
    """Under a launcher's environment (tests/test_torch_ranks.py): the gloo
    group, then ``run_cases``."""
    from strainer_gan_tpu_torch.parallel import multihost as MH

    torch.set_num_threads(1)
    assert MH.initialize("cpu", timeout_s=TIMEOUT_S)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        torch.save(run_cases(inputs), os.path.join(tmp, f"out_{tag}_{rank}.pt"))
    finally:
        MH.shutdown()


def run_cli_rank(rank: int, tmp: str, argv) -> None:
    """``cli.run(argv)`` as one rank of a launcher's group (the environment
    tests/test_torch_ranks.py gives it); saves what the rank's Trainer holds
    to ``cli_<rank>.pt``."""
    from strainer_gan_tpu_torch import cli
    from strainer_gan_tpu_torch.parallel.multihost import shutdown

    torch.set_num_threads(1)
    try:
        tr, results = cli.run(argv)
        eng = tr.engine
        torch.save(dict(results=results, masks=tr.mask_history,
                        keep=[r["last"] and r["last"]["keep_mask"] for r in tr.epoch_results],
                        losses=tr.epoch_loss_history, errD=tr.logger.D_losses,
                        params={k: v.clone() for k, v in tr.disc.state_dict().items()},
                        scores=eng.last_scores,
                        ae=None if eng.ae is None else eng.ae.state_dict()),
                   os.path.join(tmp, f"cli_{rank}.pt"))
    finally:
        shutdown()


def card_cfg(spd: int):
    """A narrow ``batch_mask`` gated from epoch 1, batch 32, bf16 as
    shipped, at ``steps_per_dispatch`` ``spd`` (tests/test_torch_cuda.py's
    executor configuration)."""
    from strainer_gan_tpu_torch import get_preset

    cfg = get_preset("batch_mask")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=32),
        model=dataclasses.replace(cfg.model, ngf=16, ndf=16),
        strain=dataclasses.replace(cfg.strain, mask_start_epoch=1),
        train=dataclasses.replace(cfg.train, epochs=2, log_every=5, steps_per_dispatch=spd))


def card_snapshot(spd: int) -> dict:
    """Train ``card_cfg(spd)`` for 2 epochs on the card (320 synthetic
    images a source) and return what a bit-for-bit comparison reads."""
    import io

    from strainer_gan_tpu_torch.train.loop import Trainer

    tr = Trainer(card_cfg(spd), max_synth=320)
    tr.logger.stream = io.StringIO()
    tr.setup()
    for e in range(2):
        tr.run_epoch(e)
    out = dict(text=tr.logger.stream.getvalue(), G=tr.logger.G_losses, D=tr.logger.D_losses,
               history=tr.epoch_loss_history, masks=tr.mask_history,
               contam=[r["filtered_contam"] for r in tr.epoch_results],
               graphs={k: tr.graph_stats[k] for k in ("captures", "replays")})
    for name in ("gen", "disc"):
        out.update({f"{name}.{k}": v.cpu() for k, v in getattr(tr, name).state_dict().items()})
    for name in ("opt_g", "opt_d"):
        st = getattr(tr, name).state_dict()["state"]
        out.update({f"{name}.{i}.{k}": torch.as_tensor(v).cpu()
                    for i, s in st.items() for k, v in s.items()})
    return out


def card_rank_runs(path: str) -> None:
    """Under a launcher's environment of one rank: the NCCL group on the
    card, then ``card_snapshot`` at steps_per_dispatch 4 (replayed) and 1
    (eager), saved to ``path``."""
    from strainer_gan_tpu_torch.parallel import multihost as MH

    assert MH.initialize()
    try:
        out = dict(backend=dist.get_backend(), world=MH.world())
        for spd in (4, 1):
            out[spd] = card_snapshot(spd)
        torch.save(out, path)
    finally:
        MH.shutdown()
