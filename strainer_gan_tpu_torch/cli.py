"""Command line: run a preset (or a config JSON) end to end (counterpart of
`strainer_gan_tpu/cli.py`).

    python -m strainer_gan_tpu_torch.cli --preset final --epochs 4 --out runs/x
    python -m strainer_gan_tpu_torch.cli --preset basic --device cpu --max-synth 64
    python -m strainer_gan_tpu_torch.cli --preset strainer_gan --eval --out runs/y
    python -m strainer_gan_tpu_torch.cli --preset batch_mask --dp 2 --device cpu
    python -m strainer_gan_tpu_torch.cli --list

The JAX CLI's flags, outputs (``metrics.json``, ``samples.png``,
``samples_epochN.png``, ``ckpt/``, the plots) and printed JSON, plus
``--device`` (the card by default).  ``run(argv)`` is the body, returning
the Trainer and the results; ``main`` wraps it.

``--eval`` runs the eval suite after training (``eval/suite.py``; a
preset with no metric on gets all of them, ``force_eval_suite``) on
``--eval-samples`` samples and puts its values under ``"eval"``.

``--dp N`` trains on N ranks (``parallel/``), one global step over them.
Under a launcher (``torchrun``'s ``RANK``/``WORLD_SIZE``, or the JAX
names ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``) N must be
its world size; without one the CLI spawns N local ranks: cards
``0..N-1`` with NCCL, or N gloo processes with ``--device cpu``.  ``-1``
means every visible card (the CPU's cores with ``--device cpu``); one
rank without a launcher is no group, as the JAX package's ``dp=1`` is no
mesh.  More ranks than visible cards (or cores) is refused.  Only rank 0
prints, writes the checkpoints, PNGs and ``metrics.json``, and runs the
eval suite; every rank restores.  A launcher's group over more than one
host (``torchrun --nnodes H``, which sets ``LOCAL_WORLD_SIZE``) stages
each rank's sample shard only; every rank then gathers the eval suite's
rows before rank 0 computes it.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import sys
import time
from typing import Optional, Tuple


class UsageError(Exception):
    """A request the CLI refuses (exit code 2)."""


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="strainer_gan_tpu_torch runner")
    ap.add_argument("--preset", default="basic")
    ap.add_argument("--config", help="path to a config JSON (overrides --preset)")
    ap.add_argument("--list", action="store_true", help="list presets and exit")
    ap.add_argument("--epochs", type=int, help="override epoch count")
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--max-synth", type=int, default=None,
                    help="cap synthetic dataset size (smoke runs)")
    ap.add_argument("--out", default=None, help="output dir (samples, ckpts, metrics)")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--save-samples-every", type=int, default=0,
                    help="save a sample grid PNG every N epochs "
                         "(the reference's GAN_results/ PNGs)")
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    ap.add_argument("--eval", action="store_true", help="run the eval suite at the end")
    ap.add_argument("--parity-check", action="store_true",
                    help="report filter-mask agreement vs the numpy oracle")
    ap.add_argument("--f32", action="store_true",
                    help="parity mode: full float32 compute")
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel ranks (-1 = all visible cards)")
    ap.add_argument("--eval-samples", type=int, default=500)
    ap.add_argument("--describe", action="store_true",
                    help="print the model/memory breakdown and exit")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def force_eval_suite(cfg, n_samples: int):
    """``--eval`` on a config whose ``EvalConfig`` has every metric off: all
    of them on, at ``n_samples`` (`strainer_gan_tpu/cli.py:20-38`); a
    config with any metric on is kept as its reference script defines it."""
    ev = cfg.eval
    if ev.fid or ev.feature_distance or ev.wasserstein:
        return cfg
    return cfg.replace(eval=dataclasses.replace(
        ev, fid=True, feature_distance=True, wasserstein=True, fid_n_samples=n_samples))


def load_config(args):
    from .config import ExperimentConfig, get_preset

    if args.config:
        if not os.path.exists(args.config):
            raise UsageError(f"config file not found: {args.config}")
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        try:
            cfg = get_preset(args.preset)
        except KeyError as e:
            raise UsageError(e.args[0]) from None
    if args.epochs is not None:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=args.epochs))
    if args.batch_size is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=args.batch_size))
    if args.f32:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    if args.dp is not None:
        cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel, dp=args.dp))
    if args.eval:
        cfg = force_eval_suite(cfg, args.eval_samples)
    return cfg


def ranks_asked(args) -> int:
    """The rank count ``--dp`` asks for, checked against what is visible."""
    import torch

    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    visible = (os.cpu_count() or 1) if cpu else torch.cuda.device_count()
    what = "CPU cores" if cpu else "visible cards"
    if args.dp == 0 or args.dp < -1:
        raise UsageError(f"--dp {args.dp}: give a rank count, or -1 for all {what}")
    n = visible if args.dp == -1 else args.dp
    if n > visible or n < 1:
        raise UsageError(f"--dp {args.dp}: more ranks than the {visible} {what}")
    return n


def _rank_entry(rank: int, argv, envs, result_path: str, threads: int) -> None:
    """A spawned rank: its launcher's environment (``envs[rank]``), then the
    run; rank 0 leaves the results in ``result_path``."""
    import torch

    os.environ.update(envs[rank])
    torch.set_num_threads(threads)
    from .parallel.multihost import shutdown

    try:
        _, results = run(argv)
    finally:
        shutdown()
    if rank == 0:
        with open(result_path, "w") as f:
            json.dump(results, f)


def spawn(argv, world: int) -> dict:
    """Run ``argv`` on ``world`` local ranks; returns rank 0's results."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from .parallel.multihost import Rendezvous

    threads = max(1, torch.get_num_threads() // world)  # the ranks share this process's cores
    with tempfile.TemporaryDirectory() as tmp, Rendezvous(world) as rdv:
        path = os.path.join(tmp, "results.json")
        envs = [rdv.env(r) for r in range(world)]
        mp.spawn(_rank_entry, args=(list(argv), envs, path, threads), nprocs=world, join=True)
        with open(path) as f:
            return json.load(f)


def image_rows(imgs, cfg):
    """The MLP's (N, H*W*C) sample rows as (N, H, W, C) images; images as
    they are."""
    if imgs.ndim == 2:
        s = cfg.data.image_size
        imgs = imgs.reshape(-1, s, s, cfg.model.nc)
    return imgs


def run(argv=None, stdout=None) -> Tuple[Optional[object], dict]:
    """Parse ``argv`` and run; returns ``(trainer, results)`` (``trainer`` is
    None after ``--list``).  Raises ``UsageError`` for a refused request."""
    out = stdout or sys.stdout
    args = parser().parse_args(argv)
    from .config import PRESETS

    if args.list:
        for name, cfg in sorted(PRESETS.items()):
            print(f"{name:24s} arch={cfg.model.arch:8s} strain={cfg.strain.method}", file=out)
        return None, {}
    cfg = load_config(args)
    if args.eval:
        from .eval.suite import check_config

        try:
            check_config(cfg)  # before training, not after it
        except ValueError as e:
            raise UsageError(f"--eval: {e}") from None
    from .parallel import multihost as MH

    if args.dp is not None:
        n = ranks_asked(args)
        if MH.launched():
            MH.initialize(args.device)
            if MH.world() != n:
                raise UsageError(f"--dp {args.dp} under a launcher of {MH.world()} ranks")
        elif n > 1:
            return None, spawn(argv if argv is not None else sys.argv[1:], n)
    elif MH.launched():
        MH.initialize(args.device)
    if not MH.is_primary():
        out = io.StringIO()  # only rank 0 prints

    from .obs.images import save_image_grid
    from .train.loop import Trainer
    from .utils.trees import dtype_summary, param_count, tree_bytes

    t0 = time.time()
    trainer = Trainer(cfg, device=args.device, max_synth=args.max_synth)
    print(f"[strainer] {cfg.name}: dataset n={trainer.dataset.n}, "
          f"params={param_count(trainer.gen, trainer.disc):,}", file=out, flush=True)
    if args.describe:
        for name, m in (("G", trainer.gen), ("D", trainer.disc)):
            print(f"[strainer] {name}: params={param_count(m):,} bytes={tree_bytes(m):,} "
                  f"dtypes={dtype_summary(m)}", file=out)
        ds = trainer.dataset
        img = ds.images
        shard = (f"; rank {MH.rank()}'s shard, rows {ds.lo}..{ds.lo + img.shape[0]} of {ds.n}"
                 if ds.sharded else "")
        print(f"[strainer] dataset on {img.device}: {img.numel() * img.element_size():,} "
              f"bytes ({tuple(img.shape)} {img.dtype}{shard})", file=out)
        return trainer, {}

    trainer.setup()
    start_epoch = 0
    if args.resume:
        from .checkpoint import restore_checkpoint

        start_epoch = restore_checkpoint(args.resume, trainer)
        print(f"[strainer] resumed from epoch {start_epoch - 1}", file=out)

    epochs = 0
    for epoch in range(start_epoch, cfg.train.epochs):
        trainer.run_epoch(epoch)
        epochs += 1
        if args.out and args.checkpoint_every and (epoch + 1) % args.checkpoint_every == 0:
            from .checkpoint import save_checkpoint

            save_checkpoint(os.path.join(args.out, "ckpt"), trainer, epoch)
        if args.out and args.save_samples_every and (epoch + 1) % args.save_samples_every == 0:
            # per-epoch sample PNGs (`#8.py:144-147`)
            save_image_grid(image_rows(trainer.sample(25), cfg),
                            os.path.join(args.out, f"samples_epoch{epoch + 1}.png"), nrow=5)

    results = dict(name=cfg.name, wall_s=round(time.time() - t0, 2), epochs=epochs,
                   summary=trainer.logger.summary())
    if args.parity_check:
        from .parity.agreement import agreement_report

        results["parity"] = agreement_report(trainer, epoch=cfg.train.epochs - 1)
    if args.eval:
        from .eval.suite import eval_rows

        # every rank: the rows of a sharded dataset come in through a collective
        eval_ds = eval_rows(trainer.dataset, args.eval_samples)
    if not MH.is_primary():  # rank 0 evaluates and writes
        return trainer, results
    if args.eval:
        from .eval.suite import evaluate_run

        results["eval"] = evaluate_run(cfg, trainer.gen, eval_ds, n_samples=args.eval_samples)
    if args.out:
        import numpy as np

        from .obs.plots import save_loss_curves, save_score_histogram

        os.makedirs(args.out, exist_ok=True)
        g_losses = trainer.logger.G_losses
        if g_losses:
            save_loss_curves(g_losses, trainer.logger.D_losses,
                             os.path.join(args.out, "losses.png"))
        eng = trainer.engine
        if eng.last_scores is not None:
            save_score_histogram(
                np.asarray(eng.last_scores.cpu()),
                None if eng.last_threshold is None else float(eng.last_threshold),
                os.path.join(args.out, "strain_scores.png"))
        save_image_grid(image_rows(trainer.sample(64), cfg),
                        os.path.join(args.out, "samples.png"))
        with open(os.path.join(args.out, "metrics.json"), "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results), file=out)
    return trainer, results


def main(argv=None) -> int:
    try:
        run(argv)
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
