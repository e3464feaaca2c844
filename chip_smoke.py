"""Drive the PyTorch/H100 port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line of output or more each; any failure raises and the
script exits non-zero without printing its result line:

1. build: compile ``strainer_gan_tpu_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (seconds), and read the card's name and power limit.
2. kernels: every CUDA kernel of the port at the shapes the ``final`` path
   gives it, held against its plain PyTorch version on the same inputs,
   and timed with CUDA events beside its plain version (and, where one
   PyTorch call computes the same function, that call).
3. slice: the port's ``Trainer`` runs the ``final`` preset at full model
   width (nz=100, ngf=ndf=64, 64x64x3), batch 128, for 4 epochs: z-score
   prefilter on ResNet18 features, D-first steps, the loss-percentile
   strain at epoch 3 with its LR cut.  Launch counters are zeroed right
   before ``run()`` and read right after it.

Deviations from the preset, each for a reason: ``score_precision="f32"``
(the band_bf16 scoring path is not ported yet; it gives the same mask),
``epochs=4`` (epoch 3 is the first strain event), ``max_synth=8192`` per
source (16,384 images, 128 steps per epoch, to bound the run's time).

The second-to-last lines are one JSON object of per-kernel results and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12  # HBM3, published
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, published


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


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
    x[:8] = torch.tensor([30.0, -30.0, 120.0, -120.0, 99.5, -99.5, 87.5, -87.5])
    err = 0.0
    for t in (1.0, 0.0, 0.9):
        got, ref = KB.bce_scores(x, t), KB.bce_scores_plain(x, t)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 non-finite at t={t}")
        bad = (got - ref).abs() > 2e-6 * ref.abs().clamp_min(1.0)
        check(not bool(bad.any()), f"K1 disagrees with its plain version at t={t}: "
              f"{int(bad.sum())} lanes beyond 2e-6 * max(1, |ref|)")
        err = max(err, float((got - ref).abs().max()))
    t_k = time_ms(torch, lambda: KB.bce_scores(x, 1.0))
    t_p = time_ms(torch, lambda: KB.bce_scores_plain(x, 1.0))
    ones = torch.ones_like(x)
    t_l = time_ms(torch, lambda: F.binary_cross_entropy(torch.sigmoid(x), ones,
                                                        reduction="none"))
    b, by = bound_ms(8.0 * n, 12.0 * n)
    phase("kernels", f"K1 bce_scores N={n}: max_abs_err={err:.3g} (tol 2e-6*max(1,|ref|)) "
          f"kernel_ms={t_k:.5f} plain_ms={t_p:.5f} library_ms={t_l:.5f} bound_ms={b:.5f}")
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
            check(not bool(((z - z_p).abs() > 1e-5 * z_p.abs().clamp_min(1.0)).any()),
                  f"K2b disagrees with plain ({mode})")
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
    ba, bya = bound_ms(4.0 * n * d + 8.0 * d, 4.0 * n * d)
    bb, byb = bound_ms(4.0 * n * d + 8.0 * d + 4.0 * n, 4.0 * n * d)
    phase("kernels", f"K2a zscore_column_stats {n}x{d}: max_abs_err={err_a:.3g} "
          f"(tol 1e-5*max(1,|ref|)) kernel_ms={t_a:.5f} plain_ms={t_ap:.5f} "
          f"library_ms={t_al:.5f} (torch.std_mean) bound_ms={ba:.5f}")
    phase("kernels", f"K2b zscore_row_max {n}x{d}: max_abs_err={err_b:.3g} "
          f"kernel_ms={t_b:.5f} plain_ms={t_bp:.5f} bound_ms={bb:.5f}; "
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


def slice_phase(torch, np):
    from strainer_gan_tpu_torch import get_preset, kernels
    from strainer_gan_tpu_torch.train.loop import Trainer

    cfg = get_preset("final")
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=128),
        strain=dataclasses.replace(cfg.strain, score_precision="f32"),
        train=dataclasses.replace(cfg.train, epochs=4),
    )
    t0 = time.perf_counter()
    tr = Trainer(cfg, max_synth=8192)
    torch.cuda.synchronize()
    phase("slice", f"final preset: {tr.dataset.n} images staged on the card, G/D at "
          f"nz={cfg.model.nz} ngf={cfg.model.ngf} ndf={cfg.model.ndf}, "
          f"compute {cfg.model.compute_dtype} ({time.perf_counter() - t0:.1f} s)")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = tr.run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()

    eng = tr.engine
    base = eng.base_active.cpu().numpy()
    refined = tr.mask_history[3]
    check(out[3]["lr_d"] == cfg.train.lr_d * cfg.train.lr_decay_factor, "no LR cut at epoch 3")
    check(0 < base.sum() <= tr.dataset.n, "empty prefilter mask")
    check(0 < refined.sum() < base.sum() and not refined[~base].any(),
          "strain mask empty or outside the prefilter base")
    losses = tr.logger.D_losses + tr.logger.G_losses
    check(len(losses) == 2 * sum(o["steps"] for o in out) and np.all(np.isfinite(losses)),
          "non-finite or missing losses")
    # the strain decision against numpy's percentile on the same scores
    scores = eng.last_scores.cpu().numpy()
    thr = float(eng.last_threshold)
    thr_np = float(np.percentile(scores[base].astype(np.float64), 20.0))
    check(abs(thr - thr_np) <= 1e-6 * max(1.0, abs(thr_np)), f"threshold {thr} vs numpy {thr_np}")
    check(np.array_equal(refined, base & (scores < thr)), "strain mask is not loss < threshold")
    with torch.no_grad():
        fake = tr.gen(torch.randn((4, cfg.model.nz), device="cuda"), train=False)
    check(tuple(fake.shape) == (4, 3, 64, 64) and bool(torch.isfinite(fake).all()),
          "generator output")
    for name in ("bce_scores", "zscore_column_stats", "zscore_row_max"):
        check(launches[name] > 0, f"kernel {name} never launched on the main path")

    setup_s = total - sum(o["seconds"] for o in out)
    phase("slice", f"prefilter kept {int(base.sum())}/{tr.dataset.n} "
          f"(threshold {cfg.strain.z_threshold}) in {setup_s:.2f} s")
    quality = "".join(f", removed {q['removed']} with precision {q['precision']:.4f} "
                      f"recall {q['recall']:.4f} against the contamination labels"
                      for q in tr.strain_quality)
    phase("slice", f"epoch 3 strain kept {int(refined.sum())}/{int(base.sum())}, "
          f"loss threshold {thr:.6g}{quality}")
    for e, o in enumerate(out):
        train_s = o["seconds"] - o["strain_seconds"]
        phase("slice", f"epoch {e}: strain {o['strain_seconds']:.3f} s, {o['steps']} steps "
              f"in {train_s:.3f} s, {train_s / max(o['steps'], 1):.5f} s/step, "
              f"lr_d {o['lr_d']:g}")
    steady = out[1:3]
    phase("slice", "steady s/step (epochs 1-2): "
          f"{sum(o['seconds'] - o['strain_seconds'] for o in steady) / sum(o['steps'] for o in steady):.5f}")
    phase("slice", f"kernels {json.dumps(launches)}")
    return launches


def main() -> int:
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
    phase("build", f"{len(_build.SOURCES)} sources with nvcc for sm_90a: "
          f"{'cached library' if built is None else f'{built:.1f} s'} "
          f"(load {time.perf_counter() - t0:.1f} s); card: {smi[0] if smi else 'unknown'}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())

    results = kernel_phase(torch, port)
    launches = slice_phase(torch, np)
    for r in results:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(smi[0] if smi else "unknown")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
