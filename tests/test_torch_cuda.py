"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch and
the CUDA toolkit are installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which this file
does not need.)

Without a GPU every test here skips (the kernels have no CPU mode).
Tolerances are ``chip_smoke.py``'s: K1 |diff| <= 2e-6 max(1, |ref|), K2a
|diff| <= 1e-5 max(1, |ref|), K2b bit-equal (its quotient is correctly
rounded, as its plain version's).  K3 decides ``d2 <= eps^2`` exactly, so it is
held to a sandwich: the float64 plain version at eps^2 (1 - 1e-4) gives a
lower bound of its counts and mask and at eps^2 (1 + 1e-4) an upper one,
and where the two agree the kernel's counts equal the float64 counts.
The band path (``strain/score.py::fused_percentile_refine``) on the card
must give the float32 path's mask and threshold exactly, launching K1 for
the bulk and again for the band.  The masked train step gives the same
keep mask with and without stem sharing, and the GMM, ensemble and AE
thresholds on the card agree with the CPU plain path's.

The chunked executor: Trainers at ``steps_per_dispatch=4`` (CUDA graph
replays) and ``=1`` (eager steps) end bit-equal, across the in-step mask's
gate, an LR cut (read from the rate tensor, no new capture) and the
``d_train`` flip (a new capture); ``restore_checkpoint`` drops the
captures, and a graph whose tensors were rebound refuses to replay; a step
that cannot be captured raises instead of running eagerly.  The
``Sampler``'s replayed batches equal its eager ones.

The capturable Adam meets the JAX package's updates
(``tests/fixtures/torch_port_jax_adam.npz``) at 1e-5, eagerly and
replayed; the recycling and pooled fake-concat steps replay bit-equal to
eager steps across their gates.  The MNIST MLP steps (G first; D first
with dropout) replay bit-equal to eager steps, with fresh keep masks each
replay, and the FID chain (InceptionV3, the matrix square root) meets the
backbone fixture on the card in float32, as does the eval suite's ResNet50
(rtol 1e-3, atol 1e-2).  The data-parallel rank path under an NCCL group
of one rank (a child process with a launcher's environment,
``tests/test_torch_dp_worker.py``) trains a narrow ``batch_mask`` across its
gate bit-equal to the same run with no group, replayed (its collectives
recorded into the CUDA graphs) and eager.
"""
import numpy as np
import pytest
import torch

from strainer_gan_tpu_torch import kernels as K
from strainer_gan_tpu_torch.kernels import bce as KB
from strainer_gan_tpu_torch.kernels import pairwise as KP
from strainer_gan_tpu_torch.kernels import zscore as KZ
from strainer_gan_tpu_torch.strain import thresholds as TH


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bce_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(5000) * 8, rng.uniform(-110, 110, 2000),
                        [100.0, -100.0, 87.3, -87.3, -88.0, 30.0, -30.0, 0.0]])
    x = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    before = KB.bce_scores.launches
    for t in (1.0, 0.0, 0.9):
        got, ref = KB.bce_scores(x, t), KB.bce_scores_plain(x, t)
        assert torch.all((got - ref).abs() <= 2e-6 * ref.abs().clamp_min(1.0))
    assert KB.bce_scores.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", [False, True])
def test_bce_kernel_into_out(cuda_device, inplace):
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(70_001) * 8).astype(np.float32)).to(cuda_device)
    for t in (1.0, 0.9):
        want = KB.bce_scores(x, t)
        out = x.clone() if inplace else torch.empty_like(x)
        got = KB.bce_scores(out if inplace else x, t, out=out)
        assert got is out and torch.equal(out, want)
    with pytest.raises(ValueError):
        KB.bce_scores(x, 1.0, out=torch.empty(5, device=cuda_device))


@pytest.mark.cuda
def test_bce_kernel_replays_from_a_cuda_graph(cuda_device):
    x = torch.linspace(-110.0, 110.0, 70_000, device=cuda_device)
    out = torch.empty_like(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        KB.bce_scores(x, 1.0, out=out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        KB.bce_scores(x, 1.0, out=out)
    out.zero_()
    x.copy_(torch.linspace(-50.0, 50.0, 70_000, device=cuda_device))  # new inputs, same buffer
    graph.replay()
    ref = KB.bce_scores_plain(x, 1.0)
    torch.cuda.synchronize()
    assert torch.all((out - ref).abs() <= 2e-6 * ref.abs().clamp_min(1.0))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN matching a NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 512), (70_001, 512), (3000, 100), (2049, 30)])
def test_row_max_kernel_bit_equal(cuda_device, n, d):
    # float4 groups (512, 100) and the scalar path (30); a zero-std column,
    # a tiny and a huge std, and rows with a NaN and an inf
    g = torch.Generator(device=cuda_device).manual_seed(n + d)
    f = torch.randn((n, d), generator=g, device=cuda_device) * 3.0 - 1.0
    f[:, 0] = 2.5
    if n > 3:
        f[1, d // 2] = float("nan")
        f[2, 0] = float("nan")  # on the zero-std column: z = 0 there, as plain
        f[3, 1] = float("inf")
    for mode in ("torch", "numpy_eps"):
        mean, std = KZ.column_stats(f, None, mode)
        assert _same(KZ.row_max_abs_z(f, mean, std), KZ.row_max_abs_z_plain(f, mean, std))
    std = torch.rand(d, generator=g, device=cuda_device) + 0.1
    std[1], std[2], std[3] = 1e-30, 1e30, 0.0
    mean = torch.randn(d, generator=g, device=cuda_device)
    assert _same(KZ.row_max_abs_z(f, mean, std), KZ.row_max_abs_z_plain(f, mean, std))


@pytest.mark.cuda
def test_row_max_kernel_misaligned_rows(cuda_device):
    buf = torch.randn(3001 * 512 + 1, device=cuda_device)
    f = buf[1:].view(3001, 512)  # contiguous, 4 bytes off a 16-byte boundary
    mean, std = KZ.column_stats(f, None, "torch")
    before = KZ.row_max_abs_z.launches
    assert torch.equal(KZ.row_max_abs_z(f, mean, std), KZ.row_max_abs_z_plain(f, mean, std))
    assert KZ.row_max_abs_z.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("std_mode", ["torch", "numpy_eps"])
def test_zscore_kernels_match_plain(cuda_device, std_mode):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    f = torch.randn((5000, 512), generator=g, device=cuda_device) * 2.0 + 0.5
    f[:, 3] = 1.25  # zero std: z = 0
    valid = torch.rand(5000, generator=g, device=cuda_device) > 0.1
    for v in (None, valid):
        mean, std = KZ.column_stats(f, v, std_mode)
        mean_p, std_p = KZ.column_stats_plain(f, v, std_mode)
        for got, ref in ((mean, mean_p), (std, std_p)):
            assert torch.all((got - ref).abs() <= 1e-5 * ref.abs().clamp_min(1.0))
        z = KZ.row_max_abs_z(f, mean, std)
        assert torch.equal(z, KZ.row_max_abs_z_plain(f, mean, std))
        ref = TH._masked_max_abs_z(f, v, std_mode)
        got = KZ.masked_max_abs_z(f, v, std_mode)
        assert torch.all((got - ref).abs() <= 1e-5 * ref.abs().clamp_min(1.0))
    assert set(K.launch_counts()) == {"bce_scores", "zscore_column_stats", "zscore_row_max",
                                      "neighbor_counts"}


def _clustered(rng, n, d):
    """Tight clusters plus spread noise, float32."""
    centers = rng.standard_normal((24, d)) * 4.0
    x = centers[rng.integers(0, 24, n)] + rng.standard_normal((n, d)) * 0.5
    noise = rng.choice(n, n // 5, replace=False)
    x[noise] = rng.standard_normal((noise.size, d)) * 4.0
    return x.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [512, 100])  # 100: the feature padding path
@pytest.mark.parametrize("masked", [False, True])
def test_neighbor_counts_kernel_sandwich(cuda_device, d, masked):
    delta = 1e-4
    rng = np.random.default_rng(3)
    n = 3001  # not a multiple of the 128-row tile
    x = torch.from_numpy(_clustered(rng, n, d)).to(cuda_device)
    valid = torch.from_numpy(rng.uniform(size=n) > 0.1).to(cuda_device) if masked else None
    # eps: the 1st percentile of the pairwise distances of a sample of rows,
    # which falls among the within-cluster distances
    s = x[:500].double()
    eps = float(torch.quantile(torch.cdist(s, s)[torch.triu_indices(500, 500, 1).unbind()],
                               0.01))
    x64 = x.double()
    lo_eps, hi_eps = eps * (1 - delta) ** 0.5, eps * (1 + delta) ** 0.5
    before = KP.neighbor_counts.launches
    got = KP.neighbor_counts(x, eps, valid)
    lo = KP.neighbor_counts_plain(x64, lo_eps, valid)
    hi = KP.neighbor_counts_plain(x64, hi_eps, valid)
    assert bool((lo <= got).all()) and bool((got <= hi).all())
    clear = lo == hi
    assert torch.equal(got[clear], KP.neighbor_counts_plain(x64, eps, valid)[clear])
    # the second pass's weights: the kernel's own core points on both sides
    core = got >= 3
    got_w = KP.neighbor_counts(x, eps, valid, col_weights=core)
    lo_w = KP.neighbor_counts_plain(x64, lo_eps, valid, col_weights=core)
    hi_w = KP.neighbor_counts_plain(x64, hi_eps, valid, col_weights=core)
    assert bool((lo_w <= got_w).all()) and bool((got_w <= hi_w).all())
    clear = lo_w == hi_w
    assert torch.equal(got_w[clear],
                       KP.neighbor_counts_plain(x64, eps, valid, col_weights=core)[clear])
    if valid is not None:
        assert not bool(got[~valid].any())
    # DBSCAN's non-noise mask inside the sandwich, not all noise or all core
    mask = KP.dbscan_non_noise(x, eps, 3, valid)
    m_lo = KP.dbscan_non_noise_plain(x64, lo_eps, 3, valid)
    m_hi = KP.dbscan_non_noise_plain(x64, hi_eps, 3, valid)
    assert not bool((m_lo & ~mask).any()) and not bool((mask & ~m_hi).any())
    assert 0.05 < float(mask.float().mean()) < 0.95
    assert KP.neighbor_counts.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 512), (70_001, 512), (3000, 100), (2049, 30)])
@pytest.mark.parametrize("std_mode", ["torch", "numpy_eps", "population"])
def test_column_stats_shapes(cuda_device, n, d, std_mode):
    # one-row, ragged-chunk, float4 and scalar (d % 4 != 0) column passes;
    # masks with some and with no valid rows
    g = torch.Generator(device=cuda_device).manual_seed(n + d)
    f = torch.randn((n, d), generator=g, device=cuda_device) * 3.0 - 1.0
    f[:, 0] = -2.5  # zero std
    for v in (None, torch.rand(n, generator=g, device=cuda_device) > 0.3,
              torch.zeros(n, dtype=torch.bool, device=cuda_device)):
        mean, std = KZ.column_stats(f, v, std_mode)
        mean_p, std_p = KZ.column_stats_plain(f, v, std_mode)
        for got, ref in ((mean, mean_p), (std, std_p)):
            assert torch.all((got - ref).abs() <= 1e-5 * ref.abs().clamp_min(1.0))
        assert float(std[0]) == float(std_p[0])
        # the same on every run: a fixed merge order and no atomics
        again = KZ.column_stats(f, v, std_mode)
        assert torch.equal(again[0], mean) and torch.equal(again[1], std)


@pytest.mark.cuda
def test_neighbor_counts_error_within_band(cuda_device):
    # the 3xTF32 d2 of sampled tiles against float64, within the derived tau
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_clustered(rng, 1000, 512) + 3.0).to(cuda_device)
    counts, _, d2 = KP._counts_cuda(x, 16.0, None, torch.ones(1000, dtype=torch.bool,
                                                                 device=cuda_device),
                                    want_adjacency=False, sample_tiles=3)
    x64 = x.double()
    sq = (x64 * x64).sum(1)
    dp = 512
    for idx, (i, j) in enumerate([(0, 0), (0, 1), (0, 2)]):
        a, b = x64[i * 128:(i + 1) * 128], x64[j * 128:(j + 1) * 128]
        exact = torch.cdist(a, b) ** 2
        s = sq[i * 128:(i + 1) * 128, None] + sq[None, j * 128:(j + 1) * 128]
        ratio = float(((d2[idx].double() - exact).abs() / s).max())
        assert ratio <= KP.band_tau_coef(dp), (ratio, KP.band_tau_coef(dp))
    assert torch.equal(counts.float(), KP.neighbor_counts(x, 16.0))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 4000])
def test_dbscan_passes_small_and_overflowing_band(cuda_device, n, monkeypatch):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(_clustered(rng, n, 64)).to(cuda_device)
    valid = torch.from_numpy(rng.uniform(size=n) > 0.2).to(cuda_device)
    x64 = x.double()
    s = x64[: min(n, 400)]
    eps = float(torch.quantile(torch.cdist(s, s).flatten(), 0.05)) if n > 1 else 1.0
    mask = KP.dbscan_non_noise(x, eps, 3, valid)
    counts = KP.neighbor_counts(x, eps, valid)
    # the same on every run, and with a band list too small for one pass
    monkeypatch.setattr(KP, "_band_cap", lambda n: 1)
    if KP.last_band_pairs > 1:
        with pytest.warns(UserWarning, match="overflowed"):
            again = KP.dbscan_non_noise(x, eps, 3, valid)
    else:
        again = KP.dbscan_non_noise(x, eps, 3, valid)
    assert torch.equal(again, mask)
    assert torch.equal(KP.neighbor_counts(x, eps, valid), counts)
    delta = 1e-4
    lo = KP.dbscan_non_noise_plain(x64, eps * (1 - delta) ** 0.5, 3, valid)
    hi = KP.dbscan_non_noise_plain(x64, eps * (1 + delta) ** 0.5, 3, valid)
    assert not bool((lo & ~mask).any()) and not bool((mask & ~hi).any())


@pytest.mark.cuda
@pytest.mark.parametrize("ratio,subset", [(0.2, False), (0.8, True), (1.0, False)])
def test_band_path_equals_f32_on_the_card(cuda_device, ratio, subset):
    from strainer_gan_tpu_torch.data import DeviceDataset
    from strainer_gan_tpu_torch.data.mixers import Mixture
    from strainer_gan_tpu_torch.models import Discriminator64, init_dcgan_weights
    from strainer_gan_tpu_torch.strain import score as SC

    n = 4096
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (n, 64, 64, 3), np.uint8)
    imgs[: n // 2, 16:48, 16:48] = 255
    ds = DeviceDataset(Mixture(images=imgs, source_id=np.zeros((n,), np.int32),
                               labels=np.zeros((n,), np.int64)), cuda_device)
    disc = Discriminator64(16)
    init_dcgan_weights(disc, torch.Generator().manual_seed(0))
    with torch.no_grad():
        disc.convs[-1].weight.mul_(1000.0)  # spread the losses: a band of a few percent
    disc = disc.to(cuda_device)
    keep = torch.ones(n, dtype=torch.bool, device=cuda_device)
    if subset:
        keep[::3] = False
    sub = torch.nonzero(keep).flatten() if subset else None
    losses = SC.score_d_losses(disc, ds, batch_size=512, subset=sub)
    if subset:
        losses = torch.full((n,), float("inf"), device=cuda_device).index_put_((sub,), losses)
    want_mask, want_thr = TH.percentile_refine_mask(losses, ratio, valid=keep)
    before = KB.bce_scores.launches
    mask, thr, scores, stats = SC.fused_percentile_refine(disc, ds, ratio, keep,
                                                          batch_size=512, subset=sub)
    assert KB.bce_scores.launches - before >= 2
    n_rescored, fell_back, drift = stats.tolist()
    assert fell_back == 0.0 and drift > 0.0 and 0 < n_rescored < n // 4
    assert torch.equal(mask, want_mask)
    assert float(thr) == float(want_thr)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 77])
def test_masked_step_stem_sharing_on_the_card(cuda_device, lanes):
    """The masked step with and without stem sharing, at full width in
    float32: the scoring forward is the same computation either way, so the
    keep mask and the scores are equal; the losses agree to 1e-4 (relative:
    cuDNN may pick another algorithm for the real side's head when its
    input carries a graph) and every parameter to 2 lr (Adam's first step
    moves an element by lr whatever its gradient's size, so a gradient at
    rounding level may move it either way).  TF32 off."""
    from strainer_gan_tpu_torch import get_preset
    from strainer_gan_tpu_torch.device import f32_math
    from strainer_gan_tpu_torch.models import build_models
    from strainer_gan_tpu_torch.train.state import make_optimizers
    from strainer_gan_tpu_torch.train.steps import step_config_from, train_step

    cfg = get_preset("batch_mask")
    scfg = step_config_from(cfg)._replace(compute_dtype="float32")
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.rand((128, 3, 64, 64), generator=g, device=cuda_device) * 2 - 1
    src = (torch.rand(128, generator=g, device=cuda_device) < 0.1).to(torch.int32)
    z = torch.randn((128, 100), generator=g, device=cuda_device)
    runs = []
    for share in (True, False):
        gen, disc = (m.to(cuda_device) for m in build_models(cfg.model, seed=1))
        opt_g, opt_d = make_optimizers(cfg, gen, disc)
        with f32_math():
            m = train_step(gen, disc, opt_g, opt_d, x, src, z, 2e-4, 2e-4, scfg,
                           lane_count=lanes, mask_on=True, stem_share=share)
        runs.append((m, [p.detach() for p in list(gen.parameters()) + list(disc.parameters())]))
    (ma, pa), (mb, pb) = runs
    assert torch.equal(ma["keep_mask"], mb["keep_mask"])
    assert torch.equal(ma["score_probs"], mb["score_probs"])
    assert int(ma["keep_mask"].sum()) < (lanes or 128)
    for k in ("errD", "errG", "D_x", "D_G_z1", "D_G_z2"):
        assert abs(float(ma[k]) - float(mb[k])) <= 1e-4 * max(1.0, abs(float(mb[k]))), k
    for a, b in zip(pa, pb):
        assert float((a - b).abs().max()) <= 2 * 2e-4 * (1 + 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m", ["all", "valid"])
def test_loss_space_and_ae_thresholds_on_the_card(cuda_device, m):
    """``gmm_mask``, ``ensemble_mask`` and ``ae_error_mask`` on the card
    against the port's CPU plain path on the same inputs (the loss
    fixture's): thresholds within 1e-5 (relative), any flipped decision
    within 1e-5 (relative) of the CPU threshold."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    inp = smoke.loss_fixture_inputs()
    cases = [(TH.gmm_mask, inp["losses"]), (TH.ensemble_mask, inp["losses"]),
             (lambda e, v: TH.ae_error_mask(e, 2.0, v), inp["ae_errors"])]
    for fn, scores in cases:
        x = torch.from_numpy(scores)
        v = torch.from_numpy(inp["loss_valid"][:x.shape[0]]) if m == "valid" else None
        cpu_mask, cpu_thr = fn(x, v)
        mask, thr = fn(x.to(cuda_device), None if v is None else v.to(cuda_device))
        assert abs(float(thr) - float(cpu_thr)) <= 1e-5 * abs(float(cpu_thr))
        flipped = mask.cpu() != cpu_mask
        assert torch.all((x[flipped] - cpu_thr).abs() <= 1e-5 * abs(float(cpu_thr)))


# ---- the chunked executor (CUDA graphs) and the serving Sampler


def _graph_cfg(preset, spd, epochs=2, **train):
    import dataclasses

    from strainer_gan_tpu_torch import get_preset

    cfg = get_preset(preset)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=32),
        model=dataclasses.replace(cfg.model, ngf=16, ndf=16),
        train=dataclasses.replace(cfg.train, epochs=epochs, log_every=5,
                                  steps_per_dispatch=spd, **train))
    if preset == "batch_mask":
        cfg = cfg.replace(strain=dataclasses.replace(cfg.strain, mask_start_epoch=1))
    return cfg


def _graph_trainer(cfg, dataset=None):
    import io

    from strainer_gan_tpu_torch.train.loop import Trainer

    tr = Trainer(cfg, max_synth=None if dataset else 320, dataset=dataset)
    tr.logger.stream = io.StringIO()
    tr.setup()
    return tr


def _captured_once(tr):
    """The number of ``tr``'s capture keys, after checking that each of
    its executors (a key's chunk, and the gated chunk and gated tail of its
    remainders and tail) was captured once."""
    gs = tr.graph_stats
    assert gs["captures"] == len(tr._executors) + len(tr._gated) + len(tr._gated_tails)
    return len(tr._executors)


def _assert_bit_equal(a, b):
    for name in ("gen", "disc", "opt_g", "opt_d"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        if name.startswith("opt"):
            sa, sb = sa["state"], sb["state"]
            sa = {f"{i}.{k}": v for i, st in sa.items() for k, v in st.items()}
            sb = {f"{i}.{k}": v for i, st in sb.items() for k, v in st.items()}
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name} {k}"
    assert a.logger.stream.getvalue() == b.logger.stream.getvalue()
    assert a.logger.G_losses == b.logger.G_losses and a.logger.D_losses == b.logger.D_losses
    for x, y in zip(a.epoch_loss_history, b.epoch_loss_history):
        assert np.array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["batch_mask", "basic"])
def test_chunked_replay_equals_eager(cuda_device, preset):
    """steps_per_dispatch=4 (graph replays) against =1 (eager), bf16 as
    shipped, from the same initial state and draws: bit for bit.  For
    ``batch_mask`` epoch 1 is gated; ``basic`` cuts its rate at epoch 1
    (``lr_decay_epoch``), which the replays must read from the rate tensor
    without a new capture."""
    from strainer_gan_tpu_torch.train.state import get_lr

    extra = dict(lr_decay_epoch=1) if preset == "basic" else {}
    runs = []
    for spd in (4, 1):
        tr = _graph_trainer(_graph_cfg(preset, spd, **extra))
        for e in range(2):
            tr.run_epoch(e)
        runs.append(tr)
    a, b = runs
    _assert_bit_equal(a, b)
    assert a.graph_stats["replays"] > 0 and b.graph_stats["replays"] == 0
    if preset == "basic":
        assert _captured_once(a) == 1  # the LR cut needs no new capture
        assert get_lr(a.opt_d) == get_lr(b.opt_d) == pytest.approx(a.cfg.train.lr_d * 0.1)
    else:
        assert _captured_once(a) == 2  # ungated and gated
        assert a.epoch_results[1]["total_contam"] == b.epoch_results[1]["total_contam"] > 0


@pytest.mark.cuda
def test_d_train_flip_captures_again(cuda_device):
    """bn_eval_after_score turns D's batch statistics off: a new capture
    key, and still bit-equal to eager steps."""
    runs = []
    for spd in (4, 1):
        tr = _graph_trainer(_graph_cfg("basic", spd))
        tr.run_epoch(0)
        tr.engine.d_bn_eval = True
        tr.run_epoch(1)
        runs.append(tr)
    a, b = runs
    _assert_bit_equal(a, b)
    assert _captured_once(a) == 2
    assert {k[2] for k in a._executors} == {True, False}


@pytest.mark.cuda
def test_restore_drops_captures(cuda_device, tmp_path):
    """After restore_checkpoint the cache is empty, the old graph refuses to
    replay (its tensors were rebound: checked by data_ptr), and the next
    capture reads the restored tensors."""
    from strainer_gan_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint

    tr = _graph_trainer(_graph_cfg("basic", 4))
    tr.run_epoch(0)
    save_checkpoint(str(tmp_path / "ck"), tr, 0)
    tr.run_epoch(1)
    (old,) = tr._executors.values()
    assert old.graph is not None
    restore_checkpoint(str(tmp_path / "ck"), tr)
    assert not tr._executors
    with pytest.raises(RuntimeError, match="rebound"):
        old(old.idx.clone(), old.z.clone(), 2e-4, 2e-4)
    tr.run_epoch(1)
    (new,) = tr._executors.values()
    assert new.graph is not None and new._ptrs == new._pointers()
    steps = [st["step"].data_ptr() for st in tr.opt_d.state.values()]
    assert set(steps) <= set(new._ptrs)


@pytest.mark.cuda
def test_sampler_replay_equals_eager(cuda_device):
    """One batch a replay (after an eager warm-up batch), bit-equal to the
    eager batch on the same noise."""
    from strainer_gan_tpu_torch.serve import Sampler

    cfg = _graph_cfg("final", 4)
    gen = _graph_trainer(cfg).gen
    s = Sampler(cfg, gen.state_dict(), batch_size=16)
    g = torch.Generator().manual_seed(0)
    zs = [torch.randn((16, cfg.model.nz), generator=g) for _ in range(4)]
    got = [s._run(z) for z in zs]
    assert s.replays == 3
    for z, out in zip(zs, got):
        assert torch.equal(out, s._sample_batch(z.to(cuda_device)))
    imgs = s.sample(40, seed=1)
    assert imgs.shape == (40, 64, 64, 3) and imgs.dtype == np.uint8


def _smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
@pytest.mark.parametrize("replay", [False, True], ids=["eager", "replayed"])
def test_capturable_adam_matches_jax_fixture(cuda_device, replay):
    """``make_adam``'s capturable Adam (bias correction on the device in
    float32, the rate a device tensor) against the JAX package's
    ``optax.scale_by_adam`` updates in ``tests/fixtures/torch_port_jax_adam.npz``
    (tests/test_torch_adam.py), at the presets' betas and torch's defaults,
    two rates and an LR cut between updates: parameters within 1e-5, the
    moments within 1e-5 of their tensor's largest magnitude; eagerly and
    with every update after the first replayed from one captured step."""
    smoke = _smoke()
    with np.load(smoke.JAX_ADAM_FIXTURE) as f:
        fixture = dict(f)
    gaps = smoke.adam_gaps(torch, np, fixture, smoke.adam_fixture_inputs(), cuda_device,
                           replay=replay)
    assert all(g <= smoke.ADAM_TOL for g in gaps.values()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["in_batch_recycle", "loss_concat_fast"])
def test_fake_concat_replay_equals_eager(cuda_device, preset):
    """The fake-concat steps, gate at epoch 1: steps_per_dispatch=4 (graph
    replays) against =1 (eager), bit for bit.  Recycling makes a second
    capture at its gate (the in-step keep); the pool's gate is a flag
    filled before each replay, so the pooled run captures once, and both
    runs train on the same device-resident pool."""
    import dataclasses

    runs = []
    for spd in (4, 1):
        cfg = _graph_cfg(preset, spd)
        cfg = cfg.replace(strain=dataclasses.replace(cfg.strain, fake_concat_start_epoch=1,
                                                     start_epoch=5))
        tr = _graph_trainer(cfg)
        for e in range(2):
            tr.run_epoch(e)
        runs.append(tr)
    a, b = runs
    _assert_bit_equal(a, b)
    assert a.graph_stats["replays"] > 0 and b.graph_stats["replays"] == 0
    if preset == "in_batch_recycle":
        assert _captured_once(a) == 2
        assert torch.equal(a.engine.last_batch_mask, b.engine.last_batch_mask)
        assert int(a.engine.last_batch_mask.sum()) < a.engine.last_batch_valid
    else:
        assert _captured_once(a) == 1
        assert a.fake_pool.is_cuda and torch.equal(a.fake_pool, b.fake_pool)


def _mnist_cfg(preset, spd):
    import dataclasses

    from strainer_gan_tpu_torch import get_preset

    cfg = get_preset(preset)
    # mnist_full's prefilter keeps about half of its 360 images: batch 16
    # gives each epoch a warm-up step or a chunk and a remainder
    data = cfg.data if cfg.data.auto_batch_divisor else dataclasses.replace(cfg.data,
                                                                             batch_size=16)
    return cfg.replace(data=data, train=dataclasses.replace(cfg.train, epochs=2, log_every=3,
                                                            steps_per_dispatch=spd))


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["mnist8", "mnist_full"])
def test_mlp_replay_equals_eager(cuda_device, preset, monkeypatch):
    """The MLP step, bf16 as shipped: steps_per_dispatch=4 (graph replays)
    against =1 (eager), from the same initial state and draws, bit for
    bit: G first for ``mnist8`` (auto batch), D first with dropout, label
    smoothing and G's BatchNorm1d for ``mnist_full`` (after its 1-channel
    z-score prefilter).  Consecutive replays of ``mnist_full`` see fresh
    keep masks."""
    import io

    from strainer_gan_tpu_torch.train import steps as ST
    from strainer_gan_tpu_torch.train.loop import Trainer

    seen = []
    call = ST.ChunkedStep.__call__

    def watched(self, idx, z, lr_g, lr_d, **kw):
        seen.append([m.clone() for m in kw.get("drop") or ()])
        return call(self, idx, z, lr_g, lr_d, **kw)

    monkeypatch.setattr(ST.ChunkedStep, "__call__", watched)
    runs = []
    for spd in (4, 1):
        tr = Trainer(_mnist_cfg(preset, spd), max_synth=3000,
                     dataset=runs[0].dataset if runs else None)
        tr.logger.stream = io.StringIO()
        tr.setup()
        for e in range(2):
            tr.run_epoch(e)
        runs.append(tr)
    a, b = runs
    _assert_bit_equal(a, b)
    assert a.graph_stats["replays"] >= 2 and b.graph_stats["replays"] == 0
    if preset == "mnist_full":
        masks = [m for m in seen if m]
        assert len(masks) >= 2 and all(m[0].shape[1:] == (3, 16, 1024) for m in masks)
        assert all(not torch.equal(x[0], y[0]) for x, y in zip(masks, masks[1:]))
        keep = float(masks[0][0].float().mean())
        assert 0.65 < keep < 0.75
    else:
        assert a.cfg.data.batch_size == min(max(a.dataset.n // 10, 16), 64)


@pytest.mark.cuda
def test_fid_chain_on_the_card(cuda_device):
    """InceptionV3 (synthetic weights) and the FID chain on the card, in
    float32 with TF32 off: the fixture's activations within atol 2e-3 and
    its FID within rtol 2e-2 (tests/test_backbone_fixtures.py's bounds);
    the Newton-Schulz and eigh traces of a well-conditioned 2048-dim pair
    within 1e-3 of each other."""
    import os

    from strainer_gan_tpu_torch.eval import fid as TF
    from strainer_gan_tpu_torch.models.inception import InceptionV3Features
    from strainer_gan_tpu_torch.models.synth_weights import load_synth_weights
    from strainer_gan_tpu_torch.ops import sqrtm as TS

    fx = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "backbones.npz"))
    model = load_synth_weights(InceptionV3Features()).eval().to(cuda_device)

    def nchw(u8):
        x = ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5
        return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(cuda_device)

    acts = TF.get_activations(nchw(fx["fid_a_u8"]), model, batch_size=16)
    np.testing.assert_allclose(acts.cpu().numpy(), fx["inception_acts_a"], atol=2e-3)
    fid = TF.calculate_fid(nchw(fx["fid_a_u8"]), nchw(fx["fid_b_u8"]), model, batch_size=16)
    np.testing.assert_allclose(fid, float(fx["fid_value"]), rtol=2e-2)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    pair = []
    for _ in range(2):
        a = torch.randn((4096, 2048), generator=g, device=cuda_device)
        pair.append(a.T @ a / 4096 + 0.1 * torch.eye(2048, device=cuda_device))
    ns = float(TS.trace_sqrtm_product_ns(*pair))
    eig = float(TS.trace_sqrtm_product(*pair))
    assert abs(ns - eig) <= 1e-3 * abs(eig)


@pytest.mark.cuda
def test_capture_holds_the_collector_off(cuda_device, monkeypatch):
    """A Trainer is a reference cycle (its optimizers' load hooks hold it),
    so only Python's collector frees a dead one and its graphs; a collection
    inside a later capture would destroy a graph there, which the capturing
    stream refuses (``chip_smoke.py`` failed so once, in ``batch_mask``'s
    capture).  ``steps.capturing`` collects before the capture and holds
    the collector off during it: inside the capture the dead Trainer is
    gone and the collector is off, and the capture succeeds."""
    import gc
    import weakref

    from strainer_gan_tpu_torch.train import steps as ST

    old = _graph_trainer(_graph_cfg("basic", 4, sample_every=0))
    old.run_epoch(0)
    assert _captured_once(old) == 1
    dead = weakref.ref(old)
    del old  # cyclic garbage from here on
    body, seen = ST.ChunkedStep._body, []

    def watched(self):
        seen.append((gc.isenabled(), dead() is None))
        body(self)

    monkeypatch.setattr(ST.ChunkedStep, "_body", watched)
    tr = _graph_trainer(_graph_cfg("basic", 4, sample_every=0))
    tr.run_epoch(0)
    assert seen == [(False, True)]  # the capture's only body call
    assert gc.isenabled()
    assert _captured_once(tr) == 1 and tr.graph_stats["replays"] > 0


def _deferred_cfg(defer):
    """A narrow ``final`` (tests/test_torch_deferred.py's schedule): strains
    from epoch 1 keeping about 50, 10 and 50 %, chunks of 4, no grids;
    epochs 2 (an overshooting guess) and 3 (a catch-up) deferred."""
    import dataclasses

    cfg = _graph_cfg("final", 4, epochs=4, sample_every=0, defer_epoch_stats=defer)
    return cfg.replace(strain=dataclasses.replace(
        cfg.strain, start_epoch=1, score_batch=64,
        clean_ratio_schedule=((0, 1.0), (1, 0.5), (2, 0.9), (3, 0.5))))


@pytest.mark.cuda
def test_deferred_final_on_the_card(cuda_device):
    """The deferred epochs' gated chunks (each step under a CUDA graph IF
    node) and gated tails, bit-equal to the blocking run: parameters,
    BatchNorm buffers, Adam state, losses, per-sample history, masks and
    console text."""
    runs, ds = {}, None
    for defer in (True, False):
        tr = _graph_trainer(_deferred_cfg(defer), dataset=ds)
        ds = tr.dataset
        for e in range(4):
            tr.run_epoch(e)
        runs[defer] = tr
    d, b = runs[True], runs[False]
    _assert_bit_equal(d, b)
    assert d.logger.stream.getvalue() == b.logger.stream.getvalue()
    assert d.logger.G_losses == b.logger.G_losses
    assert all(np.array_equal(x, y) for x, y in zip(d.epoch_loss_history, b.epoch_loss_history))
    assert all(np.array_equal(x, y) for x, y in zip(d.mask_history, b.mask_history))
    gs = d.graph_stats
    assert gs["deferred_epochs"] == 2 and b.graph_stats["deferred_epochs"] == 0
    assert gs["conditional_nodes"] > 0 and gs["gated_replays"] > 0
    assert d.epoch_results[2]["steps"] < d.epoch_results[1]["steps"]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["blocking", "deferred"])
def test_failed_gated_capture_raises(cuda_device, monkeypatch, path):
    """A gated step that reads a value back to the host cannot be captured:
    the epoch raises, and no step runs in the gated graph's place.  On the
    blocking path the key's first gated launch (its first remainder or
    tail, epoch 0) captures; a deferred epoch does not run as a blocking
    one (its key's gated graphs forgotten after two epochs, so that it
    captures them itself)."""
    from strainer_gan_tpu_torch.train import steps as ST

    body = ST.step_body

    def reads_back(*args, **kwargs):
        m = body(*args, **kwargs)
        float(m["errD"])  # a host read: illegal while a stream is capturing
        return m

    tr = _graph_trainer(_deferred_cfg(path == "deferred"))
    if path == "blocking":
        capture = ST.GatedChunkedStep._capture

        def failing(self):
            monkeypatch.setattr(ST, "step_body", reads_back)
            capture(self)

        monkeypatch.setattr(ST.GatedChunkedStep, "_capture", failing)
        with pytest.raises(Exception):
            tr.run_epoch(0)
        gs = tr.graph_stats
        # the warm-up step and whole chunks ran; nothing of the remainder
        assert tr.logger.summary()["steps"] % 4 == 1 and gs["replays"] > 0
    else:
        for e in range(2):
            tr.run_epoch(e)
        before = dict(tr.graph_stats)
        tr._gated.clear()
        tr._gated_tails.clear()
        monkeypatch.setattr(ST, "step_body", reads_back)
        with pytest.raises(Exception):
            tr.run_epoch(2)
        gs = tr.graph_stats
        assert gs["deferred_epochs"] == 1 and gs["blocking_epochs"] == 2
        assert gs["replays"] == before["replays"]
    assert gs["conditional_nodes"] == (0 if path == "blocking" else before["conditional_nodes"])
    assert gs["gated_replays"] == (0 if path == "blocking" else before["gated_replays"])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device, monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    run raises, and no step ran eagerly in the graph's place.  (Last in the
    file: it leaves a failed capture behind.)"""
    from strainer_gan_tpu_torch.train import steps as ST

    body = ST.step_body

    def reads_back(*args, **kwargs):
        m = body(*args, **kwargs)
        float(m["errD"])  # a host read: illegal while a stream is capturing
        return m

    tr = _graph_trainer(_graph_cfg("basic", 4, sample_every=0))
    monkeypatch.setattr(ST, "step_body", reads_back)
    with pytest.raises(Exception):
        tr.run_epoch(0)
    assert tr.graph_stats["captures"] == 0 and tr.graph_stats["replays"] == 0
    # the warm-up step ran; nothing after it
    assert tr.logger.summary()["steps"] == 1
    torch.cuda.synchronize()


# ---- the eval suite's ResNet50 and the rank path (NCCL)


@pytest.mark.cuda
def test_resnet50_fixture_on_the_card(cuda_device):
    """The eval suite's ResNet50 (synthetic weights) on the card in float32
    with TF32 off: the fixture's features within rtol 1e-3 / atol 1e-2
    (tests/test_backbone_fixtures.py:65-71)."""
    import os

    from strainer_gan_tpu_torch.models.features import build_feature_fn

    fx = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "backbones.npz"))
    x = ((fx["resnet_input_u8"].astype(np.float32) / 255.0) - 0.5) / 0.5
    f = build_feature_fn("resnet50", 3, cuda_device)
    got = f(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), fx["resnet50_features"], rtol=1e-3,
                               atol=1e-2)


@pytest.fixture(scope="module")
def nccl_runs(tmp_path_factory):
    """``tests/test_torch_dp_worker.py::card_rank_runs`` in a child process under
    a launcher's environment of one rank (NCCL on the card; the store held
    here through ``parallel.multihost.Rendezvous``), with a 600 s limit."""
    import os
    import subprocess
    import sys

    from strainer_gan_tpu_torch.parallel.multihost import Rendezvous

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NCCL group runs on the card")
    path = tmp_path_factory.mktemp("nccl") / "runs.pt"
    here = os.path.dirname(os.path.abspath(__file__))
    with Rendezvous(1) as rdv:
        env = dict(os.environ, **rdv.env(0),
                   PYTHONPATH=os.pathsep.join([here, os.path.dirname(here)]))
        res = subprocess.run([sys.executable, "-c", "import sys, test_torch_dp_worker as W; "
                              "W.card_rank_runs(sys.argv[1])", str(path)], env=env, cwd=here,
                             capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return torch.load(path, weights_only=False)


@pytest.mark.cuda
@pytest.mark.parametrize("spd", [4, 1], ids=["replayed", "eager"])
def test_rank_path_nccl_world1_equals_no_group(cuda_device, nccl_runs, spd):
    """The rank path under an NCCL group of one rank (its collectives in
    the step, replayed inside the CUDA graphs or eager) trains a narrow
    ``batch_mask`` across its gate bit-equal to the same run with no
    group: parameters, BatchNorm buffers, Adam state, losses, per-sample
    history, masks, contamination counts and console text."""
    import test_torch_dp_worker as W

    assert nccl_runs["backend"] == "nccl" and nccl_runs["world"] == 1
    got, want = nccl_runs[spd], W.card_snapshot(spd)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        elif k in ("history", "masks"):
            assert all(np.array_equal(a, b) for a, b in zip(got[k], v)), k
        else:
            assert got[k] == v, k
    assert (got["graphs"]["replays"] > 0) == (spd == 4)
    assert got["contam"][1] > 0
