"""The port's band path (bfloat16 bulk, float32 band) against float32
scoring, the port's and the JAX package's (CPU, small size).

``strain/score.py::fused_percentile_refine`` must give the mask and the
threshold that float32 scoring followed by ``percentile_refine_mask``
gives, for any band: the band's re-scores, the median re-score of the
empty-keep fallback (ratio 1.0), a base subset, and the full-float32
fallback when a band exceeds its capacity.  D's weights come from the JAX
package's initial state (its logit-head kernel amplified, as
`tests/test_band_scoring.py` does, so the losses spread the way a trained
D's do and the band is a few percent of the set), bridged into the port.

Tolerances: the port's band mask and threshold equal the port's float32
ones exactly (the band's float32 re-scores are the float32 pass's values,
bit for bit); the masks equal the JAX package's float32 mask exactly, and
the thresholds agree to rtol 1e-5 (torch's and XLA's float32 convolutions
round differently; each case prints the nearest loss's distance to the
threshold, so a near-tie would show).  The JAX side scores in float32
(``score_d_losses``): `tests/test_band_scoring.py` holds the JAX band path
equal to it, and compiling that fused program on the CPU is slow.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.data import DeviceDataset as JDataset
from strainer_gan_tpu.data.mixers import Mixture as JMixture
from strainer_gan_tpu.models import Discriminator64 as JDisc, Generator64 as JGen
from strainer_gan_tpu.strain import score as JSC, thresholds as JTH
from strainer_gan_tpu.train.state import create_state

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.data import DeviceDataset
from strainer_gan_tpu_torch.data.mixers import Mixture
from strainer_gan_tpu_torch.models import Discriminator64
from strainer_gan_tpu_torch.strain import score as SC, thresholds as TH
from strainer_gan_tpu_torch.train.loop import Trainer

N, WIDTH, BATCH = 1024, 16, 128
AMPLIFY = 1000.0  # the logit head's gain: losses about 0.9-3.9, bands 5-10% of the set


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread each, so parallel test workers do
    not oversubscribe the cores (torch's thread pool spins while it waits)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_preset("final")
    gen, disc = JGen(ngf=WIDTH, compute_dtype=jnp.float32), JDisc(ndf=WIDTH,
                                                                   compute_dtype=jnp.float32)
    state = create_state(cfg, gen, disc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (N, 64, 64, 3), np.uint8)
    imgs[: N // 2, 16:48, 16:48] = 255  # half structured, so the logits spread
    sid = np.zeros((N,), np.int32)
    jds = JDataset(JMixture(images=imgs, source_id=sid, labels=np.zeros((N,), np.int64)))
    pds = DeviceDataset(Mixture(images=imgs, source_id=sid, labels=np.zeros((N,), np.int64)),
                        "cpu")
    dp = dict(state.d_params)
    dp["Conv2dTorch_4"] = jax.tree.map(lambda x: x * AMPLIFY, dp["Conv2dTorch_4"])
    state = state.replace(d_params=jax.device_put(dp))
    td = bridge.load_dcgan_from_flax(Discriminator64(WIDTH),
                                     jax.tree.map(np.asarray, state.d_params),
                                     jax.tree.map(np.asarray, state.d_stats))
    return disc, state, jds, td, pds


def _jax_f32(setup, ratio, keep):
    disc, state, jds, _, _ = setup
    subset = None if keep.all() else jnp.asarray(np.nonzero(keep)[0], jnp.int32)
    losses = JSC.score_d_losses(disc, state.d_params, state.d_stats, jds,
                                batch_size=BATCH, subset=subset)
    if subset is not None:
        losses = jnp.full((N,), jnp.inf, jnp.float32).at[subset].set(losses)
    mask, thr = JTH.percentile_refine_mask(losses, ratio, valid=jnp.asarray(keep))
    return np.asarray(mask), float(thr), np.asarray(losses)


def _port_f32(td, pds, ratio, keep):
    subset = None if keep.all() else torch.from_numpy(np.nonzero(keep)[0])
    losses = SC.score_d_losses(td, pds, batch_size=BATCH, subset=subset)
    if subset is not None:
        losses = torch.full((N,), float("inf")).index_put_((subset,), losses)
    return TH.percentile_refine_mask(losses, ratio, valid=torch.from_numpy(keep))


def _margin(losses, thr, keep):
    d = np.abs(losses[keep].astype(np.float64) - thr)
    return float(np.min(d[d > 0]))


@pytest.mark.parametrize("ratio,subset", [(0.2, False), (0.5, False), (0.8, False),
                                          (1.0, False), (0.3, True), (1.0, True)])
def test_band_mask_equals_f32_masks(setup, ratio, subset):
    _, _, _, td, pds = setup
    keep = np.ones((N,), bool)
    if subset:
        keep[::3] = False  # a base that dropped a third for good
    jmask, jthr, jl = _jax_f32(setup, ratio, keep)
    fmask, fthr = _port_f32(td, pds, ratio, keep)
    sub = None if keep.all() else torch.from_numpy(np.nonzero(keep)[0])
    mask, thr, scores, stats = SC.fused_percentile_refine(
        td, pds, ratio, torch.from_numpy(keep), batch_size=BATCH, subset=sub)
    n_rescored, fell_back, drift = stats.tolist()
    print(f"ratio {ratio}, subset {subset}: kept {int(mask.sum())}/{keep.sum()}, "
          f"re-scored {n_rescored:.0f}, drift {drift:.3g}, threshold {float(thr):.8g} "
          f"(JAX {jthr:.8g}), nearest margin {_margin(jl, jthr, keep):.3g}")
    assert fell_back == 0.0
    assert 0.0 < drift <= 0.05 / 2, "the bulk must be bf16, and inside the half-band"
    assert 0 < n_rescored < 0.25 * keep.sum()
    np.testing.assert_array_equal(mask.numpy(), fmask.numpy())
    assert float(thr) == float(fthr)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_allclose(float(thr), jthr, rtol=1e-5)
    assert not mask.numpy()[~keep].any() and np.isposinf(scores.numpy()[~keep]).all()
    if ratio == 1.0:  # every loss >= the minimum: the empty-keep fallback's median half
        assert int(mask.sum()) == keep.sum() // 2


@pytest.mark.parametrize("band_eps,frac", [(1e9, 0.125), (1e9, 1e-4)])
def test_band_overflow_falls_back_to_f32(setup, band_eps, frac):
    """A band over its capacity (at least 256 samples, so here the band
    must be the whole set) takes the float32 pass: same mask, the float32
    losses bit for bit."""
    _, _, _, td, pds = setup
    keep = np.ones((N,), bool)
    fmask, fthr = _port_f32(td, pds, 0.4, keep)
    f_losses = SC.score_d_losses(td, pds, batch_size=BATCH)
    mask, thr, scores, stats = SC.fused_percentile_refine(
        td, pds, 0.4, torch.from_numpy(keep), batch_size=BATCH,
        band_eps=band_eps, band_capacity_frac=frac)
    assert stats[1].item() == 1.0 and stats[2].item() == 0.0
    assert SC.band_capacity(N, BATCH, frac) == 256
    np.testing.assert_array_equal(mask.numpy(), fmask.numpy())
    assert float(thr) == float(fthr)
    assert torch.equal(scores, f_losses)


def test_band_capacity_as_jax():
    """``min(m, max(256, int(m * frac)))`` in whole batches (`score.py:210-211`)."""
    assert SC.band_capacity(70_000, 512, 0.0625) == 4608
    assert SC.band_capacity(1000, 512, 0.0625) == 512
    assert SC.band_capacity(100, 64, 0.0625) == 128


def _tiny_final(**strain):
    cfg = get_preset("final")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=16),
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8),
        train=dataclasses.replace(cfg.train, epochs=3, log_every=0, sample_every=0),
        strain=dataclasses.replace(cfg.strain, start_epoch=0, prefilter=False,
                                   score_batch=64, **strain),
    )


def test_band_overflow_cooloff():
    """A weakly separating D (random init: every loss about 0.693) puts the
    whole set in the band, which overflows; the Trainer's stats fetch sees
    it and puts the engine on 5 strain events of float32 scoring
    (`tests/test_band_scoring.py:123-150`)."""
    tr = Trainer(_tiny_final(), device="cpu", max_synth=220)
    tr.setup()
    tr.run_epoch(0)
    assert tr.engine.last_score_path == "band"
    assert tr.engine.last_band_stats[1].item() == 1.0
    assert tr.engine.band_cooloff == 5
    tr.run_epoch(1)
    assert tr.engine.last_score_path == "f32"
    assert tr.engine.band_cooloff == 4
    assert tr.engine.last_band_stats is None
    assert len(tr.mask_history) == 2


@pytest.fixture(scope="module")
def feature_fns():
    from strainer_gan_tpu.models.resnet import load_torch_resnet_state_dict, resnet18_features
    from strainer_gan_tpu.models.synth_weights import synth_resnet_state_dict
    from strainer_gan_tpu_torch.models.features import build_feature_fn

    fmodel = resnet18_features(3)
    fvars = jax.jit(lambda k, a: fmodel.init({"params": k}, a))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    fvars = jax.tree.map(jnp.asarray, load_torch_resnet_state_dict(
        fvars, synth_resnet_state_dict(fvars)))
    jfeat = jax.jit(lambda x: fmodel.apply(fvars, x, train=False))
    return jfeat, build_feature_fn(device="cpu")


def test_zscore_loss_engine_matches_jax(setup, feature_fns):
    """``zscore_loss``: the elbow prefilter, then the epoch-3 loss strain
    (loss_ratio 0.2) from its base; the port scores by the band path, the
    JAX engine in float32.  Masks identical; the elbow threshold to 1e-4
    (max-|z| agree to 1e-4, as in tests/test_torch_zscore_slice.py), the
    loss threshold to rtol 1e-5."""
    from strainer_gan_tpu.data import build_mixture as jax_mixture
    from strainer_gan_tpu.strain.engine import StrainerEngine as JEngine
    from strainer_gan_tpu_torch.data import build_mixture
    from strainer_gan_tpu_torch.strain.engine import StrainerEngine

    disc, state, _, td, _ = setup
    jcfg, pcfg = jax_preset("zscore_loss"), get_preset("zscore_loss")
    jcfg = jcfg.replace(strain=dataclasses.replace(jcfg.strain, score_precision="f32"))
    assert pcfg.strain.score_precision == "band_bf16" and pcfg.strain.z_threshold is None
    jds = JDataset(jax_mixture(jcfg.data, max_synth=150))
    pds = DeviceDataset(build_mixture(pcfg.data, max_synth=150), "cpu")
    jfeat, pfeat = feature_fns
    jeng = JEngine(jcfg, disc, jds, feature_fn=jfeat, score_batch=64)
    peng = StrainerEngine(pcfg, td, pds, feature_fn=pfeat, score_batch=64)

    jbase = np.asarray(jeng.prefilter(jax.random.PRNGKey(2)))
    pbase = peng.prefilter().numpy()
    print(f"elbow prefilter: kept {pbase.sum()}/{pbase.size}, threshold "
          f"{float(peng.last_threshold):.8g} (JAX {float(jeng.last_threshold):.8g})")
    np.testing.assert_array_equal(pbase, jbase)
    np.testing.assert_allclose(float(peng.last_threshold), float(jeng.last_threshold),
                               rtol=1e-4)
    assert 0 < pbase.sum() < pbase.size
    assert torch.equal(peng.last_mask, peng.base_active)

    for e in (0, 2):
        assert peng.on_epoch_start(e) is peng.active
    jmask = np.asarray(jeng.on_epoch_start(3, state, jax.random.PRNGKey(5)))
    pmask = peng.on_epoch_start(3).numpy()
    n_rescored, fell_back, drift = peng.last_band_stats.tolist()
    jl = np.asarray(jeng.last_scores)
    print(f"epoch 3: kept {pmask.sum()}/{pbase.sum()}, re-scored {n_rescored:.0f}, "
          f"drift {drift:.3g}, threshold {float(peng.last_threshold):.8g} "
          f"(JAX {float(jeng.last_threshold):.8g}), nearest margin "
          f"{_margin(jl, float(jeng.last_threshold), pbase):.3g}")
    assert peng.last_score_path == "band" and fell_back == 0.0 and drift > 0.0
    np.testing.assert_array_equal(pmask, jmask)
    np.testing.assert_allclose(float(peng.last_threshold), float(jeng.last_threshold),
                               rtol=1e-5)
    assert 0 < pmask.sum() < pbase.sum() and not pmask[~pbase].any()
    assert torch.equal(peng.last_mask, peng.active)
