"""The fake pool and its sources against the JAX package (CPU).

* ``StrainerEngine.outlier_mask`` (the complement of the fixed z-score
  mask, K2 on the features) equals the JAX engine's exactly on the same
  features, at a preset's threshold and at the 5.0 taken when there is
  none.
* ``strain/pool.py::build_fake_pool`` with the JAX package's permutation
  injected gives the JAX pool byte for byte: with more outliers than the
  pool's ``num`` rows, and with fewer (the pool wraps around them).
* The synthetic ``anime`` source and the ``_CELEBA_ANIME`` mixture
  (``combined``: CelebA-like, then anime-like, in order) are byte-equal to
  the JAX package's: images, ``source_id`` and labels.
* A checkpoint round trip restores the pool, in place in a Trainer that
  already has one, and bit-equal.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.data import DeviceDataset as JDataset, build_mixture as jax_mixture
from strainer_gan_tpu.data import datasets as JD
from strainer_gan_tpu.data.mixers import Mixture as JMixture
from strainer_gan_tpu.strain.engine import StrainerEngine as JEngine
from strainer_gan_tpu.strain.pool import build_fake_pool as jax_build_fake_pool

from strainer_gan_tpu_torch import get_preset
from strainer_gan_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from strainer_gan_tpu_torch.data import DeviceDataset, build_mixture
from strainer_gan_tpu_torch.data import datasets as PD
from strainer_gan_tpu_torch.data.mixers import Mixture
from strainer_gan_tpu_torch.strain.engine import StrainerEngine
from strainer_gan_tpu_torch.strain.pool import build_fake_pool
from strainer_gan_tpu_torch.train.loop import Trainer

N, D = 600, 512


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(n_outliers, seed=3):
    """ResNet-like features, ``n_outliers`` rows pushed far out in a few
    columns."""
    rng = np.random.default_rng(seed)
    f = np.abs(rng.standard_normal((N, D))).astype(np.float32)
    rows = rng.choice(N, n_outliers, replace=False)
    f[rows, rng.integers(0, D, n_outliers)] += 40.0
    return f


def _images(seed=5):
    return np.random.default_rng(seed).integers(0, 256, (N, 8, 8, 3), dtype=np.uint8)


def _engines(preset, feats):
    jcfg, pcfg = jax_preset(preset), get_preset(preset)
    imgs = _images()
    src = np.zeros(N, np.int32)
    jds = JDataset(JMixture(imgs, src, src))
    pds = DeviceDataset(Mixture(imgs, src, src), "cpu")
    jeng = JEngine(jcfg, None, jds)
    jeng._features = jnp.asarray(feats)
    peng = StrainerEngine(pcfg, None, pds)
    peng._features = torch.from_numpy(feats)
    return jeng, peng, jds, pds


@pytest.mark.parametrize("z_threshold", [5.0, None])
def test_outlier_mask_matches_jax(z_threshold):
    feats = _features(90)
    jeng, peng, _, _ = _engines("loss_concat_fast", feats)
    for eng in (jeng, peng):
        eng.sc = dataclasses.replace(eng.sc, z_threshold=z_threshold)
    want = np.asarray(jeng.outlier_mask())
    got = peng.outlier_mask().numpy()
    np.testing.assert_array_equal(got, want)
    assert 80 <= want.sum() <= 120, int(want.sum())


@pytest.mark.parametrize("n_outliers", [90, 20], ids=["enough", "wrapping"])
def test_pool_matches_jax_bytes(n_outliers):
    feats = _features(n_outliers)
    jeng, peng, jds, pds = _engines("loss_concat_fast", feats)
    jmask, pmask = jeng.outlier_mask(), peng.outlier_mask()
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax_build_fake_pool(jds, jmask, 0.1, key))
    perm = torch.from_numpy(np.asarray(jax.random.permutation(key, N)).astype(np.int64))
    got = build_fake_pool(pds, pmask, 0.1, perm=perm).numpy()
    assert got.shape == want.shape == (60, 8, 8, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    n_out = int(pmask.sum())
    # every pool image is an outlier's; with fewer outliers than rows, each
    # appears again after the last
    pool_rows = {bytes(r) for r in got}
    out_rows = {bytes(r) for r in _images()[pmask.numpy()]}
    assert pool_rows <= out_rows and len(pool_rows) == min(n_out, 60)


def test_anime_source_matches_jax():
    from strainer_gan_tpu.config import SourceSpec as JSpec
    from strainer_gan_tpu_torch.config import SourceSpec

    a = JD.load_source(JSpec("anime"), 64, 3, 1000, max_synth=300)
    b = PD.load_source(SourceSpec("anime"), 64, 3, 1000, max_synth=300)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert PD._SYNTH_SIZES["anime"] == JD._SYNTH_SIZES["anime"] == 6000


@pytest.mark.parametrize("preset", ["strainer_gan", "loss_concat_fast"])
def test_celeba_anime_mixture_matches_jax(preset):
    jdata, pdata = jax_preset(preset).data, get_preset(preset).data
    assert jdata.mixer == pdata.mixer == "combined" and not pdata.drop_last
    a = jax_mixture(jdata, max_synth=200)
    b = build_mixture(pdata, max_synth=200)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.source_id, b.source_id)
    np.testing.assert_array_equal(a.labels, b.labels)
    # in order: the CelebA-like source, then the anime-like one
    np.testing.assert_array_equal(b.source_id, np.repeat([0, 1], 200))


def test_checkpoint_keeps_the_pool(tmp_path):
    cfg = get_preset("strainer_concat_fast")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=8),
                      model=dataclasses.replace(cfg.model, ngf=8, ndf=8),
                      train=dataclasses.replace(cfg.train, epochs=1, sample_every=0,
                                                steps_per_dispatch=1))
    tr = Trainer(cfg, device="cpu", max_synth=24)
    tr.setup()
    assert tr.fake_pool.shape == (4, 64, 64, 3)  # int(48 * 0.1) rows
    tr.run_epoch(0)
    save_checkpoint(str(tmp_path / "ck"), tr, 0)
    saved = tr.fake_pool.clone()
    draws = tr.pool_rng.get_state()

    fresh = Trainer(cfg, device="cpu", max_synth=24)
    fresh.setup()
    fresh.fake_pool.zero_()  # not the saved bytes before the restore
    ptr = fresh.fake_pool.data_ptr()
    assert restore_checkpoint(str(tmp_path / "ck"), fresh) == 1
    assert fresh.fake_pool.data_ptr() == ptr  # in place
    assert torch.equal(fresh.fake_pool, saved)
    assert torch.equal(fresh.pool_rng.get_state(), draws)
