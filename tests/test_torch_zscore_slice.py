"""The port's z-score strainer family against the JAX package (CPU, small).

Both packages' ``StrainerEngine`` score the same synthetic mixture (300
images of the presets' CelebA + CIFAR stand-ins) through ResNet18 with the
same synthetic weights (`models/synth_weights.py`):

* ``zscore_dbscan``: the prefilter's DBSCAN clean ratio, quantile threshold
  and inclusive mask;
* ``zscore_elbow``: the prefilter's histogram-elbow threshold and mask;
* ``zscore``: nothing before epoch 3, then the fixed z < 5 strain once.

Masks and clean ratios must be identical.  The features agree to 1e-5 of
their scale (tests/test_torch_models.py), so the max-|z| scores, and the
thresholds taken from them, agree at 1e-4 (as in tests/test_torch_slice.py);
each threshold must also equal, bit for bit, the JAX package's threshold
function applied to the port's own scores.  Each check prints the nearest
score's margin to its threshold, so a near-tie would show.

DBSCAN's eps comes from the data as tests/test_golden_feature_strainers.py
takes it (a quantile of the standardised features' pair distances, so the
clean ratio is interior), moved to the nearest value with no pair distance
within 1e-5 of it (relative), a hundred times the float32 rounding of a
distance, so rounding cannot decide a pair.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.data import DeviceDataset as JDataset, build_mixture as jax_mixture
from strainer_gan_tpu.models.resnet import load_torch_resnet_state_dict, resnet18_features
from strainer_gan_tpu.models.synth_weights import synth_resnet_state_dict
from strainer_gan_tpu.ops import stats as JS
from strainer_gan_tpu.strain import thresholds as JTH
from strainer_gan_tpu.strain.engine import StrainerEngine as JEngine

from strainer_gan_tpu_torch import get_preset
from strainer_gan_tpu_torch.data import DeviceDataset, build_mixture
from strainer_gan_tpu_torch.models.features import build_feature_fn
from strainer_gan_tpu_torch.strain.engine import StrainerEngine

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MAX_SYNTH = 150


def _margin(scores, thr):
    d = np.abs(np.asarray(scores, np.float64) - float(thr))
    return float(np.min(d[d > 0])) if np.any(d > 0) else 0.0


def _clear_eps(f, q=0.2, band=1e-5):
    """eps at the q-quantile of the pair distances of StandardScaler(f),
    moved up to the first gap with no distance within ``band`` of it."""
    s = (f - f.mean(0)) / np.where(f.std(0) == 0, 1.0, f.std(0))
    d = np.sqrt(np.maximum(((s[:, None] - s[None, :]) ** 2).sum(-1), 0.0))
    pairs = np.sort(d[np.triu_indices(len(d), 1)])
    i = int(q * len(pairs))
    while pairs[i + 1] <= pairs[i] * (1 + 3 * band):
        i += 1
    eps = float(np.sqrt(pairs[i] * pairs[i + 1]))
    assert not np.any(np.abs(d - eps) <= band * eps)
    return eps


@pytest.fixture(scope="module")
def feature_fns():
    fmodel = resnet18_features(3)
    fvars = jax.jit(lambda k, a: fmodel.init({"params": k}, a))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    fvars = jax.tree.map(jnp.asarray, load_torch_resnet_state_dict(
        fvars, synth_resnet_state_dict(fvars)))
    jfeat = jax.jit(lambda x: fmodel.apply(fvars, x, train=False))
    return jfeat, build_feature_fn(device="cpu")


def _engines(name, feature_fns, features=None):
    """Both packages' engines for a preset; ``features`` (JAX's, the
    port's), when given, stand in for the engines' own feature pass."""
    jcfg, pcfg = jax_preset(name), get_preset(name)
    jcfg = jcfg.replace(strain=dataclasses.replace(jcfg.strain, score_batch=64))
    pcfg = pcfg.replace(strain=dataclasses.replace(pcfg.strain, score_batch=64))
    jds = JDataset(jax_mixture(jcfg.data, max_synth=MAX_SYNTH))
    pds = DeviceDataset(build_mixture(pcfg.data, max_synth=MAX_SYNTH), "cpu")
    np.testing.assert_array_equal(pds.images.numpy(), np.asarray(jds.images))
    jfeat, pfeat = feature_fns
    jeng = JEngine(jcfg, None, jds, feature_fn=jfeat, score_batch=64)
    peng = StrainerEngine(pcfg, None, pds, feature_fn=pfeat, score_batch=64)
    if features is not None:
        jeng._features, peng._features = features
    return jeng, peng


@pytest.fixture(scope="module")
def dbscan_engines(feature_fns):
    """zscore_dbscan's engines with their features computed (by each
    engine's own feature pass) and eps taken from JAX's."""
    jeng, peng = _engines("zscore_dbscan", feature_fns)
    eps = _clear_eps(np.asarray(jeng._features_full(), np.float64))
    peng._features_full()
    for eng in (jeng, peng):
        eng.sc = dataclasses.replace(eng.sc, dbscan_eps=eps)
    return jeng, peng, eps


@pytest.fixture(scope="module")
def features(dbscan_engines):
    # the three presets' mixtures are the same at this size (the CIFAR
    # count of 20,000 exceeds the 150 images made)
    jeng, peng, _ = dbscan_engines
    return jeng._features, peng._features


def _check_scores(jeng, peng):
    jz, pz = np.asarray(jeng.last_scores), peng.last_scores.numpy()
    np.testing.assert_allclose(pz, jz, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(peng.last_threshold), float(jeng.last_threshold),
                               rtol=1e-4)
    return pz


def test_zscore_dbscan_prefilter_matches_jax(dbscan_engines):
    jeng, peng, eps = dbscan_engines
    jmask = np.asarray(jeng.prefilter(jax.random.PRNGKey(1)))
    pmask = peng.prefilter().numpy()
    ratio_j = float(JTH.dbscan_clean_ratio(jeng._features, eps, 3))
    ratio_p = peng.last_clean_ratio
    assert float(ratio_p) == ratio_j and 0.05 < ratio_j < 0.95
    pz = _check_scores(jeng, peng)
    # the threshold is the JAX quantile of the port's own scores, exactly
    want = np.asarray(JS.quantile(jnp.asarray(pz), jnp.float32(ratio_p)))
    assert peng.last_threshold.numpy().tobytes() == want.tobytes()
    print(f"zscore_dbscan: eps {eps:.6g}, ratio {ratio_j:.6g}, kept {pmask.sum()}/"
          f"{pmask.size}, threshold {float(peng.last_threshold):.6g}, nearest margin "
          f"{_margin(pz, peng.last_threshold):.3g}")
    np.testing.assert_array_equal(pmask, jmask)
    np.testing.assert_array_equal(pmask, pz <= peng.last_threshold.numpy())
    assert 0 < pmask.sum() < pmask.size
    assert np.array_equal(peng.base_active.numpy(), pmask)


def test_zscore_elbow_prefilter_matches_jax(feature_fns, features):
    jeng, peng = _engines("zscore_elbow", feature_fns, features)
    jmask = np.asarray(jeng.prefilter(jax.random.PRNGKey(1)))
    pmask = peng.prefilter().numpy()
    pz = _check_scores(jeng, peng)
    want = np.asarray(JS.elbow_threshold(jnp.asarray(pz))[0])
    assert peng.last_threshold.numpy().tobytes() == want.tobytes()
    print(f"zscore_elbow: kept {pmask.sum()}/{pmask.size}, threshold "
          f"{float(peng.last_threshold):.6g}, nearest margin "
          f"{_margin(pz, peng.last_threshold):.3g}")
    np.testing.assert_array_equal(pmask, jmask)
    assert 0 < pmask.sum() < pmask.size


def test_zscore_fixed_strains_once_at_epoch_3(feature_fns, features):
    jeng, peng = _engines("zscore", feature_fns, features)
    assert bool(peng.prefilter().all())  # no prefilter: all kept
    for epoch in range(3):
        assert bool(peng.on_epoch_start(epoch).all())
    jmask = np.asarray(jeng.on_epoch_start(3, None, jax.random.PRNGKey(2)))
    pmask = peng.on_epoch_start(3).numpy()
    pz = _check_scores(jeng, peng)
    print(f"zscore: kept {pmask.sum()}/{pmask.size} at z < 5, nearest margin "
          f"{_margin(pz, 5.0):.3g}")
    np.testing.assert_array_equal(pmask, jmask)
    assert 0 < pmask.sum() < pmask.size
    # once: epoch 4 keeps the same mask, and it is the new base
    assert peng.on_epoch_start(4) is peng.active
    assert np.array_equal(peng.base_active.numpy(), pmask)


@pytest.mark.parametrize("name,epochs", [("zscore_dbscan", 1), ("zscore", 2)])
def test_trainer_cpu_runs_the_zscore_presets(name, epochs, capsys):
    from strainer_gan_tpu_torch.train.loop import Trainer

    cfg = get_preset(name)
    start = 1 if name == "zscore" else cfg.strain.start_epoch  # zscore's strain, sooner
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=8),
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, compute_dtype="float32"),
        strain=dataclasses.replace(cfg.strain, score_batch=32, start_epoch=start),
        train=dataclasses.replace(cfg.train, epochs=epochs, log_every=4))
    tr = Trainer(cfg, device="cpu", max_synth=32)
    out = tr.run()
    text = capsys.readouterr().out
    strain_epoch = 0 if cfg.strain.prefilter else cfg.strain.start_epoch
    kept = tr.mask_history[strain_epoch]
    assert 0 < kept.sum() <= tr.dataset.n and out[-1]["active"] == kept.sum()
    assert all(m.all() for m in tr.mask_history[:strain_epoch])
    if cfg.strain.prefilter:
        # as in the JAX package: the prefilter is no strain event, so no
        # console line and no strain-quality record
        assert "Removed" not in text and tr.strain_quality == []
    else:
        assert f"Epoch {strain_epoch}: Removed {tr.dataset.n - kept.sum()} outliers." in text
        assert [q["epoch"] for q in tr.strain_quality] == (
            [strain_epoch] if kept.sum() < 64 else [])
    assert all(np.isfinite(x) for x in tr.logger.D_losses + tr.logger.G_losses)
    # CPU tensors take the plain versions: no kernel launched
    assert set(tr.kernel_launches.values()) == {0}
