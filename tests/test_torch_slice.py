"""The port's ``final`` slice against the JAX package (CPU, small size).

* The synthetic mixture is byte-identical, and the epoch sampler gives the
  same batches from the same permutation.
* Prefilter: the same images through the same ResNet18 weights (synthetic,
  `models/synth_weights.py`) and the z-score threshold give an identical
  mask.
* Then both packages take K D-first steps with the same indices and noise,
  and the loss-percentile refinement at epoch 3 (clean ratio 0.8, the
  ``final_py_ratio_inversion`` quirk) runs in each package's
  ``StrainerEngine`` on the same D weights (JAX's, carried over): the masks
  must be identical.  Each mask check prints the nearest score's margin
  to its threshold, so a near-tie would be visible rather than hidden.
* ``Trainer(device="cpu")`` runs four tiny epochs end to end.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.data import DeviceDataset as JDataset, build_mixture as jax_mixture
from strainer_gan_tpu.data.pipeline import epoch_batch_indices as jax_epoch_indices
from strainer_gan_tpu.models import Discriminator64 as JDisc, Generator64 as JGen
from strainer_gan_tpu.models.resnet import load_torch_resnet_state_dict, resnet18_features
from strainer_gan_tpu.models.synth_weights import synth_resnet_state_dict
from strainer_gan_tpu.strain.engine import StrainerEngine as JEngine
from strainer_gan_tpu.train.loop import step_config_from as jax_step_config
from strainer_gan_tpu.train.state import create_state
from strainer_gan_tpu.train.steps import make_train_step

from strainer_gan_tpu_torch import bridge, device as port_device, get_preset
from strainer_gan_tpu_torch.data import DeviceDataset, build_mixture, epoch_batch_indices
from strainer_gan_tpu_torch.data import normalize_u8
from strainer_gan_tpu_torch.models import Discriminator64, Generator64
from strainer_gan_tpu_torch.models.features import build_feature_fn
from strainer_gan_tpu_torch.strain.engine import StrainerEngine
from strainer_gan_tpu_torch.train.loop import Trainer
from strainer_gan_tpu_torch.train.state import make_optimizers
from strainer_gan_tpu_torch.train.steps import step_config_from, train_step

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

WIDTH, B, MAX_SYNTH, K_STEPS = 8, 8, 32, 3


def _tiny(cfg, **train_kw):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=B),
        model=dataclasses.replace(cfg.model, ngf=WIDTH, ndf=WIDTH, compute_dtype="float32"),
        strain=dataclasses.replace(cfg.strain, score_precision="f32", score_batch=16),
        train=dataclasses.replace(cfg.train, **train_kw),
    )


def test_mixture_is_byte_identical():
    jm = jax_mixture(jax_preset("final").data, max_synth=MAX_SYNTH)
    pm = build_mixture(get_preset("final").data, max_synth=MAX_SYNTH)
    assert pm.images.shape == (2 * MAX_SYNTH, 64, 64, 3)
    np.testing.assert_array_equal(pm.images, jm.images)
    np.testing.assert_array_equal(pm.source_id, jm.source_id)
    np.testing.assert_array_equal(pm.labels, jm.labels)


@pytest.mark.parametrize("num", [5, 7])  # 7 rows of 8 wrap past the 40 actives
def test_epoch_indices_match_jax_sampler(num):
    rng = np.random.default_rng(4)
    active = rng.uniform(size=50) < 0.8
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_epoch_indices(key, jnp.asarray(active), num, B))
    # the JAX sampler's permutation: its random bits, stably sorted
    bits = np.asarray(jax.random.bits(key, (50,), jnp.uint32) >> jnp.uint32(1))
    perm = torch.from_numpy(np.argsort(bits, kind="stable"))
    got = epoch_batch_indices(torch.from_numpy(active), num, B, perm=perm)
    np.testing.assert_array_equal(got.numpy(), want)


def _margin(scores, thr, valid):
    """Nearest distance of a score to the threshold, leaving out the score
    the percentile threshold interpolates AT (it equals the threshold on
    each side by construction and is dropped by the strict ``<``)."""
    d = np.abs(np.asarray(scores)[np.asarray(valid)] - float(thr))
    return float(np.min(d[d > 0]))


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = _tiny(jax_preset("final"))
    pcfg = _tiny(get_preset("final"))
    mixture = jax_mixture(jcfg.data, max_synth=MAX_SYNTH)
    jds = JDataset(mixture)
    pds = DeviceDataset(build_mixture(pcfg.data, max_synth=MAX_SYNTH), "cpu")

    fmodel = resnet18_features(3)
    fvars = jax.jit(lambda k, a: fmodel.init({"params": k}, a))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    fvars = jax.tree.map(jnp.asarray, load_torch_resnet_state_dict(
        fvars, synth_resnet_state_dict(fvars)))
    jfeat = jax.jit(lambda x: fmodel.apply(fvars, x, train=False))

    gen = JGen(nz=100, ngf=WIDTH, compute_dtype=jnp.float32)
    disc = JDisc(ndf=WIDTH, compute_dtype=jnp.float32)
    state = jax.jit(lambda k: create_state(jcfg, gen, disc, k))(jax.random.PRNGKey(1))
    jeng = JEngine(jcfg, disc, jds, feature_fn=jfeat, score_batch=16)

    tg = bridge.load_dcgan_from_flax(Generator64(100, WIDTH),
                                     jax.tree.map(np.asarray, state.g_params),
                                     jax.tree.map(np.asarray, state.g_stats))
    td = bridge.load_dcgan_from_flax(Discriminator64(WIDTH),
                                     jax.tree.map(np.asarray, state.d_params),
                                     jax.tree.map(np.asarray, state.d_stats))
    peng = StrainerEngine(pcfg, td, pds, feature_fn=build_feature_fn(device="cpu"),
                          score_batch=16)
    return dict(jcfg=jcfg, pcfg=pcfg, jds=jds, pds=pds, gen=gen, disc=disc, state=state,
                jeng=jeng, tg=tg, td=td, peng=peng)


def test_slice_masks_match_jax(slice_setup):
    s = slice_setup
    jeng, peng, jcfg = s["jeng"], s["peng"], s["jcfg"]

    # ---- prefilter (z-score on ResNet18 features, threshold 5.0)
    jmask = np.asarray(jeng.prefilter(jax.random.PRNGKey(2)))
    pmask = peng.prefilter().numpy()
    jz, pz = np.asarray(jeng.last_scores), peng.last_scores.numpy()
    print(f"prefilter: kept {pmask.sum()}/{pmask.size}, max|z| max |diff| "
          f"{np.abs(pz - jz).max():.3g}, nearest margin to {jcfg.strain.z_threshold}: "
          f"{_margin(jz, jcfg.strain.z_threshold, np.ones_like(jmask)):.3g}")
    # the features agree to 1e-5 of their scale (test_torch_models.py); z
    # divides their difference by a column's std, which is smaller
    np.testing.assert_allclose(pz, jz, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(pmask, jmask)
    assert 0 < pmask.sum() < pmask.size

    # ---- K D-first steps, same indices and noise on both sides
    state = s["state"]
    jstep = make_train_step(s["gen"], s["disc"], jax_step_config(jcfg), donate=False)
    opt_g, opt_d = make_optimizers(s["pcfg"], s["tg"], s["td"])
    idx = np.asarray(jax_epoch_indices(jax.random.PRNGKey(3), jnp.asarray(jmask), K_STEPS, B))
    keys = jax.random.split(jax.random.PRNGKey(4), K_STEPS)
    images, src = s["jds"].images, s["jds"].source_id
    for i in range(K_STEPS):
        z = np.array(jax.random.normal(jax.random.split(keys[i], 6)[0], (B, 100)))
        state, jm = jstep(state, images[idx[i]], src[idx[i]], keys[i], jcfg.train.lr_g,
                          jcfg.train.lr_d, False, jnp.asarray(False), None, True)
        ids = torch.from_numpy(idx[i].astype(np.int64))
        pm = train_step(s["tg"], s["td"], opt_g, opt_d, normalize_u8(s["pds"].gather(ids)),
                        s["pds"].source_id[ids], torch.from_numpy(z), jcfg.train.lr_g,
                        jcfg.train.lr_d, step_config_from(s["pcfg"]))
        # the per-step comparison at 1e-4 is tests/test_torch_step.py's; here
        # a sanity bound on the K-step sequence
        np.testing.assert_allclose(float(pm["errD"]), float(jm["errD"]), rtol=1e-3)

    # ---- epoch-3 loss-percentile refinement on the carried-over D weights
    bridge.load_dcgan_from_flax(s["td"], jax.tree.map(np.asarray, state.d_params),
                                jax.tree.map(np.asarray, state.d_stats))
    jmask3 = np.asarray(jeng.on_epoch_start(3, state, jax.random.PRNGKey(5)))
    pmask3 = peng.on_epoch_start(3).numpy()
    jl, pl_ = np.asarray(jeng.last_scores), peng.last_scores.numpy()
    base = pmask
    print(f"epoch 3: kept {pmask3.sum()}/{base.sum()}, threshold "
          f"{float(peng.last_threshold):.6g}, loss max |diff| "
          f"{np.abs(pl_[base] - jl[base]).max():.3g}, nearest margin: "
          f"{_margin(jl, jeng.last_threshold, base):.3g}")
    np.testing.assert_allclose(pl_[base], jl[base], rtol=1e-5, atol=1e-6)
    assert np.all(np.isinf(pl_[~base])) and np.all(np.isinf(jl[~base]))
    np.testing.assert_allclose(float(peng.last_threshold), float(jeng.last_threshold),
                               rtol=1e-5)
    np.testing.assert_array_equal(pmask3, jmask3)
    assert 0 < pmask3.sum() < base.sum() and not pmask3[~base].any()
    assert peng.d_bn_eval and jeng.d_bn_eval


def test_trainer_cpu_four_epochs(capsys):
    cfg = _tiny(get_preset("final"), epochs=4, log_every=3)
    tr = Trainer(cfg, device="cpu", max_synth=MAX_SYNTH)
    out = tr.run()
    text = capsys.readouterr().out
    assert [o["lr_d"] for o in out] == [1e-4, 1e-4, 1e-4, 1e-5]  # LR cut at epoch 3
    assert "[0/4][0/7]\tLoss_D: " in text and "D(G(z)): " in text
    assert f"Epoch 3: Removed {tr.dataset.n - out[3]['active']} outliers." in text
    assert len(tr.mask_history) == 4
    base, refined = tr.mask_history[0], tr.mask_history[3]
    assert 0 < refined.sum() < base.sum() and not refined[~base].any()
    assert all(np.isfinite(x) for x in tr.logger.D_losses + tr.logger.G_losses)
    # CPU tensors take the plain versions: no kernel launched
    assert tr.kernel_launches == {"bce_scores": 0, "zscore_column_stats": 0,
                                  "zscore_row_max": 0, "neighbor_counts": 0}


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError):
        Trainer(_tiny(get_preset("final")), max_synth=4)
