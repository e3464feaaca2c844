"""The autoencoder strainer against the JAX package (CPU, small).

* The AE's forward with weights bridged from flax (biased convolutions and
  transposed convolutions with ``output_padding``) within 1e-5 of JAX's.
* ``reconstruction_errors`` and ``ae_error_mask`` (mean + 2 sigma, Bessel)
  on the same inputs: errors within 1e-6 (relative), the threshold within
  1e-6, no flipped decision.
* Training steps: five steps of the JAX engine's AE step (Adam 1e-3 on the
  weighted MSE, `strainer_gan_tpu/strain/engine.py:313-334`, built here as
  the engine builds it) against the port's ``ae_train_step`` on the same
  batches, the fifth a partial tail of 5 lanes: the loss within 1e-6, the
  weights and Adam moments within atol 1e-5, rtol 1e-4 after every step.
  Between steps the port takes JAX's weights and moments: Adam divides by
  the root of the second moment, so elements with a small one amplify the
  float32 noise of their gradient (5 of 432 first-layer kernel elements
  moved by up to 9e-5, against lr 1e-3, after five free-running steps);
  those elements (printed) are held to |update| <= 3 lr, by the
  sensitivity rule of tests/test_torch_batch_mask.py.
* The training loop: ``_train_autoencoder`` steps through the JAX engine's
  batches in order, with the tail's weights on the last step of each AE
  epoch (injected draws through ``StrainerEngine.build_ae`` and
  ``ae_epoch_indices``).
* The ``autoencoder`` preset's engine over epochs 0-3 against the JAX
  engine: nothing before epoch 3, then the AE trained at 3 (the JAX
  engine's weights handed to the port, since 35 free-running steps drift
  apart as above) scores every image: the errors within 1e-5 (relative),
  the threshold within 1e-5, the mask equal; the parity report against the
  numpy oracle is 1.0.
* A checkpoint after the AE exists (``has_ae``) restores its weights, and
  the restored Trainer's next strain equals the uninterrupted one's.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu import config as JC
from strainer_gan_tpu.data import DeviceDataset as JDataset, build_mixture as jax_mixture
from strainer_gan_tpu.models.autoencoder import ConvAutoEncoder as JAE
from strainer_gan_tpu.models.autoencoder import reconstruction_errors as jax_errors
from strainer_gan_tpu.strain import engine as JE, thresholds as JTH

from strainer_gan_tpu_torch import bridge, config as PC
from strainer_gan_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from strainer_gan_tpu_torch.data import DeviceDataset, build_mixture
from strainer_gan_tpu_torch.models.autoencoder import ConvAutoEncoder, reconstruction_errors
from strainer_gan_tpu_torch.parity.agreement import agreement_report
from strainer_gan_tpu_torch.strain import engine as PE, thresholds as PTH
from strainer_gan_tpu_torch.train.loop import Trainer

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

B, MAX_SYNTH = 16, 100


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_ae(seed):
    ae = JAE(compute_dtype=jnp.float32)
    params = ae.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 64, 64, 3)))["params"]
    # non-zero biases, so the bridge's bias mapping is exercised
    params = jax.tree.map(lambda p: p + 0.01 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                                                 p.shape), params)
    return ae, params


def test_forward_and_errors_match_jax():
    ae, params = _flax_ae(3)
    x = np.random.default_rng(0).uniform(-1, 1, (6, 64, 64, 3)).astype(np.float32)
    want = np.asarray(ae.apply({"params": params}, jnp.asarray(x)))
    tae = bridge.load_dcgan_from_flax(ConvAutoEncoder(), _np(params))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tae(xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(reconstruction_errors(got, xt).numpy(),
                               np.asarray(jax_errors(jnp.asarray(want), jnp.asarray(x))),
                               rtol=1e-6)
    back = bridge.dcgan_to_flax(tae)["params"]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(_np(params)),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("masked", [False, True])
def test_ae_error_mask_matches_jax(masked):
    rng = np.random.default_rng(4)
    e = rng.gamma(4.0, 0.01, 16_384).astype(np.float32)
    v = rng.random(e.size) > 0.1 if masked else None
    mask_j, thr_j = JTH.ae_error_mask(jnp.asarray(e), 2.0, None if v is None else jnp.asarray(v))
    mask_p, thr_p = PTH.ae_error_mask(torch.from_numpy(e), 2.0,
                                      None if v is None else torch.from_numpy(v))
    assert abs(float(thr_p) - float(thr_j)) <= 1e-6 * float(thr_j)
    d = np.abs(e.astype(np.float64) - float(thr_j))
    print(f"threshold {float(thr_p):.9g} (JAX {float(thr_j):.9g}), nearest margin "
          f"{d[d > 0].min():.3g}")
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))


def _cfgs(**strain):
    jcfg = JC.get_preset("autoencoder")
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, batch_size=B),
                        model=dataclasses.replace(jcfg.model, ngf=8, ndf=8,
                                                  compute_dtype="float32"),
                        strain=dataclasses.replace(jcfg.strain, score_batch=64, **strain))
    return jcfg, PC.ExperimentConfig.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def datasets():
    jcfg, pcfg = _cfgs()
    jds = JDataset(jax_mixture(jcfg.data, max_synth=MAX_SYNTH))
    pds = DeviceDataset(build_mixture(pcfg.data, max_synth=MAX_SYNTH), "cpu")
    np.testing.assert_array_equal(pds.images.numpy(), np.asarray(jds.images))
    return jds, pds


def _jax_ae_step(ae):
    """The JAX engine's AE step (`strainer_gan_tpu/strain/engine.py:313-334`)."""
    import optax
    from strainer_gan_tpu.data.pipeline import normalize_u8

    tx = optax.adam(1e-3)

    @jax.jit
    def ae_step(params, opt, batch_u8, w):
        x = normalize_u8(batch_u8, jnp.float32)

        def loss_fn(p):
            recon = ae.apply({"params": p}, x)
            per = jnp.mean((recon - x) ** 2, axis=tuple(range(1, x.ndim)))
            return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    return tx, ae_step


def test_training_steps_match_jax():
    ae, params = _flax_ae(8)
    tx, jstep = _jax_ae_step(ae)
    opt = tx.init(params)
    tae = bridge.load_dcgan_from_flax(ConvAutoEncoder(), _np(params))
    topt = torch.optim.Adam(tae.parameters(), lr=1e-3)
    rng = np.random.default_rng(9)
    lr, b1, b2 = 1e-3, 0.9, 0.999
    for t in range(1, 6):
        batch = rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8)
        w = (np.arange(B) < (5 if t == 5 else B)).astype(np.float32)
        before, mu0 = _np(params), _np(opt[0].mu)
        params, opt, jloss = jstep(params, opt, jnp.asarray(batch), jnp.asarray(w))
        tloss = PE.ae_train_step(tae, topt, torch.from_numpy(batch), torch.from_numpy(w))
        assert abs(float(tloss) - float(jloss)) <= 1e-6 * float(jloss)
        got = bridge.dcgan_to_flax(tae)["params"]
        mu, nu = (_np(m) for m in (opt[0].mu, opt[0].nu))
        for (path, wt), g, b, m, v, m0 in zip(*(
                [jax.tree_util.tree_leaves_with_path(_np(params))]
                + [jax.tree_util.tree_leaves(x) for x in (got, before, mu, nu, mu0)])):
            grad = (m - b1 * m0) / (1 - b1)
            v_hat = v / (1 - b2 ** t)
            sens = lr * (1 - b1) / (1 - b1 ** t) * 1e-6 * np.abs(grad).max() \
                / (np.sqrt(v_hat) + 1e-8)
            noisy = sens > 1e-6
            name = f"step {t} {jax.tree_util.keystr(path)}"
            if noisy.any():
                print(f"{name}: {int(noisy.sum())} noise-sensitive elements held to "
                      "|update| <= 3 lr")
            np.testing.assert_allclose(g[~noisy], wt[~noisy], atol=1e-5, rtol=1e-4,
                                       err_msg=name)
            assert np.all(np.abs(g[noisy] - b[noisy]) <= 3 * lr), name
        tmu, tnu = bridge.adam_moments_to_flax(tae, topt)
        for x, y, what in ((tmu, mu, "mu"), (tnu, nu, "nu")):
            for (path, yv), xv in zip(jax.tree_util.tree_leaves_with_path(y),
                                      jax.tree_util.tree_leaves(x)):
                np.testing.assert_allclose(xv, yv, atol=1e-5, rtol=1e-4,
                                           err_msg=f"step {t} {what} {path}")
        bridge.load_dcgan_from_flax(tae, _np(params))
        bridge.load_adam_from_flax(tae, topt, mu, nu, t)


def _inject_jax_draws(peng, jeng, key, active):
    """Hand the port's engine the JAX engine's AE draws for
    ``_train_autoencoder(key)`` (`strainer_gan_tpu/strain/engine.py:305-346`);
    returns the batches' indices per AE epoch."""
    from strainer_gan_tpu.data.pipeline import epoch_batch_indices as jax_indices

    k_init, key = jax.random.split(key)
    params = jeng.build_ae(k_init)
    peng.build_ae = lambda: bridge.load_dcgan_from_flax(ConvAutoEncoder(), _np(params))
    idx = []
    for _ in range(peng.sc.ae_train_epochs):
        key, k = jax.random.split(key)
        rows = -(-int(active.sum()) // B)
        idx.append(np.asarray(jax_indices(k, jnp.asarray(active), rows, B)))
    peng.ae_epoch_indices = lambda ep, rows: torch.from_numpy(idx[ep].astype(np.int64))
    return idx


def test_training_loop_feeds_the_jax_batches(datasets, monkeypatch):
    _, pds = datasets
    _, pcfg = _cfgs(ae_train_epochs=2)
    jeng = JE.StrainerEngine(_cfgs()[0], None, datasets[0], score_batch=64)
    peng = PE.StrainerEngine(pcfg, None, pds, score_batch=64)
    active = np.zeros(pds.n, bool)
    active[np.random.default_rng(6).choice(pds.n, 69, replace=False)] = True
    peng.active = torch.from_numpy(active)
    idx = _inject_jax_draws(peng, jeng, jax.random.PRNGKey(8), active)
    calls = []
    monkeypatch.setattr(PE, "ae_train_step", lambda ae, opt, batch, w: calls.append(
        (batch.clone(), w.clone())))
    peng._train_autoencoder()
    assert len(calls) == 2 * 5 and peng.ae is not None
    for k, (batch, w) in enumerate(calls):
        ep, row = divmod(k, 5)
        np.testing.assert_array_equal(batch.numpy(), pds.images.numpy()[idx[ep][row]])
        np.testing.assert_array_equal(w.numpy(), (np.arange(B) < (5 if row == 4 else B)))


def test_autoencoder_epoch3_mask_matches_jax(datasets):
    jds, pds = datasets
    jcfg, pcfg = _cfgs()
    jeng = JE.StrainerEngine(jcfg, None, jds, score_batch=64)
    peng = PE.StrainerEngine(pcfg, None, pds, score_batch=64)
    # the JAX engine's trained AE, handed over when the port trains its own
    peng._train_autoencoder = lambda: setattr(peng, "ae", bridge.load_dcgan_from_flax(
        ConvAutoEncoder(), _np(jeng.ae_params)))
    for e in range(4):
        jmask = np.asarray(jeng.on_epoch_start(e, None, jax.random.PRNGKey(20 + e)))
        pmask = peng.on_epoch_start(e).numpy()
        if e < 3:
            assert pmask.all() and jmask.all() and peng.ae is None
    je, pe = np.asarray(jeng.last_scores), peng.last_scores.numpy()
    np.testing.assert_allclose(pe, je, rtol=1e-5)
    thr_j = float(jeng.last_threshold)
    assert abs(float(peng.last_threshold) - thr_j) <= 1e-5 * thr_j
    d = np.abs(je.astype(np.float64) - thr_j)
    print(f"epoch 3: kept {pmask.sum()}/{pmask.size}, threshold "
          f"{float(peng.last_threshold):.8g} (JAX {thr_j:.8g}), nearest margin "
          f"{d[d > 0].min():.3g}")
    np.testing.assert_array_equal(pmask, jmask)
    # two equal halves (CelebA-like and CIFAR-like) put no error 2 sigma out
    # here; test_ae_error_mask_matches_jax holds a mask with a tail
    assert pmask.sum() > 0
    report = agreement_report(type("T", (), dict(engine=peng, cfg=pcfg))())
    assert report["method"] == "autoencoder" and report["agreement"] == 1.0
    assert peng.on_epoch_end(3).all()  # reset_each_epoch


def test_checkpoint_keeps_the_ae(tmp_path):
    _, cfg = _cfgs()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=5, log_every=1000),
                      strain=dataclasses.replace(cfg.strain, ae_train_epochs=1))
    tr = Trainer(cfg, device="cpu", max_synth=24)
    tr.setup()
    for e in range(4):
        tr.run_epoch(e)
    assert tr.engine.ae is not None
    save_checkpoint(str(tmp_path), tr, 3)
    fresh = Trainer(cfg, device="cpu", max_synth=24)
    fresh.setup()
    assert restore_checkpoint(str(tmp_path), fresh, epoch=3) == 4
    for a, b in zip(tr.engine.ae.state_dict().values(), fresh.engine.ae.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(tr.engine.on_epoch_start(4), fresh.engine.on_epoch_start(4))
    import json
    with open(tmp_path / "meta.json") as f:
        assert json.load(f)["has_ae"] is True
