"""D dropout combined with the in-step keep or with the fake pool: one
MNIST MLP step of the port against the JAX step (CPU, float32).

A config JSON sets ``mnist_full`` (D dropout 0.3) with
``batch_quantile_mask``, or with ``fake_concat="pool"``; both packages
read the same JSON.  The JAX step draws its keep masks from its own keys
(`strainer_gan_tpu/train/steps.py:105-108, 159-161`): the scoring forward
from ``k_score_drop`` (entry 1 of ``jax.random.split(key, 6)``), D's real
and fake forwards and G's update from entries 2, 3 and 4; with a pool the
fake forward spans all 2b lanes, generated then pool.  Those masks are
read off the flax D (``capture_intermediates``) and handed to the port's
step as its rows ``DROP_SCORE``, ``DROP_REAL``, ``DROP_FAKE`` and
``DROP_G``; the pool rows are the JAX step's permutation of entry 5.

Tolerances are tests/test_torch_mlp_step.py's: parameters, BatchNorm
statistics, Adam moments and metrics at atol 1e-5 / rtol 1e-4, with the
noise-level gradient carve-out for the parameters (|update| <= lr); the
keep mask of the in-step quantile exactly.
"""
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import ExperimentConfig as JaxConfig
from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.models import build_models as jax_build_models
from strainer_gan_tpu.train.loop import step_config_from as jax_step_config
from strainer_gan_tpu.train.state import create_state
from strainer_gan_tpu.train.steps import make_train_step

from strainer_gan_tpu_torch import bridge
from strainer_gan_tpu_torch.config import ExperimentConfig
from strainer_gan_tpu_torch.data import normalize_u8
from strainer_gan_tpu_torch.models import build_models
from strainer_gan_tpu_torch.train.state import make_optimizers
from strainer_gan_tpu_torch.train.steps import (DROP_FAKE, DROP_G, DROP_REAL, DROP_SCORE,
                                                drop_shape, step_config_from, train_step)

from test_torch_mlp_gan import jax_drop_masks
from test_torch_mlp_step import ATOL, RTOL, _assert_params_close, _assert_tree_close, _np

B = 32
POOL_N = 20


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_json(combo):
    cfg = jax_preset("mnist_full")
    strain = (dict(method="batch_quantile_mask", mask_quantile=0.25) if combo == "mask"
              else dict(fake_concat="pool"))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=B),
                      model=dataclasses.replace(cfg.model, compute_dtype="float32"),
                      strain=dataclasses.replace(cfg.strain, **strain))
    assert cfg.model.d_dropout == 0.3
    return cfg.to_json()


@pytest.mark.parametrize("combo", ["mask", "pool"])
def test_dropout_combo_step_matches_jax(combo):
    text = _config_json(combo)
    jcfg = JaxConfig.from_json(text)
    cfg = ExperimentConfig.from_json(text)
    assert json.loads(cfg.to_json()) == json.loads(text)
    scfg = step_config_from(cfg)  # no longer refused
    assert scfg.dropout == 0.3 and (scfg.batch_mask if combo == "mask" else scfg.pool_concat)

    jgen, jdisc = jax_build_models(jcfg.model)
    state0 = create_state(jcfg, jgen, jdisc, jax.random.PRNGKey(7))
    jstep = make_train_step(jgen, jdisc, jax_step_config(jcfg), donate=False)
    rng = np.random.default_rng({"mask": 11, "pool": 12}[combo])
    batch = rng.integers(0, 256, (B, 28, 28, 1)).astype(np.uint8)
    src = (rng.uniform(size=B) < 0.3).astype(np.int32)
    pool = rng.integers(0, 256, (POOL_N, 28, 28, 1)).astype(np.uint8)
    key = jax.random.PRNGKey(31)
    keys = jax.random.split(key, 6)
    z = np.asarray(jax.random.normal(keys[0], (B, 100), jnp.float32))
    lr_g, lr_d = jcfg.train.lr_g, jcfg.train.lr_d
    masked = combo == "mask"
    state1, jm = jstep(state0, jnp.asarray(batch), jnp.asarray(src), key, lr_g, lr_d,
                       masked, jnp.asarray(not masked),
                       None if masked else jnp.asarray(pool), True)

    dvars = {"params": state0.d_params}
    lanes = 2 * B if combo == "pool" else B
    rows = {DROP_REAL: (keys[2], B), DROP_FAKE: (keys[3], lanes), DROP_G: (keys[4], B)}
    if masked:
        rows[DROP_SCORE] = (keys[1], B)
    drop = []
    for k, w in enumerate(scfg.drop_widths):
        m = torch.zeros(drop_shape(scfg, B, w), dtype=torch.bool)
        for row, (kk, n) in rows.items():
            m[row, :n] = torch.from_numpy(jax_drop_masks(jdisc, dvars, kk, n)[k])
        drop.append(m)
    assert [tuple(m.shape) for m in drop] == [
        (4 if masked else 3, lanes, w) for w in (1024, 512, 256)]
    pool_idx = None
    if not masked:
        perm = np.asarray(jax.random.permutation(keys[5], POOL_N))
        pool_idx = torch.from_numpy(perm[np.arange(B) % POOL_N].astype(np.int64))

    gen, disc = build_models(cfg.model, seed=0)
    bridge.load_dcgan_from_flax(gen, _np(state0.g_params), _np(state0.g_stats) or None)
    bridge.load_dcgan_from_flax(disc, _np(state0.d_params))
    opt_g, opt_d = make_optimizers(cfg, gen, disc)
    tm = train_step(gen, disc, opt_g, opt_d, normalize_u8(torch.from_numpy(batch)),
                    torch.from_numpy(src), torch.from_numpy(z.copy()), lr_g, lr_d, scfg,
                    mask_on=masked, fake_pool=None if masked else torch.from_numpy(pool),
                    pool_idx=pool_idx, concat_on=not masked, drop_masks=drop)

    if masked:
        keep = tm["keep_mask"].numpy()
        np.testing.assert_array_equal(keep, np.asarray(jm["keep_mask"]))
        assert 0 < keep.sum() < B
    g, d = bridge.dcgan_to_flax(gen), bridge.dcgan_to_flax(disc)
    _assert_params_close(g["params"], state1.g_params, state0.g_params, state1.g_opt.mu,
                         lr_g, "G params")
    _assert_params_close(d["params"], state1.d_params, state0.d_params, state1.d_opt.mu,
                         lr_d, "D params")
    _assert_tree_close(g["batch_stats"], state1.g_stats, "G BN stats")
    for module, opt, jopt, name in ((gen, opt_g, state1.g_opt, "G"),
                                    (disc, opt_d, state1.d_opt, "D")):
        mu, nu = bridge.adam_moments_to_flax(module, opt)
        _assert_tree_close(mu, jopt.mu, f"{name} Adam mu")
        _assert_tree_close(nu, jopt.nu, f"{name} Adam nu")
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
