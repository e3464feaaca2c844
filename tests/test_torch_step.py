"""One D-first train step of the port against the JAX step (CPU, float32).

Both packages start from the same weights (bridged from the flax state),
take the same uint8 batch and the same noise ``z`` (drawn as the JAX step
draws it, from the first of ``jax.random.split(key, 6)``, steps.py:182),
and must agree on the updated parameters, the BN running statistics of G
and D, Adam's first and second moments, and every entry of the metrics
dict (`steps.py:347-360`).  Tolerance: atol 1e-5, rtol 1e-4.

One carve-out, for the parameters only: where a gradient is at float32
noise level (|g| <= 1e-6 of its tensor's largest, i.e. zero up to the
rounding of its sum), Adam's first step, -lr * g / (|g| + 1e-8), turns the
last bits of g into an O(lr) update in either direction, so neither side
is more right.  Those elements (printed) are held only to |update| <= lr;
every other element, and every moment, statistic and metric, is held to
the tolerance above.

Cases: a full batch; the drop_last=False partial tail (``lane_count``
valid lanes); and a full batch with D's BatchNorms in eval mode, which is
what the ``final`` preset trains with after its first scoring pass
(bn_eval_after_score).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.models import Discriminator64 as JDisc, Generator64 as JGen
from strainer_gan_tpu.train.loop import step_config_from as jax_step_config
from strainer_gan_tpu.train.state import create_state
from strainer_gan_tpu.train.steps import make_train_step

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.data import normalize_u8
from strainer_gan_tpu_torch.models import Discriminator64, Generator64
from strainer_gan_tpu_torch.train.state import make_optimizers
from strainer_gan_tpu_torch.train.steps import step_config_from, train_step

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

WIDTH, B = 8, 8
ATOL, RTOL = 1e-5, 1e-4


def _tiny(cfg):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=B),
        model=dataclasses.replace(cfg.model, ngf=WIDTH, ndf=WIDTH, compute_dtype="float32"),
    )


@pytest.fixture(scope="module")
def jax_side():
    cfg = _tiny(jax_preset("final"))
    gen = JGen(nz=100, ngf=WIDTH, compute_dtype=jnp.float32)
    disc = JDisc(ndf=WIDTH, compute_dtype=jnp.float32)
    state = jax.jit(lambda k: create_state(cfg, gen, disc, k))(jax.random.PRNGKey(5))
    step = make_train_step(gen, disc, jax_step_config(cfg), donate=False)
    return cfg, state, step


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, what):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g), what
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _assert_params_close(got, want, before, mu, lr, what):
    """Params after one Adam step, with the noise-level-gradient carve-out."""
    for (path, w), b, m in zip(jax.tree_util.tree_leaves_with_path(want),
                               jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(mu)):
        g = dict(jax.tree_util.tree_leaves_with_path(got))[path]
        w, b, m = np.asarray(w), np.asarray(b), np.abs(np.asarray(m))
        noisy = m <= 1e-6 * m.max()
        name = f"{what} {jax.tree_util.keystr(path)}"
        if noisy.any():
            print(f"{name}: {int(noisy.sum())} noise-level gradients held to |update| <= lr")
        np.testing.assert_allclose(g[~noisy], w[~noisy], atol=ATOL, rtol=RTOL, err_msg=name)
        for p in (g, w):
            assert np.all(np.abs(p[noisy] - b[noisy]) <= lr * (1 + 1e-3)), name


@pytest.mark.parametrize("case", ["full", "tail", "d_eval"])
def test_d_first_step_matches_jax(jax_side, case):
    jcfg, state0, jstep = jax_side
    lane = 5 if case == "tail" else None
    d_train = case != "d_eval"
    rng = np.random.default_rng({"full": 1, "tail": 2, "d_eval": 3}[case])
    batch = rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8)
    src = (rng.uniform(size=B) < 0.3).astype(np.int32)
    key = jax.random.PRNGKey(17)
    z = np.asarray(jax.random.normal(jax.random.split(key, 6)[0], (B, 100), jnp.float32))
    lr_g, lr_d = jcfg.train.lr_g, jcfg.train.lr_d

    kw = {} if lane is None else dict(lane_count=jnp.asarray(lane, jnp.int32))
    state1, jm = jstep(state0, jnp.asarray(batch), jnp.asarray(src), key, lr_g, lr_d,
                       False, jnp.asarray(False), None, d_train, **kw)

    cfg = _tiny(get_preset("final"))
    gen = bridge.load_dcgan_from_flax(Generator64(100, WIDTH), _np(state0.g_params),
                                      _np(state0.g_stats))
    disc = bridge.load_dcgan_from_flax(Discriminator64(WIDTH), _np(state0.d_params),
                                       _np(state0.d_stats))
    opt_g, opt_d = make_optimizers(cfg, gen, disc)
    tm = train_step(gen, disc, opt_g, opt_d, normalize_u8(torch.from_numpy(batch)),
                    torch.from_numpy(src), torch.from_numpy(z.copy()), lr_g, lr_d,
                    step_config_from(cfg), d_train=d_train, lane_count=lane)

    g, d = bridge.dcgan_to_flax(gen), bridge.dcgan_to_flax(disc)
    _assert_params_close(g["params"], state1.g_params, state0.g_params, state1.g_opt.mu,
                         lr_g, "G params")
    _assert_params_close(d["params"], state1.d_params, state0.d_params, state1.d_opt.mu,
                         lr_d, "D params")
    _assert_tree_close(g["batch_stats"], state1.g_stats, "G BN stats")
    _assert_tree_close(d["batch_stats"], state1.d_stats, "D BN stats")
    for module, opt, jopt, name in ((gen, opt_g, state1.g_opt, "G"),
                                    (disc, opt_d, state1.d_opt, "D")):
        mu, nu = bridge.adam_moments_to_flax(module, opt)
        _assert_tree_close(mu, jopt.mu, f"{name} Adam mu")
        _assert_tree_close(nu, jopt.nu, f"{name} Adam nu")
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
