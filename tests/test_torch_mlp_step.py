"""One MNIST MLP train step of the port against the JAX step (CPU, float32).

Both packages start from the same weights (the flax state bridged into the
port), take the same uint8 28x28x1 batch, the same noise ``z`` (the first
of ``jax.random.split(key, 6)``, as the JAX step draws it) and, for
``mnist_full``'s D with dropout, the same keep masks: the JAX step's own,
from the same split's dropout keys (entries 2, 3 and 4: D's real forward,
its fake forward and G's update, `strainer_gan_tpu/train/steps.py:105-108`),
read off the flax D with ``capture_intermediates`` and handed to the
port's step.  Cases: ``mnist8`` (G first, ``half_mean``, torch-default
Adam betas) and ``mnist_full`` (D first, dropout 0.3, labels 0.9/0.1, G
with BatchNorm1d), both at full width.

The updated parameters, BatchNorm statistics, both Adam moments and every
metric must agree at atol 1e-5 / rtol 1e-4 (tests/test_torch_step.py's
tolerance), with its carve-out for the parameters only: where a gradient
is at float32 noise level (|mu| <= 1e-6 of its tensor's largest), Adam's
first step turns its last bits into an O(lr) update of either sign, so
those elements are held to |update| <= lr.

The chunked executor on the CPU (``ChunkedStep``, which on the card is one
CUDA graph) runs the same body over the same buffers: three steps through
it equal three ``train_step`` calls bit for bit.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.models import build_models as jax_build_models
from strainer_gan_tpu.train.loop import step_config_from as jax_step_config
from strainer_gan_tpu.train.state import create_state
from strainer_gan_tpu.train.steps import make_train_step

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.data import DeviceDataset, Mixture, normalize_u8
from strainer_gan_tpu_torch.models import build_models
from strainer_gan_tpu_torch.train.state import make_optimizers
from strainer_gan_tpu_torch.train.steps import (ChunkedStep, step_config_from, step_body,
                                                train_step)

from test_torch_mlp_gan import jax_drop_masks

ATOL, RTOL = 1e-5, 1e-4
B = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(cfg):
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=B),
                       model=dataclasses.replace(cfg.model, compute_dtype="float32"))


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
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    for (path, w), b, m in zip(jax.tree_util.tree_leaves_with_path(want),
                               jax.tree_util.tree_leaves(before), jax.tree_util.tree_leaves(mu)):
        g = flat_g[path]
        w, b, m = np.asarray(w), np.asarray(b), np.abs(np.asarray(m))
        noisy = m <= 1e-6 * m.max()
        name = f"{what} {jax.tree_util.keystr(path)}"
        if noisy.any():
            print(f"{name}: {int(noisy.sum())} noise-level gradients held to |update| <= lr")
        np.testing.assert_allclose(g[~noisy], w[~noisy], atol=ATOL, rtol=RTOL, err_msg=name)
        for p in (g, w):
            assert np.all(np.abs(p[noisy] - b[noisy]) <= lr * (1 + 1e-3)), name


def _inputs(seed):
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, (B, 28, 28, 1)).astype(np.uint8)
    src = (rng.uniform(size=B) < 0.2).astype(np.int32)
    return batch, src


def _port_state(cfg, state0):
    gen, disc = build_models(cfg.model, seed=0)
    bridge.load_dcgan_from_flax(gen, _np(state0.g_params), _np(state0.g_stats) or None)
    bridge.load_dcgan_from_flax(disc, _np(state0.d_params))
    return gen, disc


@pytest.mark.parametrize("preset", ["mnist8", "mnist_full"])
def test_mlp_step_matches_jax(preset):
    jcfg = _f32(jax_preset(preset))
    jgen, jdisc = jax_build_models(jcfg.model)
    state0 = create_state(jcfg, jgen, jdisc, jax.random.PRNGKey(5))
    jscfg = jax_step_config(jcfg)
    assert jscfg.g_before_d == (preset == "mnist8")
    jstep = make_train_step(jgen, jdisc, jscfg, donate=False)
    batch, src = _inputs({"mnist8": 1, "mnist_full": 2}[preset])
    key = jax.random.PRNGKey(23)
    keys = jax.random.split(key, 6)
    z = np.asarray(jax.random.normal(keys[0], (B, 100), jnp.float32))
    lr_g, lr_d = jcfg.train.lr_g, jcfg.train.lr_d
    state1, jm = jstep(state0, jnp.asarray(batch), jnp.asarray(src), key, lr_g, lr_d,
                       False, jnp.asarray(False), None, True)

    cfg = _f32(get_preset(preset))
    scfg = step_config_from(cfg)
    assert scfg.g_before_d == (preset == "mnist8") and scfg.flatten
    gen, disc = _port_state(cfg, state0)
    opt_g, opt_d = make_optimizers(cfg, gen, disc)
    drop = None
    if scfg.dropout:
        per_forward = [jax_drop_masks(jdisc, {"params": state0.d_params}, keys[k], B)
                       for k in (2, 3, 4)]  # real, fake, G's update
        drop = [torch.from_numpy(np.stack(ms)) for ms in zip(*per_forward)]
        assert [tuple(m.shape) for m in drop] == [(3, B, 1024), (3, B, 512), (3, B, 256)]
    tm = train_step(gen, disc, opt_g, opt_d, normalize_u8(torch.from_numpy(batch)),
                    torch.from_numpy(src), torch.from_numpy(z.copy()), lr_g, lr_d, scfg,
                    drop_masks=drop)

    g, d = bridge.dcgan_to_flax(gen), bridge.dcgan_to_flax(disc)
    _assert_params_close(g["params"], state1.g_params, state0.g_params, state1.g_opt.mu,
                         lr_g, "G params")
    _assert_params_close(d["params"], state1.d_params, state0.d_params, state1.d_opt.mu,
                         lr_d, "D params")
    if preset == "mnist_full":
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


def test_dropout_step_needs_masks():
    cfg = _f32(get_preset("mnist_full"))
    gen, disc = build_models(cfg.model, seed=0)
    opt_g, opt_d = make_optimizers(cfg, gen, disc)
    batch, src = _inputs(3)
    with pytest.raises(ValueError, match="keep masks"):
        step_body(gen, disc, opt_g, opt_d, normalize_u8(torch.from_numpy(batch)),
                  torch.from_numpy(src), torch.zeros((B, 100)), step_config_from(cfg))


@pytest.mark.parametrize("preset", ["mnist8", "mnist_full"])
def test_chunked_equals_per_step_on_cpu(preset):
    """Three steps through the CPU ``ChunkedStep`` (its buffers filled from
    the same indices, noise and keep masks) equal three ``train_step``
    calls bit for bit: parameters, buffers, Adam state and metrics."""
    cfg = _f32(get_preset(preset))
    scfg = step_config_from(cfg)
    rng = np.random.default_rng(4)
    n, chunk = 200, 3
    images = rng.integers(0, 256, (n, 28, 28, 1)).astype(np.uint8)
    mix = Mixture(images, (rng.uniform(size=n) < 0.2).astype(np.int32), np.zeros(n, np.int32))
    ds = DeviceDataset(mix, "cpu")
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, n, (chunk, B), generator=g)
    z = torch.randn((chunk, B, 100), generator=g)
    drop = [torch.rand((chunk, 3, B, w), generator=g) < 0.7 for w in scfg.drop_widths]
    lr = cfg.train.lr_g

    runs = []
    for chunked in (False, True):
        gen, disc = build_models(cfg.model, seed=1)
        opt_g, opt_d = make_optimizers(cfg, gen, disc)
        ms = []
        for j in range(chunk if not chunked else 1):
            ms.append(train_step(gen, disc, opt_g, opt_d, normalize_u8(ds.gather(idx[j])),
                                 ds.source_id[idx[j]], z[j], lr, lr, scfg,
                                 drop_masks=[m[j] for m in drop] or None))
        if chunked:  # the first step was the executor's warm-up, as in the Trainer
            ex = ChunkedStep(gen, disc, opt_g, opt_d, ds, scfg, chunk - 1, ms[0],
                             mask_on=False, d_train=True,
                             stats=dict(captures=0, replays=0, capture_s=[], instantiate_s=[]))
            out = ex(idx[1:], z[1:], lr, lr, drop=[m[1:] for m in drop])
            ms += [{k: v[j] for k, v in out.items()} for j in range(chunk - 1)]
        runs.append((gen, disc, opt_g, opt_d, ms))
    (g0, d0, og0, od0, m0), (g1, d1, og1, od1, m1) = runs
    for a, b in ((g0, g1), (d0, d1)):
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(va, vb), k
    for a, b in ((og0, og1), (od0, od1)):
        for sa, sb in zip(a.state_dict()["state"].values(), b.state_dict()["state"].values()):
            assert all(torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])) for k in sa)
    for x, y in zip(m0, m1):
        assert all(torch.equal(x[k], y[k]) for k in x)
