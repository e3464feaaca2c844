"""The MNIST MLP GAN of the port against the JAX package's (CPU, float32).

The same flax variables go through the flax modules and, bridged
(``bridge.load_dcgan_from_flax``), through the port's, at full width
(G 100-256-512-1024-784, D 784-1024-512-256-1), on inputs from a numpy
seed.  D's dropout masks are the JAX package's own: the flax D applied
with a dropout key and ``capture_intermediates``, each ``Dropout_k``
output read as nonzero, then handed to the port's D.  Tolerance: atol
1e-5 on outputs and BatchNorm running statistics (float32 products summed
in another order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.models.layers import MaskedBatchNorm as JBN
from strainer_gan_tpu.models.mlp_gan import MLPDiscriminator as JD, MLPGenerator as JG

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.models import MLPDiscriminator, MLPGenerator, build_models
from strainer_gan_tpu_torch.models.layers import MaskedBatchNorm

ATOL = 1e-5
B = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_drop_masks(disc, variables, key, b):
    """The keep masks flax's D draws from ``key`` for a (b, 784) batch: one
    (b, width) bool array per hidden layer.  They depend on the key and the
    shapes only; the probe input keeps every activation nonzero."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((b, 784)), jnp.float32)
    _, st = disc.apply(variables, x, train=True, rngs={"dropout": key},
                       capture_intermediates=True, mutable=["intermediates"])
    inter = st["intermediates"]
    return [np.asarray(inter[f"Dropout_{k}"]["__call__"][0]) != 0 for k in range(3)]


def _port_g(jvars, batchnorm):
    g = MLPGenerator(torch.Generator().manual_seed(0), batchnorm=batchnorm)
    return bridge.load_dcgan_from_flax(g, _np(jvars["params"]),
                                       _np(jvars.get("batch_stats")) if batchnorm else None)


@pytest.mark.parametrize("batchnorm", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_generator_matches_jax(batchnorm, weighted):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((B, 100)).astype(np.float32)
    w = (rng.uniform(size=B) > 0.3).astype(np.float32) if weighted else None
    jg = JG(batchnorm=batchnorm, compute_dtype=jnp.float32)
    jv = jg.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(z), train=True)
    g = _port_g(jv, batchnorm)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    if batchnorm:
        want, mut = jg.apply(jv, jnp.asarray(z), train=True, sample_weights=jw,
                             mutable=["batch_stats"])
        got = g(torch.from_numpy(z), tw, train=True)
        stats = bridge.dcgan_to_flax(g)["batch_stats"]
        for k, layer in mut["batch_stats"].items():
            for s in ("mean", "var"):
                np.testing.assert_allclose(stats[k][s], np.asarray(layer[s]), atol=ATOL,
                                           err_msg=f"{k} {s}")
        # eval mode: the running statistics just written
        want_eval = jg.apply({"params": jv["params"], "batch_stats": mut["batch_stats"]},
                             jnp.asarray(z), train=False)
        np.testing.assert_allclose(g(torch.from_numpy(z), train=False).detach().numpy(),
                                   np.asarray(want_eval), atol=ATOL)
    else:
        want = jg.apply(jv, jnp.asarray(z), train=True, sample_weights=jw)
        got = g(torch.from_numpy(z), tw, train=True)
    assert got.shape == (B, 784)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_discriminator_matches_jax(dropout):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
    jd = JD(dropout=dropout, compute_dtype=jnp.float32)
    jv = jd.init({"params": jax.random.PRNGKey(4)}, jnp.asarray(x), train=False)
    d = bridge.load_dcgan_from_flax(
        MLPDiscriminator(torch.Generator().manual_seed(0), dropout=dropout),
        _np(jv["params"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW, flattened inside as NHWC for C=1
    # eval: no dropout
    want = jd.apply(jv, jnp.asarray(x), train=False)
    got = d(xt, train=False)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    if dropout:
        key = jax.random.PRNGKey(9)
        masks = jax_drop_masks(jd, jv, key, B)
        assert [m.shape for m in masks] == [(B, 1024), (B, 512), (B, 256)]
        keep = np.mean(np.concatenate([m.ravel() for m in masks]))
        assert 0.6 < keep < 0.8
        want = jd.apply(jv, jnp.asarray(x), train=True, rngs={"dropout": key})
        got = d(xt, train=True, drop_masks=[torch.from_numpy(m) for m in masks])
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
        with pytest.raises(ValueError, match="keep masks"):
            d(xt, train=True)


@pytest.mark.parametrize("weighted", [False, True])
def test_batchnorm_1d_matches_jax(weighted):
    """The weighted BatchNorm on (N, C): output and running statistics
    against the JAX package's ``MaskedBatchNorm`` with scale_init ones."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((12, 32)) * 3 + 1).astype(np.float32)
    w = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0, 1, 1, 1], np.float32) if weighted else None
    jbn = JBN(scale_init=jax.nn.initializers.ones, compute_dtype=jnp.float32)
    jv = jbn.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    jw = None if w is None else jnp.asarray(w)
    want, mut = jbn.apply(jv, jnp.asarray(x), jw, mutable=["batch_stats"])
    bn = MaskedBatchNorm(32)
    got = bn(torch.from_numpy(x), None if w is None else torch.from_numpy(w), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               atol=ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               atol=ATOL)


def test_build_models_mlp_shapes_and_init():
    """Both MNIST variants at full width from the presets; every Linear
    starts within U(±1/sqrt(fan_in)) (up to float32 rounding), seeded."""
    for name in ("mnist8", "mnist_full"):
        cfg = get_preset(name).model
        g, d = build_models(cfg, seed=3)
        assert [lin.weight.shape[::-1] for lin in g.linears] == [
            (100, 256), (256, 512), (512, 1024), (1024, 784)]
        assert [lin.weight.shape[::-1] for lin in d.linears] == [
            (784, 1024), (1024, 512), (512, 256), (256, 1)]
        assert (g.bns is not None) == cfg.g_batchnorm and d.dropout == cfg.d_dropout
        for lin in list(g.linears) + list(d.linears):
            bound = 1.0 / lin.weight.shape[1] ** 0.5 * (1 + 1e-6)  # float32 rounding
            for p in (lin.weight, lin.bias):
                assert float(p.detach().abs().max()) <= bound
        g2, _ = build_models(cfg, seed=3)
        assert all(torch.equal(a, b) for a, b in zip(g.state_dict().values(),
                                                     g2.state_dict().values()))
