"""The weight bridge and the port's models against the flax models (CPU).

The same flax variables go through the flax module and, bridged, through
the port's module; inputs come from a numpy seed.  Tolerance: 1e-5
relative to the largest reference magnitude (float32 convolutions summed
in another order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.models import Discriminator64 as JDisc, Generator64 as JGen
from strainer_gan_tpu.models.resnet import load_torch_resnet_state_dict, resnet18_features
from strainer_gan_tpu.models.synth_weights import synth_resnet_state_dict

from strainer_gan_tpu_torch import bridge
from strainer_gan_tpu_torch.models import Discriminator64, Generator64
from strainer_gan_tpu_torch.models.features import build_feature_fn
from strainer_gan_tpu_torch.models.resnet import ResNet18Features

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

WIDTH = 8  # narrow G/D: the layer structure is the full model's


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def dcgan_vars():
    rng = np.random.default_rng(7)
    gen = JGen(nz=100, ngf=WIDTH, compute_dtype=jnp.float32)
    disc = JDisc(ndf=WIDTH, compute_dtype=jnp.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    z = rng.standard_normal((6, 100)).astype(np.float32)
    x = rng.uniform(-1, 1, (6, 64, 64, 3)).astype(np.float32)
    gv = jax.jit(lambda k, a: gen.init({"params": k}, a, train=True))(k1, jnp.asarray(z))
    dv = jax.jit(lambda k, a: disc.init({"params": k}, a, train=True))(k2, jnp.asarray(x))
    # non-trivial running statistics, so eval mode is exercised
    gv = {"params": gv["params"], "batch_stats": jax.tree.map(
        lambda a: a + jnp.asarray(rng.uniform(0.1, 0.5, a.shape), jnp.float32),
        gv["batch_stats"])}
    dv = {"params": dv["params"], "batch_stats": jax.tree.map(
        lambda a: a + jnp.asarray(rng.uniform(0.1, 0.5, a.shape), jnp.float32),
        dv["batch_stats"])}
    return gen, disc, gv, dv, z, x


@pytest.mark.parametrize("train", [True, False])
def test_generator_bridge_matches_flax(dcgan_vars, train):
    gen, _, gv, _, z, _ = dcgan_vars
    if train:
        want, mut = gen.apply(gv, jnp.asarray(z), train=True, mutable=["batch_stats"])
    else:
        want = gen.apply(gv, jnp.asarray(z), train=False)
    tg = bridge.load_dcgan_from_flax(Generator64(100, WIDTH), _np_tree(gv["params"]),
                                     _np_tree(gv["batch_stats"]))
    got = tg(torch.from_numpy(z), train=train).detach().numpy().transpose(0, 2, 3, 1)
    _close(got, want)
    if train:  # running statistics after one train-mode forward
        stats = bridge.dcgan_to_flax(tg)["batch_stats"]
        for name, leaf in stats.items():
            for k in ("mean", "var"):
                _close(leaf[k], mut["batch_stats"][name][k])


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_bridge_matches_flax(dcgan_vars, train):
    _, disc, _, dv, _, x = dcgan_vars
    w = np.array([1, 1, 0, 1, 1, 0], np.float32)  # masked BN lanes in train mode
    if train:
        want, _ = disc.apply(dv, jnp.asarray(x), train=True, sample_weights=jnp.asarray(w),
                             mutable=["batch_stats"])
    else:
        want = disc.apply(dv, jnp.asarray(x), train=False)
    td = bridge.load_dcgan_from_flax(Discriminator64(WIDTH), _np_tree(dv["params"]),
                                     _np_tree(dv["batch_stats"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = td(xt, torch.from_numpy(w) if train else None, train=train).detach().numpy()
    _close(got, want)
    if not train:  # the stem/head split composes to the full forward
        again = td.head(td.stem(xt), None, train=False).detach().numpy()
        np.testing.assert_array_equal(again, got)


def test_bridge_roundtrip(dcgan_vars):
    _, _, gv, dv, _, _ = dcgan_vars
    for module, v in ((Generator64(100, WIDTH), gv), (Discriminator64(WIDTH), dv)):
        bridge.load_dcgan_from_flax(module, _np_tree(v["params"]), _np_tree(v["batch_stats"]))
        back = bridge.dcgan_to_flax(module)
        for coll in ("params", "batch_stats"):
            for a, b in zip(jax.tree.leaves(back[coll]), jax.tree.leaves(_np_tree(v[coll]))):
                np.testing.assert_array_equal(a, b)


def test_resnet18_features_match_flax():
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    model = resnet18_features(3)
    variables = jax.jit(lambda k, a: model.init({"params": k}, a))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    variables = load_torch_resnet_state_dict(variables, synth_resnet_state_dict(variables))
    want = np.asarray(model.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x),
                                  train=False))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    # the port's own synthetic weights ...
    got = build_feature_fn("resnet18", 3, device="cpu")(xt).numpy()
    _close(got, want)
    # ... and the flax trunk's variables carried over by the bridge
    trunk = ResNet18Features(3).eval()
    trunk.load_state_dict(bridge.resnet18_state_dict_from_flax(variables), strict=False)
    with torch.no_grad():
        np.testing.assert_array_equal(trunk(xt).numpy(), got)
