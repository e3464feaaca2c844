"""The port's ResNet50 feature trunk (the eval suite's) against the committed
torch-oracle fixture and the JAX trunk (CPU, float32, one torch thread).

* ``tests/fixtures/backbones.npz``: the synthetic torchvision-named
  weights (a pure function of each name, shared by both packages) give the
  fixture's ``resnet50_features`` within rtol 1e-3 / atol 1e-2, the JAX
  test's tolerance (`tests/test_backbone_fixtures.py:65-71`: activations
  of about 8e2 through 50 layers).
* The flax trunk's own initialisation (``PRNGKey(0)``, what the JAX
  package uses with nothing staged) bridged by
  ``bridge.resnet50_state_dict_from_flax`` gives the JAX trunk's features
  on the same images within rtol 1e-4 / atol 1e-5 of their largest.
* The name map is the JAX package's (`strainer_gan_tpu/models/resnet.py:144-173`),
  pair for pair; the staged-weights loader fills every trunk entry; the
  built feature function is cached per (name, channels, device).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.models.resnet import resnet50_features, torch_name_map

from strainer_gan_tpu_torch import bridge
from strainer_gan_tpu_torch.models import features as PF
from strainer_gan_tpu_torch.models.resnet import (STAGES, ResNet18Features, ResNetFeatures,
                                                  load_staged_weights)
from strainer_gan_tpu_torch.models.synth_weights import load_synth_weights

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "backbones.npz")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ResNet50():
    return ResNetFeatures(*STAGES["resnet50"], in_channels=3)


def _normalize(u8):
    return torch.from_numpy(((u8.astype(np.float32) / 255.0) - 0.5) / 0.5).permute(0, 3, 1, 2)


def test_resnet50_fixture():
    fx = np.load(FIXTURE)
    model = load_synth_weights(ResNet50()).eval()
    with torch.no_grad():
        got = model(_normalize(fx["resnet_input_u8"])).numpy()
    want = fx["resnet50_features"]
    assert got.shape == want.shape == (4, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)


def test_resnet50_matches_jax_trunk():
    x = np.random.default_rng(0).uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    jm = resnet50_features(3)
    jv = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)))
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(jv, jnp.asarray(x)))
    model = ResNet50()
    sd = bridge.resnet50_state_dict_from_flax(jax.tree.map(np.asarray, jv))
    load_staged_weights(model, sd).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (3, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_name_map_and_loader():
    ours = [(path, conv, bn) for path, conv, bn in bridge.resnet_name_map("bottleneck",
                                                                          (3, 4, 6, 3))]
    theirs = torch_name_map("bottleneck", (3, 4, 6, 3))
    assert [(p, (c, b)) for p, c, b in ours] == [(tuple(p), cb) for p, cb in theirs]
    assert len(ours) == 53  # stem + 16 blocks x 3 + 4 downsample units
    model = ResNet50()
    keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    covered = {f"{n}.{s}" for _, c, b in ours for n, s in
               [(c, "weight")] + [(b, t) for t in ("weight", "bias", "running_mean",
                                                   "running_var")]}
    assert keys == covered
    assert bridge.resnet18_name_map  # the old name stays
    assert len(list(bridge.resnet18_name_map())) == 20
    assert ResNet18Features(1)(torch.zeros(1, 1, 64, 64)).shape == (1, 512)


def test_feature_fn_cached():
    with pytest.warns(UserWarning, match="resnet50.pt"):
        f = PF.build_feature_fn("resnet50", 3, "cpu")
    assert PF.build_feature_fn("resnet50", 3, "cpu") is f
    out = f(torch.zeros(2, 3, 32, 32))
    assert out.shape == (2, 2048) and out.dtype == torch.float32
