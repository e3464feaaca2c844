"""The port's FID chain against the JAX package's and the committed torch
oracle fixture (CPU, float32, one torch thread).

* InceptionV3 on ``tests/fixtures/backbones.npz``: the synthetic
  torchvision-named weights (a pure function of each name, shared by both
  packages) give the fixture's activations within atol 2e-3, and the whole
  chain (resize, Inception, covariances, the Frechet distance) the
  fixture's scipy FID within rtol 2e-2: tests/test_backbone_fixtures.py's
  tolerances.  The flax trunk's variables bridged into the port
  (``bridge.inception_state_dict_from_flax``) equal those weights.
* ``resize_bilinear_299`` against ``jax.image.resize`` (linear, half-pixel
  centres) on a 28x28 grayscale batch repeated to 3 channels and on a
  64x64x3 one: atol 1e-5.
* The matrix square root at d = 256 on well-conditioned PSD pairs: the
  Newton-Schulz and eigh traces against the JAX package's and against
  scipy's ``sqrtm`` in float64, rtol 1e-4.
* ``frechet_distance`` on a rank-deficient pair whose sigma2 has a zero
  row (no Cholesky factor): the fallback to eigh engages, and the distance
  matches the JAX package's (which falls back too) and scipy's at rtol 1e-3
  (float32 eigendecompositions of a singular pair, and the distance is a
  difference of traces of about its own size).
* ``get_activations`` with L2 normalisation: unit rows, full batches only,
  equal to the JAX function with the same small feature map at atol 1e-5;
  ``batched_feature_pass(keep_all=True)`` covers every image (the tail
  batch padded), equal to the JAX function's at atol 1e-5.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg
import torch

from strainer_gan_tpu.eval import fid as JF
from strainer_gan_tpu.models.inception import InceptionV3Features as JInception
from strainer_gan_tpu.models.inception import load_torch_inception_state_dict
from strainer_gan_tpu.models.inception import resize_bilinear_299 as jax_resize
from strainer_gan_tpu.models.synth_weights import synth_inception_state_dict
from strainer_gan_tpu.ops import sqrtm as JS

from strainer_gan_tpu_torch import bridge
from strainer_gan_tpu_torch.eval import fid as TF
from strainer_gan_tpu_torch.models.inception import (InceptionV3Features, load_state_dict,
                                                     resize_bilinear_299)
from strainer_gan_tpu_torch.models.synth_weights import load_synth_weights
from strainer_gan_tpu_torch.ops import sqrtm as TS

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "backbones.npz")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def inception():
    return load_synth_weights(InceptionV3Features()).eval()


def _nchw(u8):
    x = ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_inception_activations_fixture(fx, inception):
    got = TF.get_activations(_nchw(fx["fid_a_u8"]), inception, batch_size=16).numpy()
    want = fx["inception_acts_a"]
    assert got.shape == want.shape == (16, 2048)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_fid_full_chain_fixture(fx, inception):
    got = TF.calculate_fid(_nchw(fx["fid_a_u8"]), _nchw(fx["fid_b_u8"]), inception,
                           batch_size=16)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(fx["fid_value"]), rtol=2e-2)
    assert TF.calls[-1]["n"] == 16 and TF.calls[-1]["fid"] == got
    assert TF.calls[-1]["branch"] in ("ns", "eigh")


def test_inception_bridge_equals_synthetic(inception):
    """The flax trunk with the synthetic weights loaded, bridged back:
    every tensor equals the port's synthetic value."""
    jm = JInception()
    variables = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, 299, 299, 3))))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), variables)
    variables = load_torch_inception_state_dict(variables, synth_inception_state_dict(variables))
    sd = bridge.inception_state_dict_from_flax(variables)
    own = inception.state_dict()
    assert set(sd) == {k for k in own if not k.endswith("num_batches_tracked")}
    for k, v in sd.items():
        assert torch.equal(v, own[k]), k
    fresh = load_state_dict(InceptionV3Features(), sd)
    assert all(torch.equal(fresh.state_dict()[k], own[k]) for k in sd)


@pytest.mark.parametrize("shape", [(3, 28, 28, 1), (2, 64, 64, 3)])
def test_resize_matches_jax(shape):
    x = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
    if shape[-1] == 1:  # the FID path repeats grayscale to 3 channels first
        x = np.repeat(x, 3, axis=-1)
    want = np.asarray(jax_resize(jnp.asarray(x)))
    got = resize_bilinear_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (shape[0], 299, 299, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _psd_pair(d, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        a = rng.standard_normal((n, d))
        out.append(np.asarray(a.T @ a / n + 0.1 * np.eye(d), np.float32))
    return out


def _scipy_trace(s1, s2):
    return float(np.trace(scipy.linalg.sqrtm(s1.astype(np.float64) @ s2.astype(np.float64))
                          ).real)


def test_sqrtm_paths_match_jax_and_scipy():
    s1, s2 = _psd_pair(256, 1024, 3)
    want = _scipy_trace(s1, s2)
    t1, t2 = torch.from_numpy(s1), torch.from_numpy(s2)
    ns, eig = float(TS.trace_sqrtm_product_ns(t1, t2)), float(TS.trace_sqrtm_product(t1, t2))
    j_ns = float(JS.trace_sqrtm_product_ns(jnp.asarray(s1), jnp.asarray(s2)))
    j_eig = float(JS.trace_sqrtm_product(jnp.asarray(s1), jnp.asarray(s2)))
    for got in (ns, eig):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(ns, j_ns, rtol=1e-4)
    np.testing.assert_allclose(eig, j_eig, rtol=1e-4)
    half = TS.psd_sqrt(t1)
    np.testing.assert_allclose((half @ half).numpy(), s1, atol=1e-4 * float(np.abs(s1).max()))
    mu1, mu2 = torch.zeros(256), torch.full((256,), 0.1)
    TS.frechet_distance(mu1, t1, mu2, t2)
    assert TS.last_branch == "ns"


def test_frechet_distance_falls_back_on_rank_deficient_pair():
    rng = np.random.default_rng(5)
    d, n = 64, 16
    a1, a2 = rng.standard_normal((n, d)), rng.standard_normal((n, d))
    a2[:, 7] = 0.0  # a dead feature: sigma2 has a zero row, no Cholesky factor
    s1 = np.asarray(np.cov(a1, rowvar=False), np.float32)
    s2 = np.asarray(np.cov(a2, rowvar=False), np.float32)
    mu1, mu2 = a1.mean(0).astype(np.float32), a2.mean(0).astype(np.float32)
    t = [torch.from_numpy(v) for v in (mu1, s1, mu2, s2)]
    assert not bool(torch.isfinite(TS.trace_sqrtm_product_ns(t[1], t[3])))
    got = float(TS.frechet_distance(*t))
    assert TS.last_branch == "eigh" and np.isfinite(got)
    np.testing.assert_allclose(got, float(TS.frechet_distance(*t, method="eigh")), rtol=0)
    want_jax = float(JS.frechet_distance(*(jnp.asarray(v) for v in (mu1, s1, mu2, s2))))
    np.testing.assert_allclose(got, want_jax, rtol=1e-3)
    diff = (mu1 - mu2).astype(np.float64)
    want = diff @ diff + np.trace(s1) + np.trace(s2) - 2 * _scipy_trace(s1, s2)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_normalised_activations_match_jax():
    """A small fixed feature map in place of Inception: the L2-normalised
    activations of 23 images at batch 10 (the full batches only)."""
    rng = np.random.default_rng(6)
    imgs = rng.uniform(-1, 1, (23, 28, 28, 1)).astype(np.float32)
    proj = rng.standard_normal((3, 8)).astype(np.float32)

    def t_fn(x):  # NCHW 299x299 -> (N, 8)
        return torch.tanh(x.mean(dim=(2, 3)) @ torch.from_numpy(proj)) + 1.5

    def j_fn(x):  # NHWC
        return jnp.tanh(x.mean(axis=(1, 2)) @ jnp.asarray(proj)) + 1.5

    got = TF.get_activations(torch.from_numpy(imgs).permute(0, 3, 1, 2), t_fn, batch_size=10,
                             normalize=True).numpy()
    want = np.asarray(JF.get_activations(jnp.asarray(imgs), j_fn, batch_size=10,
                                         normalize=True))
    assert got.shape == want.shape == (20, 8)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_keep_all_pass_matches_jax():
    rng = np.random.default_rng(7)
    imgs = rng.uniform(-1, 1, (23, 8, 8, 3)).astype(np.float32)
    proj = rng.standard_normal((3, 5)).astype(np.float32)
    got = TF.batched_feature_pass(torch.from_numpy(imgs).permute(0, 3, 1, 2),
                                  lambda x: x.mean(dim=(2, 3)) @ torch.from_numpy(proj), 10,
                                  keep_all=True).numpy()
    want = np.asarray(JF.batched_feature_pass(jnp.asarray(imgs),
                                              lambda x: x.mean(axis=(1, 2)) @ proj, 10,
                                              keep_all=True))
    assert got.shape == want.shape == (23, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
