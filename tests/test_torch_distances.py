"""The eval suite's distances (``eval/distances.py``) against the JAX
functions and against scipy / sklearn in float64 (CPU, one torch thread).

Tolerances are the JAX tests' (`tests/test_backbones.py:86-121`): the 1-D
Wasserstein distance within rtol 1e-5 of ``scipy.stats.wasserstein_distance``
(equal and unequal counts) and the PCA-Wasserstein distance within rtol
1e-3 of sklearn's PCA followed by scipy's W1; against the JAX functions on
the same float32 inputs, rtol 1e-5 (W1, the mean feature distance) and
1e-3 (the PCA distance, an SVD in each package).  The components' signs
follow sklearn's ``svd_flip`` rule: each component's largest-magnitude
entry is positive, and the projections equal sklearn's within 1e-3 of
their largest.  The suite's shapes are covered at their usual kind,
unequal counts (500 fakes against 409 contaminants in ``batch_mask``'s
mixture): here 100 against 90 rows, and k = min(50, d) with d = 30.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import wasserstein_distance
from sklearn.decomposition import PCA

from strainer_gan_tpu.eval import distances as JD

from strainer_gan_tpu_torch.eval import distances as TD


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nv", [64, 80])
def test_wasserstein_1d(nv):
    rng = np.random.default_rng(nv)
    u = rng.standard_normal(64).astype(np.float32)
    v = (rng.standard_normal(nv) * 2 + 1).astype(np.float32)
    got = float(TD.wasserstein_1d(torch.from_numpy(u), torch.from_numpy(v)))
    np.testing.assert_allclose(got, wasserstein_distance(u, v), rtol=1e-5)
    np.testing.assert_allclose(got, float(JD.wasserstein_1d(jnp.asarray(u), jnp.asarray(v))),
                               rtol=1e-5)


def test_wasserstein_1d_ties():
    """Repeated values: the merged grid's zero steps and ``side="right"``."""
    u = np.array([0.0, 0.0, 1.0, 2.0, 2.0], np.float32)
    v = np.array([0.0, 1.0, 1.0, 3.0], np.float32)
    got = float(TD.wasserstein_1d(torch.from_numpy(u), torch.from_numpy(v)))
    np.testing.assert_allclose(got, wasserstein_distance(u, v), rtol=1e-6)


@pytest.mark.parametrize("n2", [100, 90])
def test_pca_wasserstein(n2):
    rng = np.random.default_rng(n2)
    f1 = rng.standard_normal((100, 30)).astype(np.float32)
    f2 = (rng.standard_normal((n2, 30)) * 1.5).astype(np.float32)
    got = float(TD.pca_wasserstein_distance(torch.from_numpy(f1), torch.from_numpy(f2)))
    k = 30  # min(50, d)
    p = PCA(n_components=k)
    p1 = p.fit_transform(f1.astype(np.float64))
    p2 = p.transform(f2.astype(np.float64))
    want = np.mean([wasserstein_distance(p1[:, i], p2[:, i]) for i in range(k)])
    np.testing.assert_allclose(got, want, rtol=1e-3)
    jax_val = float(JD.pca_wasserstein_distance(jnp.asarray(f1), jnp.asarray(f2)))
    np.testing.assert_allclose(got, jax_val, rtol=1e-3)
    # at 10 components, as the JAX test asks
    got10 = float(TD.pca_wasserstein_distance(torch.from_numpy(f1), torch.from_numpy(f2), 10))
    p = PCA(n_components=10)
    q1 = p.fit_transform(f1.astype(np.float64))
    q2 = p.transform(f2.astype(np.float64))
    want10 = np.mean([wasserstein_distance(q1[:, i], q2[:, i]) for i in range(10)])
    np.testing.assert_allclose(got10, want10, rtol=1e-3)


def test_pca_signs_follow_svd_flip():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((60, 12)) @ rng.standard_normal((12, 12))).astype(np.float32)
    proj, mean, comps = TD.pca_fit_transform(torch.from_numpy(x), 5)
    c = comps.numpy()
    rows = np.arange(5)
    assert np.all(c[rows, np.abs(c).argmax(1)] > 0)
    want = PCA(n_components=5).fit_transform(x.astype(np.float64))
    np.testing.assert_allclose(proj.numpy(), want, atol=1e-3 * np.abs(want).max())
    np.testing.assert_allclose(TD.pca_transform(torch.from_numpy(x), mean, comps).numpy(),
                               proj.numpy(), atol=1e-5)


def test_mean_feature_distance():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((50, 2048)).astype(np.float32)
    b = (rng.standard_normal((41, 2048)) + 0.1).astype(np.float32)
    got = float(TD.mean_feature_distance(torch.from_numpy(a), torch.from_numpy(b)))
    want = np.linalg.norm(a.astype(np.float64).mean(0) - b.astype(np.float64).mean(0))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        got, float(JD.mean_feature_distance(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
