"""The port's DBSCAN pieces and z-score statistics against the JAX package
and sklearn (CPU).

K3 runs here through its plain version, which is what the wrapper takes
for CPU tensors; the CUDA kernel is held to the same plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: neighbour counts and masks are compared exactly, on data built
so that no pair's squared distance lies within 1e-3 * eps^2 of eps^2 (the
float32 distance rounding, about 1e-6 relative, cannot cross eps there).
``quantile``, ``masked_quantile``, ``histogram_density`` and
``elbow_threshold`` are compared bit for bit (the strain masks compare
against them with ``<`` and ``<=``).  ``standardize`` is compared at 1e-5
of the largest magnitude: its sums are taken in another order.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.kernels.pairwise import dbscan_non_noise_pallas, neighbor_counts_pallas
from strainer_gan_tpu.ops import dbscan as JDB
from strainer_gan_tpu.ops import stats as JS

from strainer_gan_tpu_torch.kernels import pairwise as KP
from strainer_gan_tpu_torch.ops import dbscan as PDB
from strainer_gan_tpu_torch.ops import stats as PS

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BAND = 1e-3  # no pair's d2 within BAND * eps^2 of eps^2


def _clear_eps(x: np.ndarray, q: float) -> float:
    """An eps near the q-quantile of the pair distances whose band is empty."""
    x64 = x.astype(np.float64)
    d2 = ((x64[:, None] - x64[None, :]) ** 2).sum(-1)
    pairs = np.sort(d2[np.triu_indices(len(x), 1)])
    i = int(q * len(pairs))
    while pairs[i + 1] <= pairs[i] * (1 + 3 * BAND):
        i += 1
    eps2 = float(np.sqrt(pairs[i] * pairs[i + 1]))
    assert not np.any(np.abs(d2 - eps2) <= BAND * eps2)  # the band is empty
    return float(np.sqrt(eps2))


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal((90, 8)) * 0.3,
        rng.standard_normal((60, 8)) * 0.3 + 3.0,
        rng.standard_normal((50, 8)) * 4.0,
    ]).astype(np.float32)
    x = x[rng.permutation(len(x))]
    valid = rng.uniform(size=len(x)) > 0.15
    return x, _clear_eps(x, 0.05), valid


@pytest.mark.parametrize("masked", [False, True])
def test_plain_counts_match_the_pallas_kernel(clustered, masked):
    x, eps, valid = clustered
    v = valid if masked else None
    want = np.asarray(neighbor_counts_pallas(
        jnp.asarray(x), eps, None if v is None else jnp.asarray(v), bm=64, bn=64,
        interpret=True))
    got = KP.neighbor_counts(torch.from_numpy(x), eps,
                             None if v is None else torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    # column weights: the core points of the first pass
    core = (want >= 3) & (valid if masked else True)
    want_w = np.asarray(neighbor_counts_pallas(
        jnp.asarray(x), eps, None if v is None else jnp.asarray(v),
        col_weights=jnp.asarray(core, jnp.float32), bm=64, bn=64, interpret=True))
    got_w = KP.neighbor_counts(torch.from_numpy(x), eps,
                               None if v is None else torch.from_numpy(v),
                               col_weights=torch.from_numpy(core)).numpy()
    np.testing.assert_array_equal(got_w, want_w)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_non_noise_matches_jax_and_pallas(clustered, masked):
    x, eps, valid = clustered
    v = valid if masked else None
    jv = None if v is None else jnp.asarray(v)
    got = KP.dbscan_non_noise(torch.from_numpy(x), eps, 3,
                              None if v is None else torch.from_numpy(v)).numpy()
    want = np.asarray(JDB._dbscan_non_noise_jnp(jnp.asarray(x), eps, 3, jv, block=64))
    pallas = np.asarray(dbscan_non_noise_pallas(jnp.asarray(x), eps, 3, jv, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    assert 0 < got.sum() < (valid.sum() if masked else len(x))


@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_sklearn_dbscan(clustered, masked):
    from sklearn.cluster import DBSCAN

    x, eps, valid = clustered
    keep = valid if masked else np.ones(len(x), bool)
    labels = DBSCAN(eps=eps, min_samples=3).fit_predict(x[keep].astype(np.float64))
    got = KP.dbscan_non_noise(torch.from_numpy(x), eps, 3,
                              torch.from_numpy(valid) if masked else None).numpy()
    np.testing.assert_array_equal(got[keep], labels != -1)
    assert not got[~keep].any()
    # counts against a float64 brute force over the valid points
    x64 = x.astype(np.float64)
    d2 = ((x64[:, None] - x64[None, :]) ** 2).sum(-1)
    want = ((d2 <= eps ** 2) & keep[None, :]).sum(1) * keep
    got_c = KP.neighbor_counts(torch.from_numpy(x), eps,
                               torch.from_numpy(valid) if masked else None).numpy()
    np.testing.assert_array_equal(got_c, want.astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_standardize_and_clean_ratio_match_jax(clustered, masked):
    x, eps, valid = clustered
    x = x * np.linspace(0.5, 3.0, x.shape[1], dtype=np.float32) + 2.0
    x[:, 5] = 1.5  # a zero-std column: divided by 1, as StandardScaler does
    v = valid if masked else None
    jv = None if v is None else jnp.asarray(v)
    tv = None if v is None else torch.from_numpy(v)
    want = np.asarray(JDB.standardize(jnp.asarray(x), jv))
    got = PDB.standardize(torch.from_numpy(x), tv).numpy()
    assert float(np.abs(got - want).max()) <= 1e-5 * max(1.0, float(np.abs(want).max()))
    eps_s = _clear_eps(want, 0.05)
    ratio_j = float(JDB.dbscan_clean_ratio(jnp.asarray(x), eps_s, 3, jv))
    ratio_p = PDB.dbscan_clean_ratio(torch.from_numpy(x), eps_s, 3, tv)
    assert ratio_p.dtype == torch.float32 and float(ratio_p) == ratio_j
    assert 0.0 < ratio_j < 1.0


def _integer_position_qs(n):
    """q values whose float32 position q*(n-1) lies within 1 ulp of an
    integer, and the ends."""
    qs = [np.float32(0.0), np.float32(1.0)]
    for k in (1, n // 3, n // 2, n - 2):
        q = np.float32(k / (n - 1))
        qs += [q, np.nextafter(q, np.float32(0)), np.nextafter(q, np.float32(1))]
    return qs


@pytest.mark.parametrize("n", [2, 101, 1000])
def test_quantiles_match_jax_bitwise(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3.0 + 1.0).astype(np.float32)
    x[: n // 4] = np.round(x[: n // 4], 1)  # ties
    valid = rng.uniform(size=n) > 0.3
    valid[0] = True
    qs = _integer_position_qs(n) + [np.float32(q) for q in rng.uniform(size=20)]
    for q in qs:
        want = np.asarray(JS.quantile(jnp.asarray(x), jnp.asarray(q)))
        got = PS.quantile(torch.from_numpy(x), torch.tensor(q)).numpy()
        assert got.tobytes() == want.tobytes(), (n, q)
        want = np.asarray(JS.masked_quantile(jnp.asarray(x), jnp.asarray(valid),
                                             jnp.asarray(q)))
        got = PS.masked_quantile(torch.from_numpy(x), torch.from_numpy(valid),
                                 torch.tensor(q)).numpy()
        assert got.tobytes() == want.tobytes(), (n, q)


@pytest.mark.parametrize("case", ["normal", "heavy_tail", "ties", "constant"])
def test_elbow_threshold_matches_jax_bitwise(case):
    rng = np.random.default_rng(7)
    x = np.abs(rng.standard_normal(2000)).astype(np.float32) * 2.0 + 0.5
    if case == "heavy_tail":
        x = np.concatenate([x, rng.pareto(1.5, 200).astype(np.float32) * 5.0 + 4.0])
    elif case == "ties":
        x = np.round(x, 1)
    elif case == "constant":  # numpy widens the zero-width range
        x = np.full(50, 3.25, np.float32)
    want = [np.asarray(t) for t in JS.elbow_threshold(jnp.asarray(x))]
    got = [t.numpy() for t in PS.elbow_threshold(torch.from_numpy(x))]
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    dens_j, edges_j = JS.histogram_density(jnp.asarray(x))
    dens_p, edges_p = PS.histogram_density(torch.from_numpy(x))
    assert dens_p.numpy().tobytes() == np.asarray(dens_j).tobytes()
    assert edges_p.numpy().tobytes() == np.asarray(edges_j).tobytes()


def test_fma_f32_rounds_once():
    # a*b = 2^-24 (1 -/+ 2^-46) sits just off the float32 midpoint of c; a
    # float64 sum lands exactly on it, so rounding twice would tie to even
    f = np.float32
    a = np.full(4, 2.0 ** -24 * (1 + 2.0 ** -23), f)
    b = np.array([1 - 2.0 ** -23, 1 - 2.0 ** -23, 1 + 2.0 ** -23, 1 + 2.0 ** -23], f)
    odd, even = np.nextafter(f(1.5), f(2)), f(1.5)
    c = np.array([odd, even, odd, even], f)
    want = np.array([odd, even, np.nextafter(odd, f(2)), np.nextafter(even, f(2))], f)
    got = PS.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
