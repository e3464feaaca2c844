"""K3's redesigned arithmetic, emulated in torch on the CPU.

The CUDA kernel (``csrc/pairwise.cu``) cannot run here, so these tests
repeat its arithmetic step by step and hold it to float64 and to the JAX
package:

* the TF32 split: hi = tf32_rn(x), lo = tf32_rn(x - hi), rounding to
  nearest even on the float32 bits;
* the 3xTF32 Gram in the kernel's accumulation structure: per 8-feature
  step, hi*hi into one float32 accumulator and hi*lo + lo*hi into another;
  d2 = (sq_i + sq_j) - 2 g in float32 with sq from float64;
* the band rule: a pair with |d2 - eps^2| <= tau_ij is redecided by the
  direct form in float32, every other pair is decided by d2 <= eps^2, with
  tau_ij = ``band_tau_coef(D') * (sq_i + sq_j)``;
* pass 2 from the packed upper-triangle adjacency in the kernel's layout
  (128 x 128 tile pairs in the triangle's row-major order, 4 words a row).

Outside the band the emulated decisions must equal float64's exactly, on
data whose squared norms dwarf eps^2 and with many pairs near eps.  This
proves tau for the emulation's summation order, not for the tensor cores'
(``chip_smoke.py`` measures the kernel's own error against tau).  Counts
and non-noise masks are compared exactly on data with no pair within 5e-6
(relative) of eps^2, where float64 and the direct form cannot disagree.
"""
import numpy as np
import pytest
import torch

from strainer_gan_tpu.ops import dbscan as JDB

from strainer_gan_tpu_torch.kernels import pairwise as KP

STEP = 8  # features per mma.sync step (m16n8k8)


def tf32_rne(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32's 10 mantissa bits, ties to even."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    r = torch.where((u & 0x7F800000) == 0x7F800000, u, r)
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rne(x)
    return hi, tf32_rne(x - hi)


def gram_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = split(a)
    bh, bl = split(b)
    big = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32)
    small = torch.zeros_like(big)
    for k in range(0, a.shape[1], STEP):
        s = slice(k, k + STEP)
        small = small + ah[:, s] @ bl[:, s].T
        small = small + al[:, s] @ bh[:, s].T
        big = big + ah[:, s] @ bh[:, s].T
    return big + small


def pad(x: torch.Tensor) -> torch.Tensor:
    dp = -(-x.shape[1] // KP.FEATURE_STEP) * KP.FEATURE_STEP
    return torch.nn.functional.pad(x, (0, dp - x.shape[1]))


def decide(x: torch.Tensor, eps: float):
    """The kernel's decisions for all pairs: (adjacency, band mask)."""
    xp = pad(x)
    eps2 = KP.eps_squared(eps)
    sq = (x.double() ** 2).sum(1).float()
    s2 = sq[:, None] + sq[None, :]
    d2 = s2 - 2.0 * gram_3xtf32(xp, xp)
    band = (d2 - eps2).abs() <= KP.band_tau_coef(xp.shape[1]) * s2
    band.fill_diagonal_(False)  # self: d2 = 0, decided without arithmetic
    direct = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)  # float32
    adj = torch.where(band, direct <= eps2, d2 <= eps2)
    adj.fill_diagonal_(True)
    return adj, band


def exact_adjacency(x: torch.Tensor, eps: float) -> torch.Tensor:
    x64 = x.double()
    return ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1) <= KP.eps_squared(eps)


def counts_from(adj, valid, w):
    out = (adj.double() @ w.double()).float()
    return out if valid is None else torch.where(valid, out, torch.zeros_like(out))


def adversarial(n, d, seed, offset):
    """Clusters around centres with |c|^2 far above eps^2, spread so that
    within-cluster d2 sits around eps^2 = 4."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, d)) * 3.0 + offset
    x = centers[rng.integers(0, 6, n)] + rng.normal(size=(n, d)) * np.sqrt(2.0 / d)
    return torch.from_numpy(x.astype(np.float32)), rng


def clear_eps(x: torch.Tensor, near: float, band: float = 1e-4) -> float:
    """An eps near ``near`` with no pair's d2 within ``band`` of eps^2."""
    x64 = x.double()
    d2 = ((x64[:, None] - x64[None]) ** 2).sum(-1)
    pairs = torch.sort(d2[torch.triu_indices(len(x), len(x), 1).unbind()]).values
    i = int(torch.searchsorted(pairs, torch.tensor(near * near, dtype=torch.float64)))
    while pairs[i + 1] <= pairs[i] * (1 + 3 * band):
        i += 1
    eps = float(torch.sqrt(pairs[i] * pairs[i + 1]) ** 0.5)  # d2 halfway, in ratio
    assert not bool(((d2 - KP.eps_squared(eps)).abs() <= band * eps * eps).any())
    return eps


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_rounds_to_nearest_even(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(20000) * 10.0 ** rng.integers(-3, 4, 20000))
                         .astype(np.float32))
    ties = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11)],
                        dtype=torch.float32)
    x = torch.cat([x, ties, torch.tensor([0.0, -0.0, float("inf"), 3.4e38])])
    hi, lo = split(x)
    # hi and lo are TF32 values, and x = hi + lo to within 2^-22 |x|
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    fin = torch.isfinite(x) & torch.isfinite(hi)
    x64 = x[fin].double()
    assert bool(((x64 - hi[fin].double()).abs() <= 2.0 ** -11 * x64.abs()).all())
    assert bool(((x64 - hi[fin].double() - lo[fin].double()).abs()
                 <= 2.0 ** -22 * x64.abs()).all())
    # nearest: no TF32 neighbour of hi is closer; ties go to the even mantissa
    step = (hi[fin].double().abs().log2().floor() - 10).exp2()
    assert bool(((x64 - hi[fin].double()).abs() <= step / 2).all())
    t = tf32_rne(ties)
    assert t.tolist() == [1.0, 1.0 + 4 * 2.0 ** -11, -1.0]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,d,offset", [(1200, 64, 40.0), (700, 48, 200.0), (2000, 16, 10.0)])
def test_band_rule_matches_float64_off_the_band(n, d, offset, masked):
    x, rng = adversarial(n, d, n + d, offset)
    eps = 2.0
    adj, band = decide(x, eps)
    exact = exact_adjacency(x, eps)
    off = ~band
    assert torch.equal(adj[off], exact[off])
    # the data is hard: many pairs near eps, norms far above eps^2 ...
    assert int(band.sum()) > 100 and float((x.double() ** 2).sum(1).min()) > 100 * eps * eps
    # ... so without the band the 3xTF32 decisions would differ from float64
    xp = pad(x)
    sq = (x.double() ** 2).sum(1).float()
    s2 = sq[:, None] + sq[None, :]
    d2 = s2 - 2.0 * gram_3xtf32(xp, xp)
    assert bool(((d2 <= KP.eps_squared(eps)) != exact).any())
    # the emulation's own error, in units of sq_i + sq_j, is inside tau
    x64 = x.double()
    d2_64 = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    worst = float(((d2.double() - d2_64).abs() / s2.double()).max())
    assert worst <= KP.band_tau_coef(xp.shape[1]), worst
    # counts on 400 of the rows: the band's pairs, redecided in the direct
    # form (float32 error <= D 2^-24 d2 < 4e-6 d2 here), agree too when no
    # pair lies within 5e-6 of eps^2
    x, n = x[:400], 400
    eps = clear_eps(x, 2.0, band=5e-6)
    adj, band = decide(x, eps)
    valid = torch.from_numpy(rng.uniform(size=n) > 0.25) if masked else None
    w = valid if valid is not None else torch.ones(n, dtype=torch.bool)
    assert int(band.sum()) > 0
    got = counts_from(torch.triu(adj) | torch.triu(adj, 1).T, valid, w)  # symmetric half
    want = KP.neighbor_counts_plain(x.double(), eps, valid)
    assert torch.equal(got, want)


def pack_upper(adj: torch.Tensor) -> torch.Tensor:
    """The kernel's packed adjacency: per tile pair (I <= J), row-major over
    the triangle, 128 rows of 4 int32 words; bit b of word c of row r is
    pair (128 I + r, 128 J + 32 c + b), kept for j >= i."""
    n, t = adj.shape[0], KP.TILE
    t1 = -(-n // t)
    full = torch.zeros((t1 * t, t1 * t), dtype=torch.bool)
    full[:n, :n] = torch.triu(adj)
    bits = (1 << torch.arange(32, dtype=torch.int64))
    words = []
    for i in range(t1):
        for j in range(i, t1):
            blk = full[i * t:(i + 1) * t, j * t:(j + 1) * t].reshape(t, 4, 32).to(torch.int64)
            words.append((blk * bits).sum(-1).flatten())
    out = torch.cat(words)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def near_core_from_words(words: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Pass 2 as the kernel does it, on the words: a row is near a core
    column through its own words, a column through a core row's words."""
    n, t = core.shape[0], KP.TILE
    t1 = -(-n // t)
    cpad = torch.zeros(t1 * t, dtype=torch.bool)
    cpad[:n] = core
    bits = 1 << torch.arange(32, dtype=torch.int64)
    core_words = (cpad.reshape(t1, 4, 32).to(torch.int64) * bits).sum(-1)  # (t1, 4)
    near = torch.zeros(t1 * t, dtype=torch.bool)
    w = words.to(torch.int64) & 0xFFFFFFFF
    idx = 0
    for i in range(t1):
        for j in range(i, t1):
            tile = w[idx * KP.TILE_WORDS:(idx + 1) * KP.TILE_WORDS].reshape(t, 4)
            near[i * t:(i + 1) * t] |= ((tile & core_words[j]) != 0).any(1)
            rows_core = cpad[i * t:(i + 1) * t, None]
            cols = torch.zeros(4, dtype=torch.int64)
            for c in range(4):
                cols[c] = int(np.bitwise_or.reduce(torch.where(rows_core[:, 0], tile[:, c],
                                                               0).numpy()))
            near[j * t:(j + 1) * t] |= ((cols[:, None] & bits) != 0).flatten()
            idx += 1
    return near[:n]


@pytest.mark.parametrize("n,masked", [(1000, False), (1000, True), (257, True), (90, False)])
def test_bitmask_pass2_matches_the_plain_noise_test(n, masked):
    rng = np.random.default_rng(n)
    centers = rng.normal(size=(n // 40 + 1, 16)) * 3.0
    x = centers[rng.integers(0, len(centers), n)] + rng.normal(size=(n, 16)) * 0.4
    x[rng.choice(n, n // 5, replace=False)] = rng.normal(size=(n // 5, 16)) * 3.0
    x = torch.from_numpy(x.astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=n) > 0.2) if masked else None
    eps = clear_eps(x, float(np.sqrt(2 * 16 * 0.16)))
    adj = exact_adjacency(x, eps)
    words = pack_upper(adj)
    t1 = -(-n // KP.TILE)
    assert words.shape == (t1 * (t1 + 1) // 2 * KP.TILE_WORDS,)
    v = valid if valid is not None else torch.ones(n, dtype=torch.bool)
    counts = counts_from(adj, valid, v)
    core = (counts >= 3) & v
    non_noise = (core | near_core_from_words(words, core)) & v
    want = KP.dbscan_non_noise_plain(x.double(), eps, 3, valid)
    assert torch.equal(non_noise, want)
    assert 0 < int(want.sum()) < int(v.sum())
    # and the JAX package's default agrees
    jax_mask = np.asarray(JDB._dbscan_non_noise_jnp(
        x.numpy(), eps, 3, None if valid is None else valid.numpy()))
    np.testing.assert_array_equal(non_noise.numpy(), jax_mask)
