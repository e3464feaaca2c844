"""K2a's redesigned arithmetic, emulated in torch on the CPU.

The CUDA kernel (``csrc/zscore.cu``) cannot run here, so this test repeats
its two launches step by step:

* the column pass: rows cut into chunks, each chunk's rows dealt to 4 row
  groups; each group runs Welford's update in float32 (count, mean, M2;
  ``mean += delta * rcp(count)`` and ``M2 += delta * (x - mean)`` as fused
  multiply-adds); the 4 groups merge with Chan's formula in double, and the
  chunk writes float32 (mean, M2) and an integer count;
* the finish: 32 lanes per column, lane y merging partials y, y + 32, ...
  in double, then a fixed tree over the lanes (16, 8, 4, 2, 1 apart).

The emulated statistics must equal the JAX package's within 1e-6 of
max(1, |ref|): the mean and std of `strainer_gan_tpu/strain/thresholds.py:25-48`
``_masked_max_abs_z`` ("torch" and "numpy_eps") and of
`strainer_gan_tpu/ops/dbscan.py:25-36` ``standardize`` ("population"),
masked and unmasked, with a constant column (whose std must be exactly the
mode's eps) and a mask with no valid row.  The max-|z| taken from them
must match ``_masked_max_abs_z`` within 1e-5 of max(1, |ref|).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.strain import thresholds as JTH

from strainer_gan_tpu_torch.kernels import zscore as KZ
from strainer_gan_tpu_torch.ops.stats import fma_f32

ROW_GROUPS, FIN_LANES = 4, 32


def chan(a, b):
    """Merge (n, mean, M2) b into a, in double; empty b leaves a."""
    na, ma, qa = a
    nb, mb, qb = b
    if nb == 0:
        return a
    n = na + nb
    delta = mb - ma
    f = nb / n
    return n, ma + delta * f, qa + qb + delta * delta * na * f


def column_pass(f: torch.Tensor, valid, chunks: int):
    n, d = f.shape
    rows_per_chunk = -(-n // chunks)
    parts = []
    for r0 in range(0, n, rows_per_chunk):
        groups = []
        for g in range(ROW_GROUPS):
            cnt, mean, m2 = 0, torch.zeros(d), torch.zeros(d)
            for r in range(r0 + g, min(r0 + rows_per_chunk, n), ROW_GROUPS):
                if valid is not None and not bool(valid[r]):
                    continue
                cnt += 1
                inv = torch.full((d,), 1.0 / cnt, dtype=torch.float32)
                delta = f[r] - mean
                mean = fma_f32(delta, inv, mean)
                m2 = fma_f32(delta, f[r] - mean, m2)
            groups.append((float(cnt), mean.double(), m2.double()))
        acc = groups[0]
        for grp in groups[1:]:
            acc = chan(acc, grp)
        parts.append((acc[0], acc[1].float().double(), acc[2].float().double()))
    return parts


def finish(parts, bessel: bool, eps: float):
    d = parts[0][1].shape[0]
    zero = (0.0, torch.zeros(d, dtype=torch.float64), torch.zeros(d, dtype=torch.float64))
    lanes = []
    for y in range(FIN_LANES):
        acc = zero
        for k in range(y, len(parts), FIN_LANES):
            acc = chan(acc, parts[k])
        lanes.append(acc)
    half = FIN_LANES // 2
    while half:
        lanes = [chan(lanes[y], lanes[y + half]) for y in range(half)]
        half //= 2
    n, mean, m2 = lanes[0]
    nv = max(n, 1.0)
    denom = max(nv - 1.0, 1.0) if bessel else nv
    std = torch.sqrt(m2 / denom).float() + torch.tensor(eps, dtype=torch.float32)
    return mean.float(), std


def jax_stats(f: np.ndarray, valid, mode: str):
    """The JAX package's statistics: `thresholds.py:33-45` for "torch" and
    "numpy_eps", `ops/dbscan.py:27-34` for "population"."""
    x = jnp.asarray(f)
    if mode == "population" and valid is None:
        return np.asarray(jnp.mean(x, axis=0)), np.asarray(jnp.std(x, axis=0))
    w = (jnp.ones((f.shape[0], 1), jnp.float32) if valid is None
         else jnp.asarray(valid).astype(jnp.float32)[:, None])
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(x * w, axis=0) / n
    sq = jnp.sum(w * (x - mean) ** 2, axis=0)
    if mode == "torch":
        std = jnp.sqrt(sq / jnp.maximum(n - 1.0, 1.0))
    elif mode == "numpy_eps":
        std = jnp.sqrt(sq / n) + 1e-7
    else:
        std = jnp.sqrt(sq / n)
    return np.asarray(mean), np.asarray(std)


@pytest.mark.parametrize("mode", ["torch", "numpy_eps", "population"])
@pytest.mark.parametrize("n,d,chunks,mask", [(1000, 40, 7, None), (1000, 40, 7, "some"),
                                               (37, 8, 3, "some"), (300, 12, 40, "none")])
def test_chan_merge_matches_the_jax_statistics(mode, n, d, chunks, mask):
    rng = np.random.default_rng(n + d + chunks)
    f = (rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.uniform(-2, 2, d))
    f[:, 1] = 2.75  # a constant column
    f = f.astype(np.float32)
    valid = {None: None, "some": rng.uniform(size=n) > 0.3,
             "none": np.zeros(n, dtype=bool)}[mask]
    bessel, eps = KZ._std_mode(mode)
    vt = None if valid is None else torch.from_numpy(valid)
    mean, std = finish(column_pass(torch.from_numpy(f), vt, chunks), bessel, eps)
    want_mean, want_std = jax_stats(f, valid, mode)
    for got, want in ((mean.numpy(), want_mean), (std.numpy(), want_std)):
        assert np.all(np.abs(got - want) <= 1e-6 * np.maximum(1.0, np.abs(want)))
    assert float(std[1]) == float(np.float32(eps))  # the mode's eps, exactly
    if mode != "population":
        z = KZ.row_max_abs_z_plain(torch.from_numpy(f), mean, std).numpy()
        want_z = np.asarray(JTH._masked_max_abs_z(jnp.asarray(f),
                                                  None if valid is None else jnp.asarray(valid),
                                                  mode))
        assert np.all(np.abs(z - want_z) <= 1e-5 * np.maximum(1.0, np.abs(want_z)))
