"""The port's kernel functions against the JAX package (CPU).

K1 (per-sample BCE) and K2 (masked max-|z|) run here through their plain
PyTorch versions, which is what the wrappers take for CPU tensors; the
CUDA kernels themselves are held against the same plain versions on the
card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.kernels.bce import bce_scores_pallas
from strainer_gan_tpu.kernels.zscore import max_abs_zscores_pallas
from strainer_gan_tpu.ops import losses as JL
from strainer_gan_tpu.strain import thresholds as JTH

from strainer_gan_tpu_torch import kernels as K
from strainer_gan_tpu_torch.kernels import bce as KB
from strainer_gan_tpu_torch.kernels import pairwise as KP
from strainer_gan_tpu_torch.kernels import zscore as KZ
from strainer_gan_tpu_torch.strain import thresholds as TTH

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _logits(rng):
    # bulk + the clamp region (|x| near 100, where p saturates or is flushed)
    return np.concatenate([
        rng.standard_normal(3000) * 8,
        rng.uniform(-110.0, 110.0, 1000),
        [100.0, -100.0, 99.5, -99.5, 87.3, -87.3, -88.0, 30.0, -30.0, 120.0, -120.0, 0.0],
    ]).astype(np.float32)


@pytest.mark.parametrize("target", [1.0, 0.0, 0.9])
def test_bce_plain_matches_jax_and_pallas(rng, target):
    x = _logits(rng)
    launches = KB.bce_scores.launches
    got = KB.bce_scores(torch.from_numpy(x), target).numpy()
    want = np.asarray(JL.bce_from_logits(jnp.asarray(x), target))
    pallas = np.asarray(bce_scores_pallas(jnp.asarray(x), target, interpret=True))
    # 1e-6 relative to max(1, |loss|): sigmoid's float32 rounding may differ
    # by an ulp between XLA and torch, which log1p(-p) scales by the loss
    for ref in (want, pallas):
        assert np.all(np.abs(got - ref) <= 1e-6 * np.maximum(1.0, np.abs(ref)))
    assert KB.bce_scores.launches == launches  # CPU tensors never reach the kernel


@pytest.mark.parametrize("target", [1.0, 0.9])
def test_bce_into_out(rng, target):
    x = _logits(rng)
    want = np.asarray(JL.bce_from_logits(jnp.asarray(x), target))
    out = torch.empty(x.shape[0])
    got = KB.bce_scores(torch.from_numpy(x), target, out=out)
    assert got is out
    assert np.all(np.abs(out.numpy() - want) <= 1e-6 * np.maximum(1.0, np.abs(want)))
    inplace = torch.from_numpy(x.copy())
    assert KB.bce_scores(inplace, target, out=inplace) is inplace
    assert torch.equal(inplace, out)
    for bad in (torch.empty(x.shape[0] - 1), torch.empty(x.shape[0], dtype=torch.float64),
                torch.empty((x.shape[0], 1)), torch.empty(2 * x.shape[0])[::2]):
        with pytest.raises((ValueError, TypeError)):
            KB.bce_scores(torch.from_numpy(x), target, out=bad)


def _features(rng, n=300, d=40):
    f = (rng.standard_normal((n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(0, 2, d))
    f = f.astype(np.float32)
    f[:, 3] = 1.25  # a zero-std column: z = 0 there, not NaN
    f[rng.choice(n, 5, replace=False)] += 9.0  # a few outlier rows
    return f


@pytest.mark.parametrize("std_mode", ["torch", "numpy_eps"])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_max_abs_z_plain_matches_jax(rng, std_mode, masked):
    f = _features(rng)
    valid = rng.uniform(size=f.shape[0]) > 0.1 if masked else None
    want = np.asarray(JTH._masked_max_abs_z(
        jnp.asarray(f), None if valid is None else jnp.asarray(valid), std_mode))
    tv = None if valid is None else torch.from_numpy(valid)
    plain = TTH._masked_max_abs_z(torch.from_numpy(f), tv, std_mode).numpy()
    via_wrappers = TTH.masked_max_abs_z(torch.from_numpy(f), tv, std_mode).numpy()
    assert np.isfinite(plain).all()
    np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(via_wrappers, plain)
    mask, thr = TTH.zscore_fixed_mask(torch.from_numpy(f), 3.0, std_mode, True, tv)
    jmask, _ = JTH.zscore_fixed_mask(jnp.asarray(f), 3.0, std_mode, True,
                                     None if valid is None else jnp.asarray(valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("std_mode", ["torch", "numpy_eps"])
def test_masked_max_abs_z_plain_matches_pallas_template(rng, std_mode):
    f = rng.standard_normal((300, 64)).astype(np.float32) * 2.0 + 0.5
    want = np.asarray(max_abs_zscores_pallas(jnp.asarray(f), std_mode, block_rows=64,
                                             interpret=True))
    got = TTH._masked_max_abs_z(torch.from_numpy(f), None, std_mode).numpy()
    # 1e-4: the template's one-pass sum/sumsq variance is less exact
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_wrappers_check_their_inputs():
    f = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        KB.bce_scores(torch.zeros(4, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):
        KB.bce_scores(torch.zeros((2, 2)), 1.0)
    with pytest.raises(ValueError):
        KZ.column_stats(f.t(), None)  # not contiguous
    with pytest.raises(ValueError):
        KZ.column_stats(f, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        KZ.row_max_abs_z(f, torch.zeros(2), torch.ones(3))
    with pytest.raises(ValueError):
        KP.neighbor_counts(f, 1.0, torch.ones(3, dtype=torch.bool))
    with pytest.raises(TypeError):
        KP.neighbor_counts(f, 1.0, None, torch.ones(4))  # weights must be bool
    assert set(K.launch_counts()) == {"bce_scores", "zscore_column_stats", "zscore_row_max",
                                      "neighbor_counts"}
