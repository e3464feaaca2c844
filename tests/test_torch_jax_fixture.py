"""The JAX package's strain decisions on seeded inputs, kept as a fixture,
and the port's plain path held to them (CPU).

``chip_smoke.py::fixture_inputs`` makes the inputs with numpy from a fixed
seed: 4,096 x 512 clustered features with a ``valid`` mask, and 8,192 D
logits with a ``valid`` mask.  ``tests/fixtures/torch_port_jax_masks.npz``
holds the SHA-256 of each input and what the JAX package computes from
them on the CPU:

* `strain/thresholds.py:25` ``_masked_max_abs_z`` in the "torch" and
  "numpy_eps" std modes, with and without ``valid``, and from it the
  masks and thresholds of `:51` ``zscore_fixed_mask`` at 5.0, `:63`
  ``zscore_elbow_mask`` and `:81` ``zscore_quantile_mask`` at `:96`
  ``dbscan_clean_ratio`` (eps 20, min_samples 3);
* for the clean ratio, the non-noise counts of a float64 DBSCAN of the
  JAX package's standardised features at eps^2 (1 -/+ 1e-4), a sandwich
  that any exact decision of the float32 distances lies in;
* `ops/losses.py:22` ``bce_from_logits`` at targets 1.0 and 0.9, and
  `strain/thresholds.py:121` ``percentile_refine_mask`` on those losses at
  ``loss_ratio`` 0.8 (the `final` preset's schedule at epoch 3).

Here the JAX outputs are computed again and must equal the file bit for
bit, so it cannot go stale, and the port's plain versions (what its
wrappers run on CPU tensors) must flip no decision against it.
``chip_smoke.py`` holds the card's kernels to the same file.  To write
the file again after a deliberate change of the inputs or of the JAX
package, from the repo root:

    JAX_PLATFORMS=cpu python -m tests.test_torch_jax_fixture
"""
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.ops import dbscan as JDB
from strainer_gan_tpu.ops import losses as JL
from strainer_gan_tpu.strain import thresholds as JTH

from strainer_gan_tpu_torch.kernels import bce as KB
from strainer_gan_tpu_torch.ops import dbscan as DB
from strainer_gan_tpu_torch.strain import thresholds as TTH

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

MODES = ("torch", "numpy_eps")
MASKS = ("all", "valid")
TARGETS = (1.0, 0.9)
Z_FIXED, EPS, MIN_SAMPLES, DELTA = 5.0, 20.0, 3, 1e-4


def _non_noise64(x: np.ndarray, eps2: float, valid: np.ndarray) -> np.ndarray:
    """DBSCAN's non-noise test in float64 (core: >= MIN_SAMPLES valid
    neighbours within eps, self included; non-noise: core or within eps of
    a core point; invalid rows neither count nor are counted)."""
    sq = (x * x).sum(1)
    adj = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)) <= eps2
    adj &= valid[None, :]
    core = (adj.sum(1) >= MIN_SAMPLES) & valid
    return (core | (adj & core[None, :]).any(1)) & valid


def jax_outputs(inputs: dict) -> dict:
    """Everything the fixture holds, from the JAX package on the CPU."""
    out = {f"sha256_{k}": np.array(v) for k, v in smoke.input_digests(inputs).items()}
    f = jnp.asarray(inputs["features"])
    for m in MASKS:
        v = jnp.asarray(inputs["valid"]) if m == "valid" else None
        ratio = JTH.dbscan_clean_ratio(f, EPS, MIN_SAMPLES, v)
        out[f"ratio_{m}"] = np.asarray(ratio, np.float32)
        xs = np.asarray(JDB.standardize(f, v), np.float64)
        keep = inputs["valid"] if m == "valid" else np.ones(xs.shape[0], bool)
        eps2 = float(np.float32(EPS)) ** 2
        out[f"sandwich_{m}"] = np.array([_non_noise64(xs, eps2 * (1 - DELTA), keep).sum(),
                                         _non_noise64(xs, eps2 * (1 + DELTA), keep).sum()])
        for mode in MODES:
            tag = f"{mode}_{m}"
            out[f"mz_{tag}"] = np.asarray(JTH._masked_max_abs_z(f, v, mode))
            for name, (mask, thr) in (
                    ("fixed", JTH.zscore_fixed_mask(f, Z_FIXED, mode, True, v)),
                    ("elbow", JTH.zscore_elbow_mask(f, mode, v)),
                    ("quantile", JTH.zscore_quantile_mask(f, ratio, mode, v))):
                out[f"{name}_{tag}"] = np.asarray(mask)
                out[f"{name}_thr_{tag}"] = np.asarray(thr, np.float32)
    loss_valid = jnp.asarray(inputs["loss_valid"])
    for t in TARGETS:
        losses = JL.bce_from_logits(jnp.asarray(inputs["logits"]), t)
        mask, thr = JTH.percentile_refine_mask(losses, smoke.FIXTURE_LOSS_RATIO, loss_valid)
        out[f"loss_{t}"] = np.asarray(losses)
        out[f"loss_mask_{t}"] = np.asarray(mask)
        out[f"loss_thr_{t}"] = np.asarray(thr, np.float32)
    return out


@pytest.fixture(scope="module")
def inputs():
    return smoke.fixture_inputs()


@pytest.fixture(scope="module")
def stored():
    with np.load(smoke.JAX_FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def recomputed(inputs):
    return jax_outputs(inputs)


GROUPS = ("sha256", "ratio", "sandwich", "mz", "fixed", "elbow", "quantile", "loss")


@pytest.mark.parametrize("group", GROUPS)
def test_fixture_equals_the_jax_package(stored, recomputed, group):
    keys = sorted(k for k in recomputed if k.startswith(group + "_"))
    assert keys and keys == sorted(k for k in stored if k.startswith(group + "_"))
    for k in keys:
        a, b = stored[k], recomputed[k]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def test_fixture_inputs_are_interior(stored):
    # the clean ratio is interior and no standardised pair distance lies in
    # the sandwich's band, so float32 rounding decides no DBSCAN pair
    for m in MASKS:
        lo, hi = stored[f"sandwich_{m}"]
        assert lo == hi and 0.3 < float(stored[f"ratio_{m}"]) < 0.9
    for mode in MODES:
        for m in MASKS:
            for name in ("fixed", "elbow", "quantile"):
                kept = int(stored[f"{name}_{mode}_{m}"].sum())
                assert 0 < kept < stored[f"{name}_{mode}_{m}"].size


def _flips(got: torch.Tensor, want: np.ndarray) -> int:
    return int((got.numpy() != want).sum())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", MASKS)
def test_port_plain_zscore_masks_flip_nothing(inputs, stored, mode, m):
    f = torch.from_numpy(inputs["features"])
    v = torch.from_numpy(inputs["valid"]) if m == "valid" else None
    tag = f"{mode}_{m}"
    mz = TTH.masked_max_abs_z(f, v, mode)
    want = stored[f"mz_{tag}"]
    assert np.all(np.abs(mz.numpy() - want) <= 1e-5 * np.maximum(1.0, np.abs(want)))
    mask, _ = TTH.zscore_threshold_mask(mz, Z_FIXED, True, v)
    assert _flips(mask, stored[f"fixed_{tag}"]) == 0
    mask, _ = TTH.zscore_elbow_mask(mz, v)
    assert _flips(mask, stored[f"elbow_{tag}"]) == 0
    ratio = DB.dbscan_clean_ratio(f, EPS, MIN_SAMPLES, v)
    assert float(ratio) == float(stored[f"ratio_{m}"])
    mask, _ = TTH.zscore_quantile_mask(mz, ratio, v)
    assert _flips(mask, stored[f"quantile_{tag}"]) == 0


@pytest.mark.parametrize("target", TARGETS)
def test_port_plain_loss_mask_flips_nothing(inputs, stored, target):
    losses = KB.bce_scores(torch.from_numpy(inputs["logits"]), target)
    want = stored[f"loss_{target}"]
    assert np.all(np.abs(losses.numpy() - want) <= 1e-6 * np.maximum(1.0, np.abs(want)))
    mask, _ = TTH.percentile_refine_mask(losses, smoke.FIXTURE_LOSS_RATIO,
                                         torch.from_numpy(inputs["loss_valid"]))
    assert _flips(mask, stored[f"loss_mask_{target}"]) == 0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py
    np.savez_compressed(smoke.JAX_FIXTURE, **jax_outputs(smoke.fixture_inputs()))
    print(f"wrote {smoke.JAX_FIXTURE} ({smoke.JAX_FIXTURE.stat().st_size} bytes)")
