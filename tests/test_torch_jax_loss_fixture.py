"""The JAX package's loss-space, AE and in-step strain decisions on seeded
inputs, kept as a fixture, and the port's plain path held to them (CPU).

``chip_smoke.py::loss_fixture_inputs`` makes the inputs with numpy from a
fixed seed: 40,000 bimodal D losses with a ``valid`` mask, 16,384
AE-like reconstruction errors, and two 128-lane batches of D scores (a
full one and a partial tail of 77 valid lanes).
``tests/fixtures/torch_port_jax_loss_masks.npz`` holds the SHA-256 of each
input and what the JAX package computes from them on the CPU:

* `strain/thresholds.py:101` ``gmm_mask`` and `:109` ``ensemble_mask``
  (masks and thresholds), with and without ``valid``;
* `strain/engine.py:45` ``_truncate_in_order`` of the ensemble mask at the
  ``loss_ensemble`` clean ratios 0.9 and 0.7, with the keep count as the
  engine computes it (`engine.py:222`);
* `ops/stats.py:99` ``iqr_threshold``, with and without ``valid``;
* `strain/thresholds.py:166` ``ae_error_mask`` (sigma 2);
* the in-step keep of `train/steps.py:178-184`: ``quantile`` at 0.1 on the
  full batch and ``masked_quantile`` on the tail's valid lanes, and
  ``scores >= thr``.

Here the JAX outputs are computed again and must equal the file bit for
bit, and the port's plain path must flip no decision against it (its GMM
and ensemble thresholds differ from JAX's in the last bits, its sums run
in another order; each check prints the nearest score's margin).
``chip_smoke.py`` holds the card to the same file.  To write it again
after a deliberate change of the inputs or of the JAX package, from the
repo root:

    JAX_PLATFORMS=cpu python -m tests.test_torch_jax_loss_fixture
"""
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.ops import stats as JS
from strainer_gan_tpu.strain import engine as JE, thresholds as JTH

from strainer_gan_tpu_torch.ops import stats as PS
from strainer_gan_tpu_torch.strain import engine as PE, thresholds as PTH

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

MASKS = ("all", "valid")
Q = 0.1  # batch_mask's mask_quantile


def jax_outputs(inputs: dict) -> dict:
    """Everything the fixture holds, from the JAX package on the CPU."""
    out = {f"sha256_{k}": np.array(v) for k, v in smoke.input_digests(inputs).items()}
    x = jnp.asarray(inputs["losses"])
    for m in MASKS:
        v = jnp.asarray(inputs["loss_valid"]) if m == "valid" else None
        for name, fn in (("gmm", JTH.gmm_mask), ("ensemble", JTH.ensemble_mask)):
            mask, thr = fn(x, v)
            out[f"{name}_{m}"] = np.asarray(mask)
            out[f"{name}_thr_{m}"] = np.asarray(thr, np.float32)
        out[f"iqr_{m}"] = np.asarray(JS.iqr_threshold(x, v), np.float32)
    ens = jnp.asarray(out["ensemble_all"])
    for r in smoke.LOSS_FIXTURE_RATIOS:
        count = (jnp.sum(ens) * r).astype(jnp.int32)
        out[f"trunc_count_{r}"] = np.asarray(count)
        out[f"trunc_{r}"] = np.asarray(JE._truncate_in_order(ens, count))
    mask, thr = JTH.ae_error_mask(jnp.asarray(inputs["ae_errors"]), 2.0)
    out["ae"], out["ae_thr"] = np.asarray(mask), np.asarray(thr, np.float32)
    full, tail = (jnp.asarray(b) for b in inputs["batch_scores"])
    thr = JS.quantile(full, Q)
    out["keep_full"], out["keep_thr_full"] = np.asarray(full >= thr), np.asarray(thr)
    valid = jnp.arange(tail.shape[0]) < smoke.LOSS_FIXTURE_TAIL
    thr = JS.masked_quantile(tail, valid, Q)
    out["keep_tail"] = np.asarray(jnp.logical_and(tail >= thr, valid))
    out["keep_thr_tail"] = np.asarray(thr)
    return out


@pytest.fixture(scope="module")
def inputs():
    return smoke.loss_fixture_inputs()


@pytest.fixture(scope="module")
def stored():
    with np.load(smoke.JAX_LOSS_FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def recomputed(inputs):
    return jax_outputs(inputs)


GROUPS = ("sha256", "gmm", "ensemble", "iqr", "trunc", "ae", "keep")


@pytest.mark.parametrize("group", GROUPS)
def test_fixture_equals_the_jax_package(stored, recomputed, group):
    keys = sorted(k for k in recomputed if k.split("_")[0] == group)
    assert keys and keys == sorted(k for k in stored if k.split("_")[0] == group)
    for k in keys:
        a, b = stored[k], recomputed[k]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def test_fixture_decisions_are_interior(stored):
    for k in ("gmm_all", "gmm_valid", "ensemble_all", "ensemble_valid", "ae", "trunc_0.9",
              "trunc_0.7", "keep_full", "keep_tail"):
        assert 0 < stored[k].sum() < stored[k].size, k
    assert stored["keep_tail"][smoke.LOSS_FIXTURE_TAIL:].sum() == 0


def _check(got_mask, got_thr, stored, key, scores, rel=1e-5):
    want_thr = float(stored[key.replace("_", "_thr_", 1) if "_" in key else key + "_thr"])
    assert abs(float(got_thr) - want_thr) <= rel * abs(want_thr), key
    d = np.abs(scores.astype(np.float64) - want_thr)
    print(f"{key}: threshold {float(got_thr):.9g} (JAX {want_thr:.9g}), nearest margin "
          f"{d[d > 0].min():.3g}")
    assert int((got_mask.numpy() != stored[key]).sum()) == 0, key


@pytest.mark.parametrize("m", MASKS)
def test_port_plain_loss_space_flips_nothing(inputs, stored, m):
    x = torch.from_numpy(inputs["losses"])
    v = torch.from_numpy(inputs["loss_valid"]) if m == "valid" else None
    for name, fn in (("gmm", PTH.gmm_mask), ("ensemble", PTH.ensemble_mask)):
        mask, thr = fn(x, v)
        _check(mask, thr, stored, f"{name}_{m}", inputs["losses"])
    assert PS.iqr_threshold(x, v).numpy().tobytes() == stored[f"iqr_{m}"].tobytes()


@pytest.mark.parametrize("ratio", smoke.LOSS_FIXTURE_RATIOS)
def test_port_truncation_equals_jax(stored, ratio):
    ens = torch.from_numpy(stored["ensemble_all"])
    count = PE.keep_count(ens, ratio)
    assert int(count) == int(stored[f"trunc_count_{ratio}"])
    np.testing.assert_array_equal(PE._truncate_in_order(ens, count).numpy(),
                                  stored[f"trunc_{ratio}"])


def test_port_ae_and_in_step_keeps_flip_nothing(inputs, stored):
    mask, thr = PTH.ae_error_mask(torch.from_numpy(inputs["ae_errors"]), 2.0)
    _check(mask, thr, stored, "ae", inputs["ae_errors"], rel=1e-6)
    full, tail = (torch.from_numpy(b) for b in inputs["batch_scores"])
    thr = PS.quantile(full, Q)
    assert thr.numpy().tobytes() == stored["keep_thr_full"].tobytes()
    np.testing.assert_array_equal((full >= thr).numpy(), stored["keep_full"])
    valid = torch.arange(tail.shape[0]) < smoke.LOSS_FIXTURE_TAIL
    thr = PS.masked_quantile(tail, valid, Q)
    assert thr.numpy().tobytes() == stored["keep_thr_tail"].tobytes()
    np.testing.assert_array_equal(((tail >= thr) & valid).numpy(), stored["keep_tail"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py
    np.savez_compressed(smoke.JAX_LOSS_FIXTURE, **jax_outputs(smoke.loss_fixture_inputs()))
    print(f"wrote {smoke.JAX_LOSS_FIXTURE} ({smoke.JAX_LOSS_FIXTURE.stat().st_size} bytes)")
