"""The port's Adam held to the JAX package's (CPU).

The JAX step scales ``optax.scale_by_adam(b1, b2, eps=1e-8)``'s update by
the rate itself (`strainer_gan_tpu/train/state.py:38-40`, ``adam_step`` in
`strainer_gan_tpu/train/steps.py`).  ``chip_smoke.py::adam_fixture_inputs``
makes a conv kernel, a BatchNorm scale and a bias with numpy from a fixed
seed, and one gradient each for five updates.
``tests/fixtures/torch_port_jax_adam.npz`` holds the SHA-256 of each input
and, after every update, the parameters and both moments the JAX side
computes on the CPU: at the presets' betas (0.5, 0.999) and torch's
defaults (0.9, 0.999), at rates 2e-4 and 1e-4, each cut to a tenth from
the fourth update on, as the LR cut changes it between updates.

Here the JAX side is computed again and must equal the file bit for bit,
and the port's CPU Adam (torch's default, ``train/state.py::make_adam``)
must agree with it within 1e-5: parameters absolute, moments relative to
their tensor's largest magnitude.  The card's capturable Adam is held to
the same file, eagerly and replayed from a CUDA graph, by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  To write the file
again after a deliberate change of the inputs or of the JAX package, from
the repo root:

    JAX_PLATFORMS=cpu python -m tests.test_torch_adam
"""
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.train.state import make_optimizer

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def jax_outputs(inputs: dict) -> dict:
    """The parameters and moments after each update, from the JAX side."""
    out = {f"sha256_{k}": np.array(v) for k, v in smoke.input_digests(inputs).items()}
    names = list(smoke.ADAM_SHAPES)
    for bi, (b1, b2) in enumerate(smoke.ADAM_BETAS):
        tx = make_optimizer(b1, b2)
        for ri, rate in enumerate(smoke.ADAM_RATES):
            params = {n: jnp.asarray(inputs[f"init_{n}"]) for n in names}
            state = tx.init(params)
            hist = {f"{k}_{n}_b{bi}_r{ri}": [] for k in ("params", "mu", "nu") for n in names}
            for t, lr in enumerate(smoke.adam_rates(rate)):
                grads = {n: jnp.asarray(inputs[f"grads_{n}"][t]) for n in names}
                updates, state = tx.update(grads, state, params)
                # adam_step (`strainer_gan_tpu/train/steps.py`): p - lr * u, lr traced
                params = jax.jit(lambda p, u, r: jax.tree.map(lambda a, b: a - r * b, p, u))(
                    params, updates, jnp.float32(lr))
                for n in names:
                    tag = f"{n}_b{bi}_r{ri}"
                    hist[f"params_{tag}"].append(np.asarray(params[n]))
                    hist[f"mu_{tag}"].append(np.asarray(state.mu[n]))
                    hist[f"nu_{tag}"].append(np.asarray(state.nu[n]))
            out.update({k: np.stack(v) for k, v in hist.items()})
    return out


@pytest.fixture(scope="module")
def fixture():
    with np.load(smoke.JAX_ADAM_FIXTURE) as f:
        return dict(f)


def test_fixture_is_the_jax_packages_output(fixture):
    inputs = smoke.adam_fixture_inputs()
    for k, v in smoke.input_digests(inputs).items():
        assert str(fixture[f"sha256_{k}"]) == v, k
    want = jax_outputs(inputs)
    assert set(want) == set(fixture)
    for k, v in want.items():
        np.testing.assert_array_equal(fixture[k], v, err_msg=k)


def test_cpu_adam_matches_jax(fixture):
    gaps = smoke.adam_gaps(torch, np, fixture, smoke.adam_fixture_inputs(), "cpu",
                           replay=False)
    print("largest gaps to the JAX fixture:", gaps)
    assert all(g <= smoke.ADAM_TOL for g in gaps.values()), gaps
    # the gate is not empty: every tensor moved by more than the tolerance
    inputs = smoke.adam_fixture_inputs()
    for n in smoke.ADAM_SHAPES:
        moved = np.abs(fixture[f"params_{n}_b0_r0"][-1] - inputs[f"init_{n}"]).max()
        assert moved > 10 * smoke.ADAM_TOL, n


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(smoke.JAX_ADAM_FIXTURE, **jax_outputs(smoke.adam_fixture_inputs()))
    print(f"wrote {smoke.JAX_ADAM_FIXTURE} ({smoke.JAX_ADAM_FIXTURE.stat().st_size} bytes)")
