"""The port's eval suite (``eval/suite.py``) and ``--eval`` against the JAX
package (CPU, float32, one torch thread).

* ``evaluate_run`` on ``fake_concat``'s config (every metric on) in both
  packages, on the same 32x32 mixture (70 clean images, 70 contaminants)
  and the same injected fakes (each package's ``generate_samples``
  patched, as tests/test_torch_mnist_slice.py does), 64 samples: the same six keys,
  ``feature_distance_*`` within rtol 1e-4 and ``wasserstein_*`` within
  rtol 1e-3 (float32 ResNet50 features, then an SVD in each package), the
  FIDs within rtol 1e-3 (each package's float32 covariance and square
  root).  The port's ResNet50 carries the JAX trunk's own weights (its
  flax initialisation, bridged); both FIDs run on one small fixed feature
  map in place of InceptionV3, which the fixtures test elsewhere.  Each
  set is cut to the first 64 (tests/test_torch_distances.py holds unequal
  counts).  Each PCA is fitted on more rows than its 50 components: with
  fewer, the
  centred matrix's rank is below 50 and the trailing components are any
  basis of its null space, in either package.
* A 1-channel config with a distance on is refused with the reference's
  failure named; ``--eval`` on ``mnist8`` exits 2 before training.
* ``cli.run([... "--eval"])`` on ``strainer_gan`` writes ``results["eval"]``
  with the six keys, finite, printed and in ``metrics.json`` (InceptionV3
  replaced by the small map, as above).
"""
import json
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.data.mixers import Mixture as JMixture
from strainer_gan_tpu.data.pipeline import DeviceDataset as JDataset
from strainer_gan_tpu.eval import fid as JF, suite as JSU
from strainer_gan_tpu.models.resnet import resnet50_features

from strainer_gan_tpu_torch import bridge, cli, get_preset
from strainer_gan_tpu_torch.data import DeviceDataset, Mixture
from strainer_gan_tpu_torch.eval import fid as TF, suite as TSU
from strainer_gan_tpu_torch.models.features import build_feature_fn

N, N_CLEAN, N_CONTAM = 64, 70, 70
KEYS = {"fid_real", "fid_contaminant", "feature_distance_real", "feature_distance_contaminant",
        "wasserstein_real", "wasserstein_contaminant"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_evaluate_run_matches_jax():
    rng = np.random.default_rng(0)
    n = N_CLEAN + N_CONTAM
    images = rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    src = np.zeros(n, np.int32)
    src[rng.choice(n, N_CONTAM, replace=False)] = 1
    # brighter contaminants and darker fakes: every distance well above 0
    images[src == 1] = images[src == 1] // 2 + 128
    fakes = rng.uniform(-1, 0.5, (N, 32, 32, 3)).astype(np.float32)
    proj = rng.standard_normal((3, 16)).astype(np.float32)
    jm = resnet50_features(3)
    jv = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)))
    sd = bridge.resnet50_state_dict_from_flax(jax.tree.map(np.asarray, jv))
    port_trunk = build_feature_fn("resnet50", 3, "cpu", state_dict=sd)
    mp = pytest.MonkeyPatch()
    mp.setattr(JF, "build_feature_fn",
               lambda name, **kw: lambda x: jnp.tanh(x.mean(axis=(1, 2)) @ proj) + 1.5)
    mp.setattr(TF, "inception_fn", lambda dev: (
        lambda x: torch.tanh(x.mean(dim=(2, 3)) @ torch.from_numpy(proj)) + 1.5))
    mp.setattr(JSU, "generate_samples", lambda gen, gp, gs, n, nz, key, image_shape=None,
               batch=100: jnp.asarray(fakes[:n]))
    mp.setattr(TSU, "generate_samples", lambda gen, n, nz, generator, image_shape=None,
               **kw: torch.from_numpy(fakes[:n]).permute(0, 3, 1, 2))
    mp.setattr(TSU, "build_feature_fn", lambda name, ch, dev: port_trunk)
    try:
        jcfg, cfg = jax_preset("fake_concat"), get_preset("fake_concat")
        state = types.SimpleNamespace(g_params=None, g_stats=None)
        want = JSU.evaluate_run(jcfg, None, state, JDataset(JMixture(images, src, src)),
                                n_samples=N)
        calls = len(TSU.calls)
        got = TSU.evaluate_run(cfg, None, DeviceDataset(Mixture(images, src, src), "cpu"),
                               n_samples=N)
    finally:
        mp.undo()
    assert set(got) == set(want) == KEYS
    assert len(TSU.calls) == calls + 1 and TSU.calls[-1]["n"] == (N, N, N)
    for k in KEYS:
        rtol = 1e-4 if k.startswith("feature") else 1e-3
        np.testing.assert_allclose(got[k], float(want[k]), rtol=rtol, err_msg=k)


def test_one_channel_distances_refused():
    cfg = cli.force_eval_suite(get_preset("mnist8"), 16)
    assert cfg.eval.feature_distance and cfg.eval.wasserstein and cfg.model.nc == 1
    with pytest.raises(ValueError, match="ScopeParamShapeError"):
        TSU.evaluate_run(cfg, None, None, n_samples=4)
    # a preset with a metric on keeps its own EvalConfig
    full = get_preset("mnist_full")
    assert cli.force_eval_suite(full, 16) is full


def test_cli_eval_writes_results(tmp_path, capsys, monkeypatch):
    proj = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 16)).astype(np.float32))
    monkeypatch.setattr(TF, "inception_fn", lambda dev: (
        lambda x: torch.tanh(x.mean(dim=(2, 3)) @ proj) + 1.5))
    _, results = cli.run(["--preset", "strainer_gan", "--device", "cpu", "--max-synth", "48",
                          "--batch-size", "16", "--epochs", "1", "--eval", "--eval-samples",
                          "8", "--out", str(tmp_path)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(results["eval"]) == KEYS
    assert all(np.isfinite(v) for v in results["eval"].values())
    with open(tmp_path / "metrics.json") as f:
        assert json.load(f) == printed == results
    ev = get_preset("strainer_gan").eval
    assert ev.fid and ev.feature_distance and ev.wasserstein
