"""The MNIST slice of the port end to end against the JAX package (CPU).

* ``mnist_full`` shrunk (``max_synth=1500`` per source, 2 epochs,
  ``fid_every_epochs=1``) in both packages, the port's 1-channel ResNet18
  trunk carrying the JAX trunk's own weights (its flax initialisation,
  bridged): the z-score prefilter (``numpy_eps``, threshold 4.0) keeps
  exactly the JAX mask.  Both packages' FID then runs on a small fixed
  feature map in place of InceptionV3 and on the same fixed fake images
  (the Trainers' G weights differ, so their samples would): it fires after
  the same epochs, on the same clean real images (equal bytes), and prints
  the same ``Epoch N: FID = v`` lines, the values within rtol 1e-3 (each
  package's float32 covariance and Newton-Schulz arithmetic).
* The MLP's checkpoint: ``mnist_full`` resumed from its epoch-0 checkpoint
  ends bit-equal to the uninterrupted run (dropout masks included), and
  the ``Sampler`` serves its G as (N, 28, 28, 1) uint8 equal to G's
  eval-mode forward on the same noise.
* The command line: ``--preset mnist8 --epochs 1 --device cpu`` as a
  process, ``celeba_dog_baseline`` for one epoch on a small synthetic
  mixture (no ``--eval``), and ``--list`` with all 21 presets; the suite
  on ``fake_concat``'s config gives its six values (ResNet50 distances and
  FIDs, the FIDs on the small feature map above), all finite.
"""
import dataclasses
import io
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.eval import fid as JF, suite as JSU
from strainer_gan_tpu.models.resnet import resnet18_features
from strainer_gan_tpu.obs.metrics import MetricsLogger as JLogger
from strainer_gan_tpu.train.loop import Trainer as JaxTrainer

from strainer_gan_tpu_torch import bridge, cli, get_preset
from strainer_gan_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from strainer_gan_tpu_torch.config import PRESETS
from strainer_gan_tpu_torch.eval import fid as TF, suite as TSU
from strainer_gan_tpu_torch.models.features import build_feature_fn
from strainer_gan_tpu_torch.serve import Sampler
from strainer_gan_tpu_torch.train.loop import Trainer

MAX_SYNTH = 1500
FID_LINE = re.compile(r"^Epoch (\d+): FID = (\S+)$", re.M)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shrunk(cfg):
    return cfg.replace(train=dataclasses.replace(cfg.train, epochs=2, log_every=1),
                       eval=dataclasses.replace(cfg.eval, fid_every_epochs=1))


@pytest.fixture(scope="module")
def mnist_full_pair():
    """The shrunk mnist_full in both packages, with the FID patched as the
    module docstring says; returns both Trainers, their console text and
    the real images each FID call saw."""
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((3, 16)).astype(np.float32)
    fakes = rng.uniform(-1, 1, (2000, 28, 28, 1)).astype(np.float32)
    reals = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    mp.setattr(JF, "build_feature_fn",
               lambda name, **kw: lambda x: jnp.tanh(x.mean(axis=(1, 2)) @ proj) + 1.5)
    mp.setattr(TF, "inception_fn", lambda dev: (
        lambda x: torch.tanh(x.mean(dim=(2, 3)) @ torch.from_numpy(proj)) + 1.5))
    mp.setattr(JSU, "generate_samples", lambda gen, gp, gs, n, nz, key, image_shape=None,
               batch=100: jnp.asarray(fakes[:n]))
    mp.setattr(TSU, "generate_samples", lambda gen, n, nz, generator, image_shape=None,
               **kw: torch.from_numpy(fakes[:n]).permute(0, 3, 1, 2))
    j_fid, t_fid = JSU.calculate_fid, TSU.calculate_fid

    def j_calc(real, fake, *a, **kw):
        reals["jax"].append(np.asarray(real))
        return j_fid(real, fake, *a, **kw)

    def t_calc(real, fake, *a, **kw):
        reals["port"].append(real.permute(0, 2, 3, 1).numpy())
        return t_fid(real, fake, *a, **kw)

    mp.setattr(JSU, "calculate_fid", j_calc)
    mp.setattr(TSU, "calculate_fid", t_calc)
    try:
        jcfg = _shrunk(jax_preset("mnist_full"))
        jt = JaxTrainer(jcfg, max_synth=MAX_SYNTH,
                        logger=JLogger(log_every=1, style="mnist", stream=io.StringIO()))
        jt.run()
        # the JAX trunk's weights: its flax initialisation (features.py:47-51)
        jm = resnet18_features(1)
        jv = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 1)))
        sd = bridge.resnet18_state_dict_from_flax(jax.tree.map(np.asarray, jv))
        tr = Trainer(_shrunk(get_preset("mnist_full")), device="cpu", max_synth=MAX_SYNTH)
        tr.engine.feature_fn = build_feature_fn("resnet18_1ch", 1, "cpu",
                                                flatten_input_hw=(28, 28), state_dict=sd)
        tr.logger.stream = io.StringIO()
        tr.run()
    finally:
        mp.undo()
    return jt, tr, reals


def test_prefilter_mask_equals_jax(mnist_full_pair):
    jt, tr, _ = mnist_full_pair
    want = np.asarray(jt.mask_history[0])
    got = tr.mask_history[0]
    assert tr.dataset.n == jt.dataset.n and 0 < got.sum() < len(got)
    np.testing.assert_array_equal(got, want)
    assert tr.cfg.strain.z_std_mode == "numpy_eps" and tr.cfg.strain.z_threshold == 4.0


def test_periodic_fid_matches_jax(mnist_full_pair):
    jt, tr, reals = mnist_full_pair
    assert [e for e, _ in tr.fid_history] == [e for e, _ in jt.fid_history] == [0, 1]
    assert len(reals["port"]) == len(reals["jax"]) == 4  # real and contaminant, each epoch
    for got, want in zip(reals["port"], reals["jax"]):
        np.testing.assert_array_equal(got, want)
    j_lines = FID_LINE.findall(jt.logger.stream.getvalue())
    t_lines = FID_LINE.findall(tr.logger.stream.getvalue())
    assert [e for e, _ in t_lines] == [e for e, _ in j_lines] == ["1", "2"]
    for (_, a), (_, b) in zip(t_lines, j_lines):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-3)
    for (_, a), (_, b) in zip(tr.fid_history, jt.fid_history):
        np.testing.assert_allclose(a, b, rtol=1e-3)
    assert all(np.isfinite(c["fid"]) for c in TF.calls[-4:])
    # the MNIST console format, step lines and all
    assert re.search(r"^Epoch \[1/2\] Step \[1/\d+\] d_loss: \d+\.\d{5} g_loss: \d+\.\d{5}$",
                     tr.logger.stream.getvalue(), re.M)


def _trainer_state(tr):
    out = {f"gen.{k}": v for k, v in tr.gen.state_dict().items()}
    out.update({f"disc.{k}": v for k, v in tr.disc.state_dict().items()})
    for name in ("opt_g", "opt_d"):
        for i, st in getattr(tr, name).state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": torch.as_tensor(v) for k, v in st.items()})
    return out


def test_mlp_checkpoint_resume_and_sampler(tmp_path):
    cfg = get_preset("mnist_full")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=2, log_every=0,
                                                steps_per_dispatch=2),
                      data=dataclasses.replace(cfg.data, batch_size=16),
                      strain=dataclasses.replace(cfg.strain, method="none", prefilter=False),
                      eval=dataclasses.replace(cfg.eval, fid=False))
    full = Trainer(cfg, device="cpu", max_synth=600)
    full.setup()
    full.run_epoch(0)
    save_checkpoint(str(tmp_path / "ckpt"), full, 0)
    full.run_epoch(1)

    resumed = Trainer(cfg, device="cpu", dataset=full.dataset)
    resumed.setup()
    assert restore_checkpoint(str(tmp_path / "ckpt"), resumed) == 1
    resumed.run_epoch(1)
    a, b = _trainer_state(full), _trainer_state(resumed)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a), \
        [k for k in a if not torch.equal(a[k], b[k])][:4]
    assert full.epoch_results[-1]["steps"] >= 3  # a chunk and an eager step each epoch

    s = Sampler.from_checkpoint(str(tmp_path / "ckpt"), batch_size=8, device="cpu")
    imgs = s.sample(12, seed=3)
    assert imgs.shape == (12, 28, 28, 1) and imgs.dtype == np.uint8
    z = torch.randn((8, 100), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        x = s.gen(z, train=False).reshape(8, 28, 28, 1)
    want = torch.clamp((x + 1.0) * 127.5, 0, 255).to(torch.uint8)
    assert torch.equal(s._run(z), want)
    grid = s.sample_grid(16, nrow=4)
    assert grid.shape == (4 * 30 + 2, 4 * 30 + 2, 1)


def test_cli_mnist8_process(tmp_path):
    res = subprocess.run([sys.executable, "-m", "strainer_gan_tpu_torch.cli", "--preset",
                          "mnist8", "--epochs", "1", "--device", "cpu", "--out",
                          str(tmp_path)], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert re.search(r"^Epoch \[1/1\] Step \[1/\d+\] d_loss:", res.stdout, re.M)
    assert (tmp_path / "samples.png").exists() and (tmp_path / "metrics.json").exists()


def test_cli_celeba_dog_baseline_and_list(capsys, monkeypatch):
    tr, results = cli.run(["--preset", "celeba_dog_baseline", "--epochs", "1", "--device",
                           "cpu", "--max-synth", "300", "--batch-size", "16"])
    assert results["epochs"] == 1 and tr.fid_history == []
    assert (tr.dataset.source_id != 0).sum() > 0  # the CIFAR-like dogs
    assert np.isfinite(results["summary"]["last_D_loss"])
    # the suite's six values, its FIDs on a small fixed feature map (InceptionV3's
    # 2048-dim square root takes about 30 s on one CPU thread; test_torch_fid.py)
    proj = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32))
    monkeypatch.setattr(TF, "inception_fn", lambda dev: (
        lambda x: torch.tanh(x.mean(dim=(2, 3)) @ proj) + 1.5))
    ev = TSU.evaluate_run(get_preset("fake_concat"), tr.gen, tr.dataset, n_samples=8)
    assert set(ev) == {"fid_real", "fid_contaminant", "feature_distance_real",
                       "feature_distance_contaminant", "wasserstein_real",
                       "wasserstein_contaminant"}
    assert all(np.isfinite(v) for v in ev.values())
    capsys.readouterr()
    assert cli.main(["--list"]) == 0
    listed = capsys.readouterr().out.splitlines()
    assert len(listed) == len(PRESETS) == 21
    assert any(ln.startswith("mnist_full ") and "arch=mlp" in ln for ln in listed)
