"""The MNIST data of the port against the JAX package's (CPU).

* the synthetic ``digits`` source: images and labels byte-equal to the JAX
  package's ``_synthetic`` (2,000 images, two seeds; 28x28, one channel,
  and a three-channel case);
* the four MNIST presets' mixtures (images, source ids, labels) byte-equal
  at a small ``max_synth``;
* ``_load_mnist_disk`` on fabricated idx files, raw and gzipped, equal to
  the JAX loader on the same files;
* ``auto_batch_divisor``: the Trainer's batch is min(max(n // divisor, 16),
  64) of the staged dataset, as the JAX Trainer sets it.

Every comparison is exact.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.data import datasets as JD
from strainer_gan_tpu.data.mixers import build_mixture as jax_mixture

from strainer_gan_tpu_torch import get_preset
from strainer_gan_tpu_torch.data import build_mixture, datasets as TD
from strainer_gan_tpu_torch.train.loop import Trainer

MNIST_PRESETS = ("mnist8", "mnist_8_2", "mnist_1_2_8_baseline", "mnist_full")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,n,ch", [(0, 2000, 1), (1234, 2000, 1), (7, 300, 3)])
def test_digits_byte_equal(seed, n, ch):
    want = JD._synthetic("digits", n, 28, ch, seed)
    got = TD._synthetic("digits", n, 28, ch, seed)
    assert got.images.dtype == np.uint8 and got.images.shape == (n, 28, 28, ch)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("preset", MNIST_PRESETS)
def test_mnist_mixture_byte_equal(preset):
    cfg = get_preset(preset).data
    want = jax_mixture(jax_preset(preset).data, max_synth=1500)
    got = build_mixture(cfg, max_synth=1500)
    assert got.images.shape[1:] == (28, 28, 1) and len(got) > 0
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.source_id, want.source_id)
    np.testing.assert_array_equal(got.labels, want.labels)


def _write_idx(root, gz, n=37):
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    d = root / "MNIST" / "raw"
    d.mkdir(parents=True)
    suffix = ".gz" if gz else ""
    op = gzip.open if gz else open
    with op(d / f"train-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with op(d / f"train-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return images, labels


@pytest.mark.parametrize("gz", [False, True])
def test_load_mnist_disk(tmp_path, monkeypatch, gz):
    images, labels = _write_idx(tmp_path, gz)
    monkeypatch.setenv("STRAINER_DATA_ROOT", str(tmp_path))
    monkeypatch.setattr(JD, "DATA_ROOTS", [str(tmp_path)])
    got, want = TD._load_mnist_disk(), JD._load_mnist_disk()
    assert got.images.shape == (len(labels), 28, 28, 1) and got.labels.dtype == np.int32
    np.testing.assert_array_equal(got.images[..., 0], images)
    np.testing.assert_array_equal(got.labels, labels)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    # the source then reads the disk, not the synthetic stand-in
    ds = TD.load_source(get_preset("mnist8").data.sources[0], 28, 1, 999)
    np.testing.assert_array_equal(ds.labels, labels[labels == 8])


def test_load_mnist_disk_absent(tmp_path, monkeypatch):
    monkeypatch.setenv("STRAINER_DATA_ROOT", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert TD._load_mnist_disk() is None


@pytest.mark.parametrize("preset,max_synth", [("mnist8", 3000), ("mnist_8_2", 3000),
                                              ("mnist8", 9000)])
def test_auto_batch_divisor(preset, max_synth):
    from strainer_gan_tpu.train.loop import Trainer as JaxTrainer

    tr = Trainer(get_preset(preset), device="cpu", max_synth=max_synth)
    div = get_preset(preset).data.auto_batch_divisor
    want = min(max(tr.dataset.n // div, 16), 64)
    assert tr.cfg.data.batch_size == want
    assert tr.scfg.nz == 100
    jt = JaxTrainer(jax_preset(preset), max_synth=max_synth)
    assert jt.dataset.n == tr.dataset.n and jt.cfg.data.batch_size == want
