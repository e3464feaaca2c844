"""The port's host-staging library (``strainer_gan_tpu_torch/native``), CPU.

* Resize (up and down, 1 and 3 channels), center crop and gather through
  the port's library are byte-equal to their numpy plain versions
  (``data/datasets.py::*_plain``, ``data/mixers.py::gather_plain``) and to
  the JAX package's library (`strainer_gan_tpu/native`) on random uint8
  batches: tolerance 0.
* The synthetic generator, now chunked on host threads, is byte-equal to
  the JAX package's ``_synthetic`` (the port's generator before the change
  was a line-for-line copy of it) for ``faces``, ``objects`` and ``anime``,
  at a size that spans several chunks and a partial one.
* A failed build raises: a missing compiler and a compiler that fails.
* The port stands alone: no module of ``strainer_gan_tpu_torch`` and not
  ``chip_smoke.py`` imports ``jax`` or the JAX package.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

from strainer_gan_tpu import native as jax_native
from strainer_gan_tpu.data import datasets as JD

from strainer_gan_tpu_torch import native
from strainer_gan_tpu_torch.data import datasets as PD
from strainer_gan_tpu_torch.data import mixers as PM

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", [(32, 64), (32, 48), (32, 20), (64, 16), (28, 64),
                                     (64, 64)])
def test_resize_is_byte_equal(src, dst, channels):
    rng = np.random.default_rng(src * 100 + dst + channels)
    images = rng.integers(0, 256, (70, src, src, channels), dtype=np.uint8)
    got = PD.resize_bilinear_u8(images, dst)
    assert got.shape == (70, dst, dst, channels) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, PD.resize_bilinear_u8_plain(images, dst))
    np.testing.assert_array_equal(native.resize_bilinear_u8(images, dst),
                                  jax_native.resize_bilinear_u8(images, dst))


@pytest.mark.parametrize("shape,size", [((9, 80, 64, 3), 64), ((5, 33, 47, 1), 20)])
def test_center_crop_is_byte_equal(shape, size):
    images = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got = PD.center_crop(images, size)
    np.testing.assert_array_equal(got, PD.center_crop_plain(images, size))
    np.testing.assert_array_equal(got, jax_native.center_crop_u8(images, size))
    with pytest.raises(ValueError):
        PD.center_crop(images, shape[1] + 1)


def test_gather_is_byte_equal():
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (300, 16, 16, 3), dtype=np.uint8)
    order = rng.permutation(300)
    got = native.gather_u8(images, order)
    np.testing.assert_array_equal(got, PM.gather_plain(images, order))
    np.testing.assert_array_equal(got, jax_native.gather_u8(images, order))
    with pytest.raises(IndexError):
        native.gather_u8(images, np.array([300]))


@pytest.mark.parametrize("kind,size", [("faces", 64), ("objects", 32), ("anime", 64)])
def test_synthetic_is_byte_equal(kind, size):
    n = 2 * PD.SYNTH_CHUNK + 37  # two whole chunks and a partial one
    want = JD._synthetic(kind, n, size, 3, seed=21)
    got = PD._synthetic(kind, n, size, 3, seed=21)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"])
def test_failed_build_raises(compiler, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError):
        native.build(compiler=compiler)
    assert not any(tmp_path.iterdir())  # no half-written library left behind


def _imports(path: Path):
    """Every module name ``path`` imports, by statement or by a call of
    ``import_module`` / ``__import__`` on a string."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def test_port_imports_no_jax():
    files = sorted((ROOT / "strainer_gan_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    for path in files:
        for name in _imports(path):
            top = str(name).split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "strainer_gan_tpu"), \
                f"{path.relative_to(ROOT)} imports {name}"
