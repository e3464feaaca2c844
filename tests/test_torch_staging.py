"""The port's host-side staging against the JAX package (CPU).

* The resize is byte-identical to the JAX package's native C++ library
  (`strainer_gan_tpu/native/host_staging.cc`) at up- and downsampling
  scales, 1 and 3 channels: tolerance 0.  So are the z-score presets'
  synthetic mixtures, the CIFAR subset path included.
* Real datasets are looked for where the JAX package looks, so the same
  files give the same arrays in both packages.
* A staged torchvision ``resnet18.pt`` reaches both packages' feature
  extractors: features agree at 1e-5 of their largest magnitude, the
  tolerance of tests/test_torch_models.py for ResNet18.
"""
import dataclasses
import os
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu import native
from strainer_gan_tpu.data import datasets as JD
from strainer_gan_tpu.models import features as JF

from strainer_gan_tpu_torch.data import datasets as PD
from strainer_gan_tpu_torch.models import features as PF
from strainer_gan_tpu_torch.models.resnet import ResNet18Features
from strainer_gan_tpu_torch.models.synth_weights import load_synth_weights

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", [(32, 64), (32, 48), (32, 20), (32, 16), (28, 64)])
def test_resize_matches_native_bytes(src, dst, channels):
    rng = np.random.default_rng(src * 100 + dst + channels)
    images = rng.integers(0, 256, (64, src, src, channels), dtype=np.uint8)
    want = native.resize_bilinear_u8(images, dst)
    if want is None:
        pytest.skip("the native staging library did not build here (no C++ compiler), "
                    "so there is no reference to compare with")
    got = PD.resize_bilinear_u8(images, dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("name", ["zscore", "zscore_elbow", "zscore_dbscan"])
def test_mixture_is_byte_identical(name):
    # a CIFAR count below the source size takes the preset's subset path
    from strainer_gan_tpu.config import SourceSpec as JSpec, get_preset as jax_preset
    from strainer_gan_tpu.data import build_mixture as jax_mixture
    from strainer_gan_tpu_torch import get_preset
    from strainer_gan_tpu_torch.config import SourceSpec
    from strainer_gan_tpu_torch.data import build_mixture

    jdata, pdata = jax_preset(name).data, get_preset(name).data
    count = {s.name: s.count for s in pdata.sources}
    assert count == {s.name: s.count for s in jdata.sources}
    if count["cifar10"] is not None:
        jdata = dataclasses.replace(jdata, sources=(JSpec("celeba"), JSpec("cifar10", count=70)))
        pdata = dataclasses.replace(pdata, sources=(SourceSpec("celeba"),
                                                    SourceSpec("cifar10", count=70)))
    jm, pm = jax_mixture(jdata, max_synth=100), build_mixture(pdata, max_synth=100)
    np.testing.assert_array_equal(pm.images, jm.images)
    np.testing.assert_array_equal(pm.source_id, jm.source_id)
    np.testing.assert_array_equal(pm.labels, jm.labels)


def _write_cifar(root, rng):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for i in range(1, 6):
        batch = {b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                 b"labels": list(rng.integers(0, 10, 4))}
        with open(os.path.join(d, f"data_batch_{i}"), "wb") as f:
            pickle.dump(batch, f)


def test_data_roots_match_the_jax_package(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    monkeypatch.delenv("STRAINER_DATA_ROOT", raising=False)
    monkeypatch.chdir(tmp_path)
    assert PD._load_cifar10_disk() is None
    _write_cifar(os.path.join(tmp_path, "data"), rng)  # ./data, a root of both
    want, got = JD._load_cifar10_disk(), PD._load_cifar10_disk()
    assert want is not None and got is not None
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    # $STRAINER_DATA_ROOT comes first
    env_root = tmp_path / "env"
    _write_cifar(str(env_root), rng)
    monkeypatch.setenv("STRAINER_DATA_ROOT", str(env_root))
    first = PD._load_cifar10_disk()
    assert not np.array_equal(first.images, got.images)
    assert PD.data_roots()[0] == str(env_root)


def test_staged_resnet18_weights_reach_both_packages(tmp_path, monkeypatch):
    # a torchvision-named state_dict: the synthetic weights, perturbed, plus
    # the classifier head a torchvision file carries
    rng = np.random.default_rng(5)
    sd = load_synth_weights(ResNet18Features(3)).state_dict()
    sd = {k: (v + torch.from_numpy(rng.normal(0, 0.05, tuple(v.shape)).astype(np.float32))
              if v.is_floating_point() else v) for k, v in sd.items()}
    sd = {k: (v.abs() + 0.5 if k.endswith("running_var") else v) for k, v in sd.items()}
    sd["fc.weight"] = torch.zeros((1000, 512))
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, tmp_path / "resnet18.pt")
    monkeypatch.setenv("STRAINER_WEIGHTS_DIR", str(tmp_path))
    # the JAX package caches built extractors (and their wrappers) by name
    monkeypatch.setattr(JF, "_cache", {})
    monkeypatch.setattr(JF, "_wrapper_cache", {})

    x = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JF.build_feature_fn("resnet18", 3)(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    got = PF.build_feature_fn("resnet18", 3, device="cpu")(xt).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    # the staged weights were used, not the synthetic ones
    monkeypatch.delenv("STRAINER_WEIGHTS_DIR")
    synth = PF.build_feature_fn("resnet18", 3, device="cpu")(xt).numpy()
    assert float(np.abs(synth - got).max()) > 1e-3 * scale
