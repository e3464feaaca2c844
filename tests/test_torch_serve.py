"""The serving ``Sampler`` against the JAX package's (CPU).

* ``Sampler._sample_batch`` against ``strainer_gan_tpu.serve.Sampler
  ._sample_batch`` from the same G weights (bridged from flax) and the
  same noise (the JAX key's draw, injected), in float32: the uint8 NHWC
  images are equal except where G's output ``x`` lies within 1e-5 of a
  rounding boundary (``(x + 1) * 127.5`` within 127.5e-5 of an
  integer), where the two packages' outputs (held within 1e-5 of
  each other; 7.9e-7 and 4.7e-6 measured) may truncate to neighbouring
  bytes; those bytes are counted and bounded (at most 1 in 10,000; 1 and
  11 of 196,608 seen), and each differs by one.
* ``from_checkpoint`` reads the port's ``config.json`` and ``epoch_N/state.pt``
  (the newest epoch by default) and samples what the live weights sample;
  ``sample`` is deterministic in its seed; ``sample_grid`` has the
  ``make_grid`` shape (as tests/test_e2e.py:186 asks of the JAX Sampler).
"""
import dataclasses
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.models import build_models as jax_build_models
from strainer_gan_tpu.serve import Sampler as JSampler

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.checkpoint import save_checkpoint
from strainer_gan_tpu_torch.models import Generator64
from strainer_gan_tpu_torch.serve import Sampler
from strainer_gan_tpu_torch.train.loop import Trainer

WIDTH, BS = 8, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread each, so parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfg):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=8),
        model=dataclasses.replace(cfg.model, ngf=WIDTH, ndf=WIDTH, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, epochs=1, log_every=0, sample_every=0))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("trained", [False, True], ids=["init", "moved_stats"])
def test_sample_batch_matches_jax(trained):
    jcfg = _tiny(jax_preset("final"))
    jgen, _ = jax_build_models(jcfg.model)
    z0 = jnp.zeros((1, jcfg.model.nz))
    variables = jgen.init(jax.random.PRNGKey(4), z0, train=False)
    # kernels x6: the initial ones give images within 1e-3 of grey; these
    # spread over most of [-1, 1] (a few saturate)
    params = {k: ({"kernel": v["kernel"] * 6.0} if k.startswith("Conv") else v)
              for k, v in variables["params"].items()}
    stats = variables["batch_stats"]
    if trained:
        # running statistics away from (0, 1), as training leaves them
        rng = np.random.default_rng(2)
        stats = jax.tree_util.tree_map(
            lambda s: jnp.asarray(np.abs(rng.normal(0.5, 0.3, s.shape)), jnp.float32), stats)
    js = JSampler(jcfg, params, stats, batch_size=BS)
    key = jax.random.PRNGKey(9)
    want = np.asarray(js._sample_batch(key))
    z = jax.random.normal(key, (BS, jcfg.model.nz))  # the draw _sample_batch makes
    x = np.asarray(jgen.apply({"params": params, "batch_stats": stats}, z, train=False),
                   np.float32)
    value = np.clip((x + np.float32(1.0)) * np.float32(127.5), 0, 255)

    pcfg = _tiny(get_preset("final"))
    gen = bridge.load_dcgan_from_flax(Generator64(100, WIDTH), _np(params), _np(stats))
    s = Sampler(pcfg, gen.state_dict(), batch_size=BS, device="cpu")
    got = s._sample_batch(torch.from_numpy(np.array(z))).numpy()
    assert got.shape == want.shape == (BS, 64, 64, 3) and got.dtype == np.uint8
    assert got.std() > 20 and got.min() < 40 and got.max() > 215
    differ = got != want
    # a G output x within 1e-5 of a boundary: (x + 1) * 127.5 within
    # 127.5e-5 of an integer (255 too: tanh saturates at exactly 1)
    dist = np.abs(value - np.round(value))
    near = dist <= 127.5e-5
    with torch.no_grad():
        xp = s.gen(torch.from_numpy(np.array(z)), train=False).permute(0, 2, 3, 1).numpy()
    print(f"{int(differ.sum())} of {got.size} bytes differ; {int(near.sum())} values near a "
          f"boundary; max |x - x_jax| {np.abs(xp - x).max()}")
    assert np.abs(xp - x).max() <= 1e-5
    assert not (differ & ~near).any()
    assert int(differ.sum()) <= got.size // 10_000
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_from_checkpoint_round_trip(tmp_path):
    cfg = _tiny(get_preset("basic"))
    tr = Trainer(cfg, device="cpu", max_synth=24)
    tr.logger.stream = io.StringIO()
    tr.setup()
    with torch.no_grad():
        # an untrained narrow G gives near-constant images: spread them
        tr.gen.convs[-1].weight.mul_(50.0)
    tr.run_epoch(0)
    save_checkpoint(str(tmp_path / "ck"), tr, 0)
    first = {k: v.clone() for k, v in tr.gen.state_dict().items()}
    tr.run_epoch(1)
    save_checkpoint(str(tmp_path / "ck"), tr, 1)

    s = Sampler.from_checkpoint(str(tmp_path / "ck"), batch_size=BS, device="cpu")
    imgs = s.sample(20, seed=3)
    assert imgs.shape == (20, 64, 64, 3) and imgs.dtype == np.uint8
    np.testing.assert_array_equal(imgs, s.sample(20, seed=3))
    assert not np.array_equal(imgs, s.sample(20, seed=4))
    # the newest epoch, and the live weights' images
    live = Sampler(cfg, tr.gen.state_dict(), batch_size=BS, device="cpu")
    np.testing.assert_array_equal(imgs, live.sample(20, seed=3))
    older = Sampler.from_checkpoint(str(tmp_path / "ck"), epoch=0, batch_size=BS, device="cpu")
    np.testing.assert_array_equal(older.sample(20, seed=3),
                                  Sampler(cfg, first, BS, "cpu").sample(20, seed=3))
    assert not np.array_equal(older.sample(20, seed=3), imgs)
    # batch i's noise depends on (seed, i) only, not on n
    np.testing.assert_array_equal(s.sample(4, seed=3), imgs[:4])
    grid = s.sample_grid(16, nrow=4)
    assert grid.shape == (4 * 66 + 2, 4 * 66 + 2, 3) and grid.dtype == np.uint8
