"""Fixed-noise samples, their grids and PNGs: the port against the JAX
package (CPU, small size).

* ``Trainer.sample`` equals the JAX ``Trainer.sample`` (NHWC float32) to
  atol 1e-5, with G's weights bridged from the JAX state and the same
  fixed noise, in float32, with BatchNorm in train mode (the reference's
  grids) and in eval mode; train mode leaves G's running statistics as
  they were, as the JAX package drops that update.
* ``img_list`` gets a grid after every ``sample_every``-th global iteration
  and after the run's last iteration unless that one was a sample point
  (`strainer_gan_tpu/train/loop.py:540-561,711-717`);
  ``epoch_loss_history`` holds each epoch's per-sample real losses, the
  partial tail's valid lanes only.
* ``make_grid`` is byte-equal to the JAX one; the port's PNG decodes (PIL)
  to the pixels of the JAX package's ``save_image_grid``.
* ``utils/trees.py`` counts what the JAX functions count, and the
  ``check_finite`` rail stops a run whose parameters went non-finite.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.obs import images as JIM
from strainer_gan_tpu.train.loop import Trainer as JTrainer

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.obs import images as IM
from strainer_gan_tpu_torch.train.loop import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread each, so parallel test workers do
    not oversubscribe the cores (torch's thread pool spins while it waits)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, **train):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=8),
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, log_every=0, **train),
    )


@pytest.fixture(scope="module")
def trainers():
    jtr = JTrainer(_tiny(jax_preset("basic")), max_synth=16)
    ptr = Trainer(_tiny(get_preset("basic")), device="cpu", max_synth=16)
    bridge.load_dcgan_from_flax(ptr.gen, jax.tree.map(np.asarray, jtr.state.g_params),
                                jax.tree.map(np.asarray, jtr.state.g_stats))
    ptr.fixed_noise = torch.from_numpy(np.asarray(jtr.fixed_noise))
    return jtr, ptr


@pytest.mark.parametrize("n,train_bn", [(None, True), (None, False), (25, True)])
def test_sample_matches_jax(trainers, n, train_bn):
    jtr, ptr = trainers
    before = {k: v.clone() for k, v in ptr.gen.state_dict().items()}
    got = ptr.sample(n, train_bn=train_bn)
    want = jtr.sample(n, train_bn=train_bn)
    assert got.shape == want.shape == (n or 64, 64, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    for k, v in ptr.gen.state_dict().items():
        assert torch.equal(v, before[k]), f"sample() changed G's {k}"


@pytest.mark.parametrize("sample_every", [0, 4, 5, 7])
def test_img_list_cadence_and_loss_history(sample_every):
    # 37 images in batches of 8: 5 steps an epoch, the last with 5 lanes
    epochs = 3
    tr = Trainer(_tiny(get_preset("basic"), epochs=epochs, sample_every=sample_every,
                       fixed_noise_n=4), device="cpu", max_synth=37)
    out = tr.run()
    total = sum(o["steps"] for o in out)
    assert total == 15 and tr._iters == total
    want = 0
    if sample_every:
        want = len(range(0, total, sample_every)) + ((total - 1) % sample_every != 0)
    assert len(tr.img_list) == want
    assert all(g.shape == (4, 64, 64, 3) and np.isfinite(g).all() for g in tr.img_list)
    assert [h.shape for h in tr.epoch_loss_history] == [(37,)] * epochs
    assert all(np.isfinite(h).all() for h in tr.epoch_loss_history)


@pytest.mark.parametrize("n,nrow,c,normalize", [(64, 8, 3, True), (25, 5, 3, True),
                                                (7, 3, 1, True), (10, 4, 3, False)])
def test_make_grid_byte_equal(n, nrow, c, normalize):
    imgs = np.random.default_rng(n).uniform(-1.0, 1.0, (n, 16, 12, c)).astype(np.float32)
    got = IM.make_grid(imgs, nrow=nrow, normalize=normalize)
    want = JIM.make_grid(imgs, nrow=nrow, normalize=normalize)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [1, 3])
def test_png_decodes_to_the_jax_pixels(tmp_path, c):
    Image = pytest.importorskip("PIL.Image")
    imgs = np.random.default_rng(c).uniform(-1.0, 1.0, (25, 64, 64, c)).astype(np.float32)
    IM.save_image_grid(imgs, str(tmp_path / "port.png"), nrow=5)
    JIM.save_image_grid(imgs, str(tmp_path / "jax.png"), nrow=5)
    with Image.open(tmp_path / "port.png") as a, Image.open(tmp_path / "jax.png") as b:
        assert a.mode == b.mode == ("L" if c == 1 else "RGB")
        got, want = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(got, want)
    assert got.shape[:2] == (5 * 66 + 2, 5 * 66 + 2)


def test_tree_accounting_matches_jax(trainers):
    """``utils/trees.py`` over the modules gives the JAX functions' numbers
    over the flax parameter trees (what ``--describe`` prints)."""
    from strainer_gan_tpu.utils import trees as JT
    from strainer_gan_tpu_torch.utils import trees as PT

    jtr, ptr = trainers
    for module, params in ((ptr.gen, jtr.state.g_params), (ptr.disc, jtr.state.d_params)):
        assert PT.param_count(module) == JT.param_count(params)
        assert PT.tree_bytes(module) == JT.tree_bytes(params)
        assert PT.dtype_summary(module) == JT.dtype_summary(params)
        assert PT.finite_check(module) and JT.finite_check(params)


def test_check_finite_rail_stops_a_diverged_run():
    tr = Trainer(_tiny(get_preset("basic"), epochs=2, sample_every=0, check_finite=True),
                 device="cpu", max_synth=16)
    tr.run_epoch(0)
    with torch.no_grad():
        tr.gen.convs[0].weight[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="after epoch 1"):
        tr.run_epoch(1)
