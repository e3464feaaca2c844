"""The fake-concatenation step and Trainer against the JAX package (CPU).

* The step: the port's D-first step with in-batch recycling
  (``StepConfig.in_batch_recycle``, the ``in_batch_recycle`` preset) and
  with the outlier pool (``pool_concat``, ``loss_concat_fast``) against the
  JAX ``make_train_step`` with the same flags, from the same weights
  (bridged from flax), batches, noise and pool rows (drawn as the JAX step
  draws them: its ``k_pool`` permutation, wrapped when the pool is smaller
  than the batch), three steps in a row, with the gate off and on, on full
  batches and on a lane-masked partial tail.  After every step the keep
  mask (whose dropped reals are the recycled lanes, ``use_real``),
  ``n_contam`` and ``n_filtered_contam`` must be equal; ``score_probs``
  and the losses, ``D_x``, ``D_G_z1`` and ``D_G_z2`` within 1e-6; the
  parameters, every BatchNorm's running statistics and Adam's moments
  within tests/test_torch_batch_mask.py's 1e-5, with that file's two
  carve-outs and its re-synchronisation of the weights and moments between
  steps.
* The pool before its gate: a pool step with ``concat_on`` off equals the
  same step without a pool within 1e-6 (the pool lanes weigh 0 in D's loss
  and BatchNorms); the gradients within 1e-5 of their tensor's largest.
* The Trainer: both packages' Trainers on tiny ``in_batch_recycle`` and
  ``loss_concat_fast`` runs with the JAX draws injected (batch order,
  noise, the pool's permutation and every step's pool rows; the ResNet18
  features from the same synthetic weights), across the gate epoch
  (``fake_concat_start_epoch=1``; ``loss_concat_fast``'s loss strain moved
  past the run, so its epochs differ only by the pool): the same lines at
  the same steps, the first to the digit and later ones within 2e-2
  (tests/test_torch_chunked.py's bound for free-running steps), the last
  step's keep mask and the pool's bytes exact.
"""
import dataclasses
import io
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.data.pipeline import epoch_batch_indices as jax_epoch_indices
from strainer_gan_tpu.models import Discriminator64 as JDisc, Generator64 as JGen
from strainer_gan_tpu.models.resnet import load_torch_resnet_state_dict, resnet18_features
from strainer_gan_tpu.models.synth_weights import synth_resnet_state_dict
from strainer_gan_tpu.obs.metrics import MetricsLogger as JLogger
from strainer_gan_tpu.train.loop import Trainer as JTrainer
from strainer_gan_tpu.train.loop import step_config_from as jax_step_config
from strainer_gan_tpu.train.state import create_state
from strainer_gan_tpu.train.steps import make_train_step

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.data import normalize_u8
from strainer_gan_tpu_torch.train.loop import Trainer
from strainer_gan_tpu_torch.train.steps import step_config_from, train_step

from test_torch_batch_mask import KINK, _assert_adam_params_close, _port_modules
from test_torch_batch_mask import kink_log  # noqa: F401  (a fixture)
from test_torch_step import _assert_tree_close, _np

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

WIDTH, B, STEPS, TAIL = 8, 16, 3, 11
POOL_ROWS = {"full": 40, "tail": 9}  # the tail case's pool is smaller than the batch
PRESET = {"recycle": "in_batch_recycle", "pool": "loss_concat_fast"}
VALUES = ("errD", "errG", "errD_real", "errD_fake", "D_x", "D_G_z1", "D_G_z2")
# the step's values: 2e-6 of max(1, |value|); the largest gap seen is 1.4e-6
# of errG = 1.13 (12 float32 ulps: D's reductions summed in another order)
VALUE_TOL = 2e-6
KINKED_SHARE = 0.01  # a kinked step's moments: the share of a tensor left to the bound


def _check_state(gen, disc, opt_g, opt_d, state, state_prev, lr_g, lr_d, t, kinked):
    """tests/test_torch_batch_mask.py's state check.  In a kinked step (a
    ReLU or LeakyReLU input within rounding of 0 may take the other slope,
    and the gradient through that one unit then differs) the parameters are
    held to |update| <= 3 lr, as there, and the Adam moments to that file's
    1e-5 + 1e-2 of their tensor's largest everywhere but in at most 1% of a
    tensor's elements, the elements downstream of the unit; a first moment
    there stays within twice the largest (1 - b1) g of its tensor, the most
    this step's gradient moved any element of it."""
    g, d = bridge.dcgan_to_flax(gen), bridge.dcgan_to_flax(disc)
    _assert_adam_params_close(g["params"], state.g_params, state_prev.g_params, state.g_opt,
                              state_prev.g_opt, lr_g, t, "G params", kinked)
    _assert_adam_params_close(d["params"], state.d_params, state_prev.d_params, state.d_opt,
                              state_prev.d_opt, lr_d, t, "D params", kinked)
    _assert_tree_close(g["batch_stats"], state.g_stats, "G BN stats")
    _assert_tree_close(d["batch_stats"], state.d_stats, "D BN stats")
    for module, opt, jopt, jprev, name in ((gen, opt_g, state.g_opt, state_prev.g_opt, "G"),
                                           (disc, opt_d, state.d_opt, state_prev.d_opt, "D")):
        mu, nu = bridge.adam_moments_to_flax(module, opt)
        if not kinked:
            _assert_tree_close(mu, jopt.mu, f"{name} Adam mu")
            _assert_tree_close(nu, jopt.nu, f"{name} Adam nu")
            continue
        for kind, tree, prev, got in (("mu", jopt.mu, jprev.mu, mu), ("nu", jopt.nu, jprev.nu, nu)):
            got = dict(jax.tree_util.tree_leaves_with_path(got))
            for (path, w), w0 in zip(jax.tree_util.tree_leaves_with_path(tree),
                                     jax.tree_util.tree_leaves(prev)):
                w, w0 = np.asarray(w, np.float64), np.asarray(w0, np.float64)
                x = np.asarray(got[path], np.float64)
                off = np.abs(x - w) > 1e-5 + 1e-2 * np.abs(w).max()
                what = f"{name} Adam {kind} {jax.tree_util.keystr(path)}"
                if off.any():
                    print(f"{what}: {int(off.sum())} of {off.size} elements downstream "
                          "of the kink")
                assert off.sum() <= KINKED_SHARE * off.size, what
                if kind == "mu":  # b1 = 0.5: mu = 0.5 mu0 + 0.5 g
                    step = np.abs(w - 0.5 * w0).max()
                    assert np.all(np.abs(x - w)[off] <= 2 * step), what


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread each, so parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, **train):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=B),
        model=dataclasses.replace(cfg.model, ngf=WIDTH, ndf=WIDTH, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **train))


@pytest.fixture(scope="module")
def jax_steps():
    """mode -> (tiny JAX config, initial state, jitted JAX step)."""
    gen = JGen(nz=100, ngf=WIDTH, compute_dtype=jnp.float32)
    disc = JDisc(ndf=WIDTH, compute_dtype=jnp.float32)
    out = {}
    for mode, name in PRESET.items():
        cfg = _tiny(jax_preset(name))
        state = jax.jit(lambda k: create_state(cfg, gen, disc, k))(jax.random.PRNGKey(5))
        scfg = jax_step_config(cfg)
        assert scfg.in_batch_recycle == (mode == "recycle")
        assert scfg.pool_concat == (mode == "pool")
        out[mode] = cfg, state, make_train_step(gen, disc, scfg, donate=False)
    return out


def _pool_rows(key, pool_n):
    """The JAX step's pool rows (`strainer_gan_tpu/train/steps.py:212-216`)."""
    perm = jax.random.permutation(jax.random.split(key, 6)[5], pool_n)
    return np.asarray(perm[jnp.arange(B) % pool_n])


@pytest.mark.parametrize("case", ["full", "tail"])
@pytest.mark.parametrize("gate", [False, True], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("mode", ["recycle", "pool"])
def test_fake_concat_step_matches_jax(jax_steps, kink_log, mode, gate, case):
    jcfg, state, jstep = jax_steps[mode]
    pcfg = _tiny(get_preset(PRESET[mode]))
    scfg = step_config_from(pcfg)
    gen, disc, opt_g, opt_d = _port_modules(pcfg, state)
    lane = TAIL if case == "tail" else None
    rng = np.random.default_rng(31 + 4 * (mode == "pool") + 2 * gate + (case == "tail"))
    lr_g, lr_d = jcfg.train.lr_g, jcfg.train.lr_d
    kw = {} if lane is None else dict(lane_count=jnp.asarray(lane, jnp.int32))
    pool = rng.integers(0, 256, (POOL_ROWS[case], 64, 64, 3)).astype(np.uint8)
    # JAX: mask_on is the static gate of the in-step keep, concat_on the
    # pool's traced one (`strainer_gan_tpu/train/loop.py:359-372`)
    mask_on, concat_on = (gate, False) if mode == "recycle" else (False, gate)
    jpool = jnp.asarray(pool) if mode == "pool" else None
    for s in range(STEPS):
        batch = rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8)
        src = (rng.uniform(size=B) < 0.3).astype(np.int32)
        key = jax.random.PRNGKey(200 + s)
        z = np.asarray(jax.random.normal(jax.random.split(key, 6)[0], (B, 100), jnp.float32))
        state_prev = state
        state, jm = jstep(state, jnp.asarray(batch), jnp.asarray(src), key, lr_g, lr_d,
                          mask_on, jnp.asarray(concat_on), jpool, True, **kw)
        kink_log[0] = float("inf")
        pool_kw = {}
        if mode == "pool":
            pool_kw = dict(fake_pool=torch.from_numpy(pool), concat_on=concat_on,
                           pool_idx=torch.from_numpy(_pool_rows(key, len(pool)).astype(np.int64)))
        tm = train_step(gen, disc, opt_g, opt_d, normalize_u8(torch.from_numpy(batch)),
                        torch.from_numpy(src), torch.from_numpy(z.copy()), lr_g, lr_d, scfg,
                        lane_count=lane, mask_on=mask_on, **pool_kw)
        assert set(tm) == set(jm)
        valid = np.arange(B) < (lane or B)
        keep = np.asarray(jm["keep_mask"])
        np.testing.assert_array_equal(tm["keep_mask"].numpy(), keep)
        for k in ("n_contam", "n_filtered_contam"):
            assert int(tm[k]) == int(jm[k]), k
        np.testing.assert_allclose(tm["score_probs"].numpy(), np.asarray(jm["score_probs"]),
                                   atol=1e-6, rtol=0)
        for k in VALUES:
            want = float(jm[k])
            assert abs(float(tm[k]) - want) <= VALUE_TOL * max(1.0, abs(want)), k
        np.testing.assert_allclose(tm["real_loss_per_sample"].detach().numpy(),
                                   np.asarray(jm["real_loss_per_sample"]), atol=1e-5, rtol=1e-4)
        if mode == "recycle" and gate:
            recycled = valid & ~keep
            print(f"step {s}: {int(recycled.sum())} of {int(valid.sum())} lanes recycled")
            assert 0 < recycled.sum() < valid.sum()
        else:
            np.testing.assert_array_equal(keep, valid)
        kinked = kink_log[0] < KINK
        if kinked:
            print(f"step {s}: an activation input of {kink_log[0]:.3g} lies within float32 "
                  "rounding of a kink")
        _check_state(gen, disc, opt_g, opt_d, state, state_prev, lr_g, lr_d, s + 1, kinked)
        for mod, opt, params, jopt in ((gen, opt_g, state.g_params, state.g_opt),
                                       (disc, opt_d, state.d_params, state.d_opt)):
            bridge.load_dcgan_from_flax(mod, _np(params))
            bridge.load_adam_from_flax(mod, opt, _np(jopt.mu), _np(jopt.nu), s + 1)


@pytest.mark.parametrize("case", ["full", "tail"])
def test_pool_before_its_gate_is_the_unpooled_step(jax_steps, case):
    _, state, _ = jax_steps["pool"]
    pcfg = _tiny(get_preset("loss_concat_fast"))
    plain = pcfg.replace(strain=dataclasses.replace(pcfg.strain, fake_concat="none"))
    rng = np.random.default_rng(41)
    pool = torch.from_numpy(rng.integers(0, 256, (POOL_ROWS[case], 64, 64, 3)).astype(np.uint8))
    lane = TAIL if case == "tail" else None
    batches = [(normalize_u8(torch.from_numpy(rng.integers(0, 256, (B, 64, 64, 3))
                                              .astype(np.uint8))),
                torch.from_numpy((rng.uniform(size=B) < 0.3).astype(np.int32)),
                torch.from_numpy(rng.standard_normal((B, 100)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, len(pool), B)))
               for _ in range(2)]
    runs = []
    for cfg, pooled in ((pcfg, True), (plain, False)):
        gen, disc, opt_g, opt_d = _port_modules(cfg, state)
        ms = []
        for x, src, z, rows in batches:
            kw = dict(fake_pool=pool, pool_idx=rows, concat_on=False) if pooled else {}
            ms.append(train_step(gen, disc, opt_g, opt_d, x, src, z, 2e-4, 1e-4,
                                 step_config_from(cfg), lane_count=lane, **kw))
            # the gradients of the step, before the weights diverge by Adam's
            # sensitivity to rounding
            ms[-1]["grads"] = [p.grad.clone() for p in (*gen.parameters(), *disc.parameters())]
            for mod, other in ((gen, state.g_params), (disc, state.d_params)):
                bridge.load_dcgan_from_flax(mod, _np(other))
        runs.append((ms, [b.clone() for b in (*gen.buffers(), *disc.buffers())]))
    (ms_a, buf_a), (ms_b, buf_b) = runs
    for a, b in zip(ms_a, ms_b):
        for k in VALUES + ("real_loss_per_sample",):
            np.testing.assert_allclose(a[k].detach().numpy(), b[k].detach().numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)
        for ga, gb in zip(a["grads"], b["grads"]):
            # the pooled BatchNorm sums 2b lanes, half of them at weight 0:
            # float32 rounding, measured up to 1.6e-6 of a tensor's largest
            np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=0,
                                       atol=1e-5 * float(gb.abs().max()))
    for x, y in zip(buf_a, buf_b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, rtol=0)


# in_batch_recycle: 46 CelebA-like images, 5 full batches of 8 and a tail of
# 6, so the tail's line averages over more than one kept lane;
# loss_concat_fast: 33 CelebA-like + 33 anime-like, 8 full batches and a
# tail of 2 and a pool of 6 rows, smaller than the batch
MAX_SYNTH = {"in_batch_recycle": 46, "loss_concat_fast": 33}


def _jax_feature_fn():
    """The JAX ResNet18 trunk with the port's synthetic weights
    (tests/test_torch_zscore_slice.py)."""
    fmodel = resnet18_features(3)
    fvars = jax.jit(lambda k, a: fmodel.init({"params": k}, a))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    fvars = jax.tree.map(jnp.asarray, load_torch_resnet_state_dict(
        fvars, synth_resnet_state_dict(fvars)))
    return jax.jit(lambda x: fmodel.apply(fvars, x, train=False))


@pytest.mark.parametrize("name", ["in_batch_recycle", "loss_concat_fast"])
def test_fake_concat_trainer_matches_jax(name, capsys):
    """Epoch 0 before the gate, epoch 1 from it, at steps_per_dispatch=4
    (the JAX Trainer's blocking path; the port's warm-up step, a chunk,
    then single steps and the tail); no fixed-noise samples, so no sample
    point cuts an epoch."""
    tb = 8

    def tiny(cfg):
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, batch_size=tb),
            model=dataclasses.replace(cfg.model, ngf=WIDTH, ndf=WIDTH,
                                      compute_dtype="float32"),
            train=dataclasses.replace(cfg.train, epochs=2, log_every=2, steps_per_dispatch=4,
                                      sample_every=0, defer_epoch_stats=False))
        return cfg.replace(strain=dataclasses.replace(cfg.strain, fake_concat_start_epoch=1,
                                                      start_epoch=5))

    jcfg, pcfg = tiny(jax_preset(name)), tiny(get_preset(name))
    jstream = io.StringIO()
    jfeat = _jax_feature_fn() if name == "loss_concat_fast" else None
    jtr = JTrainer(jcfg, feature_fn=jfeat, max_synth=MAX_SYNTH[name],
                   logger=JLogger(log_every=2, stream=jstream))
    tr = Trainer(pcfg, device="cpu", max_synth=MAX_SYNTH[name])
    n = tr.dataset.n
    assert n == jtr.dataset.n == {"in_batch_recycle": 46, "loss_concat_fast": 66}[name]
    np.testing.assert_array_equal(tr.dataset.images.numpy(), np.asarray(jtr.dataset.images))
    for mod, params, stats in ((tr.gen, jtr.state.g_params, jtr.state.g_stats),
                               (tr.disc, jtr.state.d_params, jtr.state.d_stats)):
        bridge.load_dcgan_from_flax(mod, _np(params), _np(stats))

    # the JAX Trainer's draws (`strainer_gan_tpu/train/loop.py:196,262-282,334,409`)
    key = jax.random.split(jax.random.PRNGKey(jcfg.train.seed))[0]
    key, _, k_pool = jax.random.split(key, 3)  # setup()
    steps = -(-n // tb)
    pool_n = max(int(n * jcfg.strain.fake_pool_fraction), 1)
    draws = []
    for _ in range(jcfg.train.epochs):
        key, _, k_perm, k_steps = jax.random.split(key, 4)
        idx = np.asarray(jax_epoch_indices(k_perm, jnp.ones((n,), bool), steps, tb,
                                           all_active=True))
        keys = jax.random.split(k_steps, steps)
        zs = [np.asarray(jax.random.normal(jax.random.split(k, 6)[0], (tb, 100), jnp.float32))
              for k in keys]
        rows = [np.asarray(jax.random.permutation(jax.random.split(k, 6)[5], pool_n)
                           [jnp.arange(tb) % pool_n]) for k in keys]
        draws.append((idx, zs, rows))
    tr.epoch_indices = lambda e, active, s: torch.from_numpy(draws[e][0][:s].astype(np.int64))
    tr.step_noise = lambda e, i: torch.from_numpy(draws[e][1][i].copy())
    tr.step_pool_rows = lambda e, i: torch.from_numpy(draws[e][2][i].astype(np.int64))
    tr.pool_order = lambda m: torch.from_numpy(
        np.asarray(jax.random.permutation(k_pool, m)).astype(np.int64))

    jout = jtr.run()
    out = tr.run()
    assert tr._executors  # the port ran chunks
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if ln.startswith(("[", "Epoch"))]
    jlines = [ln for ln in jstream.getvalue().splitlines() if ln.startswith(("[", "Epoch"))]
    assert [ln.split("\t")[0] for ln in lines] == [ln.split("\t")[0] for ln in jlines]
    assert lines[0] == jlines[0]
    num = re.compile(r"-?\d+\.\d+")
    for ln, jln in zip(lines, jlines):
        np.testing.assert_allclose([float(v) for v in num.findall(ln)],
                                   [float(v) for v in num.findall(jln)], atol=2e-2)
    for o, jo in zip(out, jout):
        assert (o["steps"], o["active"]) == (jo["steps"], jo["active"])
    for h, jh in zip(tr.epoch_loss_history, jtr.epoch_loss_history):
        np.testing.assert_allclose(h, np.asarray(jh), atol=2e-2)
    eng, jeng = tr.engine, jtr.engine
    if name == "in_batch_recycle":
        assert tr.fake_pool is None and {k[1] for k in tr._executors} == {False, True}
        assert eng.last_batch_valid == jeng.last_batch_valid == n % tb == 6
        np.testing.assert_array_equal(eng.last_batch_mask.numpy(),
                                      np.asarray(jeng.last_batch_mask))
    else:
        assert {k[1] for k in tr._executors} == {False}  # the pool's gate is no capture key
        np.testing.assert_array_equal(tr.fake_pool.numpy(), np.asarray(jtr.pool))
        print(f"pool of {pool_n} rows, {int(eng.outlier_mask().sum())} outliers")
        assert eng.last_batch_scores is None
