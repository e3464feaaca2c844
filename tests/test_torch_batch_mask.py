"""The ``batch_mask`` headline step and Trainer against the JAX package (CPU).

* The step: the port's D-first step with the in-step quantile mask against
  the JAX ``make_train_step`` with ``batch_mask=True``, from the same
  weights (bridged from flax), batches and noise (drawn as the JAX step
  draws it), three steps in a row, with the mask gate off and on, on full
  batches and on a lane-masked partial tail.  After every step the keep
  mask, ``n_contam`` and ``n_filtered_contam`` must be equal;
  ``score_probs`` within 1e-6; the other metrics, the parameters, every
  BatchNorm's running statistics and Adam's moments within atol 1e-5,
  rtol 1e-4 (as tests/test_torch_step.py).  Each masked step prints the
  nearest score's margin to its quantile.

  One carve-out, for the parameters only (tests/test_torch_step.py's,
  carried to later Adam steps): Adam divides the first moment by the root
  of the second, so a gradient element g summed in another order moves the
  step by about lr (1 - b1) / (1 - b1^t) * dg / sqrt(v_hat).  With dg the
  float32 noise of the tensor's gradient sum, 1e-6 of its largest element,
  that exceeds the tolerance where sqrt(v_hat) is small; those elements
  (printed) are held only to |update| <= 3 lr on both sides.

  And one for the gradients: a ReLU or LeakyReLU input within float32
  rounding of 0 (below 1.2e-7, float32's epsilon at unit scale) may take
  the other slope in the other package, and the gradient through that one
  unit then differs (seen here: a D input of 8e-9 at the third masked
  step, after which G's Adam first moments differed by up to 1.8e-4 of a
  largest 0.1, from identical weights and moments).  The test records the
  port's smallest such input in every step; only in a step where one lies
  below 1.2e-7 (printed) are the parameters held to |update| <= 3 lr and
  the Adam moments to 1e-5 + 1e-2 of their tensor's largest.  Every other
  step, and the metrics and BatchNorm statistics of every step, are held
  to the tolerances above.

  Between steps the port takes the JAX step's parameters and Adam moments
  (``bridge.load_adam_from_flax``), but not its BatchNorm statistics: those
  thread through the three steps on each side alone, which is what would
  drift if the scoring pass ran in the wrong mode or order.  The weights
  are re-synchronised because a free-running chain is chaotic at float32:
  from the third step on, a LeakyReLU or ReLU input within rounding of 0
  can take the other slope in one package, and one G gradient element then
  moves by a few per cent (seen with the mask gate off too).
* Stem sharing: the port's step with ``stem_share=True`` equals the one
  with ``stem_share=False`` (the counterpart of tests/test_chunked.py:46).
* The Trainer: both packages' Trainers on the same tiny mixture, weights
  and draws (the JAX Trainer's permutations and noise, handed to the port
  through ``Trainer.epoch_indices`` and ``Trainer.step_noise``) across the
  gate epoch: the same ``Filtered CIFAR-10 images`` line, the same counts,
  and a parity report of 1.0 on both sides.
"""
import dataclasses
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.data.pipeline import epoch_batch_indices as jax_epoch_indices
from strainer_gan_tpu.models import Discriminator64 as JDisc, Generator64 as JGen
from strainer_gan_tpu.obs.metrics import MetricsLogger as JLogger
from strainer_gan_tpu.parity.agreement import agreement_report as jax_report
from strainer_gan_tpu.train.loop import Trainer as JTrainer
from strainer_gan_tpu.train.loop import step_config_from as jax_step_config
from strainer_gan_tpu.train.state import create_state
from strainer_gan_tpu.train.steps import make_train_step

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.data import normalize_u8
from strainer_gan_tpu_torch.models import Discriminator64, Generator64
from strainer_gan_tpu_torch.parity.agreement import agreement_report
from strainer_gan_tpu_torch.train.loop import Trainer
from strainer_gan_tpu_torch.train.state import make_optimizers
from strainer_gan_tpu_torch.train.steps import step_config_from, train_step

from test_torch_step import ATOL, RTOL, _assert_tree_close, _np

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

WIDTH, B, STEPS, TAIL = 8, 16, 3, 11


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
def jax_side():
    cfg = _tiny(jax_preset("batch_mask"))
    gen = JGen(nz=100, ngf=WIDTH, compute_dtype=jnp.float32)
    disc = JDisc(ndf=WIDTH, compute_dtype=jnp.float32)
    state = jax.jit(lambda k: create_state(cfg, gen, disc, k))(jax.random.PRNGKey(5))
    scfg = jax_step_config(cfg)
    assert scfg.batch_mask and scfg.mask_quantile == 0.1
    return cfg, state, make_train_step(gen, disc, scfg, donate=False)


def _port_modules(cfg, state):
    gen = bridge.load_dcgan_from_flax(Generator64(100, WIDTH), _np(state.g_params),
                                      _np(state.g_stats))
    disc = bridge.load_dcgan_from_flax(Discriminator64(WIDTH), _np(state.d_params),
                                       _np(state.d_stats))
    return gen, disc, *make_optimizers(cfg, gen, disc)


def _margin(probs, valid, q=0.1):
    """Nearest distance of a valid score to the batch's quantile."""
    p = np.asarray(probs, np.float64)[valid]
    d = np.abs(p - np.quantile(p, q))
    return float(np.min(d[d > 0]))


KINK = 1.2e-7  # float32's epsilon at unit scale


@pytest.fixture
def kink_log(monkeypatch):
    """The smallest |input| of the port's ReLUs and LeakyReLUs since the
    last reset (``log[0]``)."""
    import types
    import torch.nn.functional as F
    from strainer_gan_tpu_torch.models import dcgan

    log = [float("inf")]

    def watched(fn):
        def call(x, *args, **kw):
            log[0] = min(log[0], float(x.detach().abs().min()))
            return fn(x, *args, **kw)
        return call

    monkeypatch.setattr(dcgan, "F", types.SimpleNamespace(
        relu=watched(F.relu), leaky_relu=watched(F.leaky_relu)))
    return log


@pytest.mark.parametrize("mask_on", [False, True], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("case", ["full", "tail"])
def test_masked_step_matches_jax(jax_side, kink_log, mask_on, case):
    jcfg, state, jstep = jax_side
    pcfg = _tiny(get_preset("batch_mask"))
    gen, disc, opt_g, opt_d = _port_modules(pcfg, state)
    lane = TAIL if case == "tail" else None
    rng = np.random.default_rng(7 + 2 * mask_on + (case == "tail"))
    lr_g, lr_d = jcfg.train.lr_g, jcfg.train.lr_d
    kw = {} if lane is None else dict(lane_count=jnp.asarray(lane, jnp.int32))
    for s in range(STEPS):
        batch = rng.integers(0, 256, (B, 64, 64, 3)).astype(np.uint8)
        src = (rng.uniform(size=B) < 0.3).astype(np.int32)
        key = jax.random.PRNGKey(100 + s)
        z = np.asarray(jax.random.normal(jax.random.split(key, 6)[0], (B, 100), jnp.float32))
        state_prev = state
        state, jm = jstep(state, jnp.asarray(batch), jnp.asarray(src), key, lr_g, lr_d,
                          mask_on, jnp.asarray(False), None, True, **kw)
        kink_log[0] = float("inf")
        tm = train_step(gen, disc, opt_g, opt_d, normalize_u8(torch.from_numpy(batch)),
                        torch.from_numpy(src), torch.from_numpy(z.copy()), lr_g, lr_d,
                        step_config_from(pcfg), lane_count=lane, mask_on=mask_on)
        assert set(tm) == set(jm)
        valid = np.arange(B) < (lane or B)
        keep = np.asarray(jm["keep_mask"])
        np.testing.assert_array_equal(tm["keep_mask"].numpy(), keep)
        for k in ("n_contam", "n_filtered_contam"):
            assert int(tm[k]) == int(jm[k]), k
        np.testing.assert_allclose(tm["score_probs"].numpy(), np.asarray(jm["score_probs"]),
                                   atol=1e-6, rtol=0)
        kinked = kink_log[0] < KINK
        if kinked:
            print(f"step {s}: an activation input of {kink_log[0]:.3g} lies within float32 "
                  "rounding of a kink")
        _check_state(gen, disc, opt_g, opt_d, state, state_prev, lr_g, lr_d, s + 1, kinked)
        for mod, opt, params, jopt in ((gen, opt_g, state.g_params, state.g_opt),
                                       (disc, opt_d, state.d_params, state.d_opt)):
            bridge.load_dcgan_from_flax(mod, _np(params))
            bridge.load_adam_from_flax(mod, opt, _np(jopt.mu), _np(jopt.nu), s + 1)
        if mask_on:
            print(f"step {s}: kept {keep.sum()}/{valid.sum()}, filtered "
                  f"{int(jm['n_filtered_contam'])}/{int(jm['n_contam'])}, nearest margin "
                  f"to the quantile {_margin(jm['score_probs'], valid):.3g}")
            assert keep.sum() < valid.sum() and not keep[~valid].any()
        else:
            np.testing.assert_array_equal(keep, valid)
            assert int(jm["n_filtered_contam"]) == 0
        for k in jm:
            if k not in ("keep_mask", "score_probs", "n_contam", "n_filtered_contam"):
                np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]),
                                           atol=1e-5, rtol=1e-4, err_msg=k)


def _assert_adam_params_close(got, params, before, opt, opt_prev, lr, t, what, kinked,
                              b1=0.5, b2=0.999):
    """Params after Adam step ``t`` (the betas are batch_mask's), with the
    carve-outs of the module docstring."""
    leaves = [jax.tree_util.tree_leaves(x) for x in (before, opt.mu, opt.nu, opt_prev.mu)]
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    for (path, w), b, mu, nu, mu0 in zip(jax.tree_util.tree_leaves_with_path(params), *leaves):
        g = got[path]
        w, b, mu, nu, mu0 = (np.asarray(a, np.float64) for a in (w, b, mu, nu, mu0))
        grad = (mu - b1 * mu0) / (1 - b1)
        v_hat = nu / (1 - b2 ** t)
        sens = lr * (1 - b1) / (1 - b1 ** t) * 1e-6 * np.abs(grad).max() / (np.sqrt(v_hat) + 1e-8)
        noisy = sens > 0.1 * ATOL
        if kinked:
            noisy |= np.abs(g - w) > ATOL + RTOL * np.abs(w)
        name = f"{what} {jax.tree_util.keystr(path)}"
        if noisy.any():
            print(f"{name}: {int(noisy.sum())} elements held to |update| <= 3 lr")
        np.testing.assert_allclose(g[~noisy], w[~noisy], atol=ATOL, rtol=RTOL, err_msg=name)
        for p in (g, w):
            assert np.all(np.abs(p[noisy] - b[noisy]) <= 3 * lr), name


def _assert_moments_close(got, want, what, kinked):
    if not kinked:
        return _assert_tree_close(got, want, what)
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        w = np.asarray(w)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=ATOL + 1e-2 * np.abs(w).max(),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _check_state(gen, disc, opt_g, opt_d, state, state_prev, lr_g, lr_d, t, kinked):
    g, d = bridge.dcgan_to_flax(gen), bridge.dcgan_to_flax(disc)
    _assert_adam_params_close(g["params"], state.g_params, state_prev.g_params, state.g_opt,
                              state_prev.g_opt, lr_g, t, "G params", kinked)
    _assert_adam_params_close(d["params"], state.d_params, state_prev.d_params, state.d_opt,
                              state_prev.d_opt, lr_d, t, "D params", kinked)
    _assert_tree_close(g["batch_stats"], state.g_stats, "G BN stats")
    _assert_tree_close(d["batch_stats"], state.d_stats, "D BN stats")
    for module, opt, jopt, name in ((gen, opt_g, state.g_opt, "G"),
                                    (disc, opt_d, state.d_opt, "D")):
        mu, nu = bridge.adam_moments_to_flax(module, opt)
        _assert_moments_close(mu, jopt.mu, f"{name} Adam mu", kinked)
        _assert_moments_close(nu, jopt.nu, f"{name} Adam nu", kinked)


@pytest.mark.parametrize("case", ["full", "tail"])
def test_stem_sharing_changes_nothing(jax_side, case):
    _, state, _ = jax_side
    pcfg = _tiny(get_preset("batch_mask"))
    rng = np.random.default_rng(21)
    batches = [(normalize_u8(torch.from_numpy(rng.integers(0, 256, (B, 64, 64, 3))
                                              .astype(np.uint8))),
                torch.from_numpy((rng.uniform(size=B) < 0.3).astype(np.int32)),
                torch.from_numpy(rng.standard_normal((B, 100)).astype(np.float32)))
               for _ in range(STEPS)]
    runs = []
    for share in (True, False):
        gen, disc, opt_g, opt_d = _port_modules(pcfg, state)
        ms = [train_step(gen, disc, opt_g, opt_d, x, src, z, 2e-4, 2e-4,
                         step_config_from(pcfg), lane_count=TAIL if case == "tail" else None,
                         mask_on=True, stem_share=share) for x, src, z in batches]
        runs.append((ms, gen.state_dict(), disc.state_dict()))
    (ms_a, g_a, d_a), (ms_b, g_b, d_b) = runs
    for a, b in zip(ms_a, ms_b):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for sa, sb in ((g_a, g_b), (d_a, d_b)):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


MAX_SYNTH = 60  # 60 CelebA-like + 6 CIFAR-like images: 4 full batches and a tail of 2


def test_trainer_contamination_matches_jax(capsys):
    """Epoch 0 ungated, epoch 1 gated (``mask_start_epoch=1``)."""
    def tiny(cfg):
        cfg = _tiny(cfg, epochs=2, log_every=1000, steps_per_dispatch=1)
        return cfg.replace(strain=dataclasses.replace(cfg.strain, mask_start_epoch=1))

    jcfg, pcfg = tiny(jax_preset("batch_mask")), tiny(get_preset("batch_mask"))
    jstream = io.StringIO()
    jtr = JTrainer(jcfg, max_synth=MAX_SYNTH, logger=JLogger(log_every=1000, stream=jstream))
    tr = Trainer(pcfg, device="cpu", max_synth=MAX_SYNTH)
    n = tr.dataset.n
    assert n == jtr.dataset.n == 66 and n % B
    for mod, params, stats in ((tr.gen, jtr.state.g_params, jtr.state.g_stats),
                               (tr.disc, jtr.state.d_params, jtr.state.d_stats)):
        bridge.load_dcgan_from_flax(mod, _np(params), _np(stats))

    # the JAX Trainer's draws (`strainer_gan_tpu/train/loop.py:196,262,334,409`)
    key = jax.random.split(jax.random.PRNGKey(jcfg.train.seed))[0]
    key = jax.random.split(key, 3)[0]  # setup()
    steps = -(-n // B)
    draws = []
    for _ in range(jcfg.train.epochs):
        key, _, k_perm, k_steps = jax.random.split(key, 4)
        idx = np.asarray(jax_epoch_indices(k_perm, jnp.ones((n,), bool), steps, B,
                                           all_active=True))
        zs = [np.asarray(jax.random.normal(jax.random.split(k, 6)[0], (B, 100), jnp.float32))
              for k in jax.random.split(k_steps, steps)]
        draws.append((idx, zs))
    tr.epoch_indices = lambda e, active, s: torch.from_numpy(draws[e][0][:s].astype(np.int64))
    tr.step_noise = lambda e, i: torch.from_numpy(draws[e][1][i].copy())

    jout = jtr.run()
    out = tr.run()
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if "Filtered CIFAR-10" in ln]
    jlines = [ln for ln in jstream.getvalue().splitlines() if "Filtered CIFAR-10" in ln]
    print(lines, jlines)
    assert lines == jlines and len(lines) == 1 and lines[0].startswith("Epoch 1: ")
    for o, jo in zip(out, jout):
        assert (o["filtered_contam"], o["total_contam"]) == (jo["filtered_contam"],
                                                            jo["total_contam"])
    assert out[0]["total_contam"] == 0 and out[1]["total_contam"] == 6
    # the last gated step is the tail of 2 lanes: its mask and scores
    eng, jeng = tr.engine, jtr.engine
    assert eng.last_batch_valid == jeng.last_batch_valid == n % B
    np.testing.assert_array_equal(eng.last_batch_mask.numpy(), np.asarray(jeng.last_batch_mask))
    # ten free-running steps apart (the step test holds one step at 1e-6):
    # a sanity bound only
    np.testing.assert_allclose(eng.last_batch_scores.numpy()[:n % B],
                               np.asarray(jeng.last_batch_scores)[:n % B], atol=2e-2)
    report, jrep = agreement_report(tr), jax_report(jtr)
    assert report["agreement"] == jrep["agreement"] == 1.0
    assert report == jrep


def test_ungated_epoch_clears_stale_scores():
    cfg = _tiny(get_preset("batch_mask"), epochs=1, log_every=1000)
    tr = Trainer(cfg.replace(strain=dataclasses.replace(cfg.strain, mask_start_epoch=0)),
                 device="cpu", max_synth=20)
    out = tr.run()
    assert tr.engine.last_batch_scores is not None and out[0]["total_contam"] == 2
    assert agreement_report(tr)["agreement"] == 1.0
    tr.cfg = tr.cfg.replace(strain=dataclasses.replace(tr.cfg.strain, mask_start_epoch=5))
    tr.run_epoch(1)
    assert tr.engine.last_batch_scores is None and agreement_report(tr) == {}
