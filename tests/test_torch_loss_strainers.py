"""The loss-space strainers (``loss_gmm``, ``loss_ensemble``) against the JAX
package (CPU, small).

* The GMM: ``fit_gmm2``'s means, variances and weights and
  ``gmm_threshold`` on seeded bimodal losses, with and without ``valid``,
  and the equal-variance (a = 0, the midpoint) and one-mode cases.  The
  EM's sums run in torch's order, not XLA's, so the fitted values agree to
  a relative 1e-5 (about 6e-7 seen), not bit for bit.
* The thresholds: ``iqr_threshold`` and the percentile under it bit for
  bit; ``ensemble_mask``'s threshold at 1e-5 with no flipped decision;
  ``keep_count`` and ``_truncate_in_order`` exactly.  The JAX count is a
  float32 product: 45,000 x 0.7 gives 31,500 there where Python's float64
  gives 31,499, and 45,000 x 0.9 gives 40,500 where float32(0.9) times
  45,000 in float64 would truncate to 40,499; both cases are here.
* The engine arms over six epochs against the JAX engine on the same
  images and the same D (perturbed alike before every epoch): the masks,
  thresholds, ``reset_each_epoch``, ``bn_eval_after_score`` and the
  clean-ratio schedule; and ``_losses`` scores the whole set for these
  methods even when a base subset exists, as the JAX engine does
  (`strainer_gan_tpu/strain/engine.py:129`).
* The parity report for both methods (and for the in-step and AE masks)
  against the JAX module's on the same scores and masks.
"""
import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu import config as JC
from strainer_gan_tpu.data import DeviceDataset as JDataset, build_mixture as jax_mixture
from strainer_gan_tpu.models import Discriminator64 as JDisc, Generator64 as JGen
from strainer_gan_tpu.ops import gmm as JG, stats as JS
from strainer_gan_tpu.parity import agreement as JAG
from strainer_gan_tpu.strain import engine as JE, thresholds as JTH
from strainer_gan_tpu.train.state import create_state

from strainer_gan_tpu_torch import bridge, config as PC
from strainer_gan_tpu_torch.data import DeviceDataset, build_mixture
from strainer_gan_tpu_torch.models import Discriminator64
from strainer_gan_tpu_torch.ops import gmm as PG, stats as PS
from strainer_gan_tpu_torch.parity import agreement as PAG
from strainer_gan_tpu_torch.strain import engine as PE, thresholds as PTH

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bimodal(seed, n=20_000, sep=2.0, noisy_frac=0.2):
    """BCE-like losses: a clean mode and a noisy one, log-normal."""
    rng = np.random.default_rng(seed)
    k = int(n * noisy_frac)
    x = np.concatenate([np.exp(rng.normal(np.log(0.3), 0.5, n - k)),
                        np.exp(rng.normal(np.log(0.3 * np.exp(sep)), 0.4, k))])
    rng.shuffle(x)
    return x.astype(np.float32), rng.random(n) > 0.1


def _margin(scores, thr):
    d = np.abs(np.asarray(scores, np.float64) - float(thr))
    return float(np.min(d[d > 0]))


@pytest.mark.parametrize("sep", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("masked", [False, True])
def test_fit_gmm2_matches_jax(sep, masked):
    x, v = bimodal(int(sep * 10) + masked, sep=sep)
    v = v if masked else None
    jv = None if v is None else jnp.asarray(v)
    pv = None if v is None else torch.from_numpy(v)
    want = JG.fit_gmm2(jnp.asarray(x), jv)
    got = PG.fit_gmm2(torch.from_numpy(x), pv)
    for name, w, g in zip(("means", "vars", "weights"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REL, err_msg=name)
    thr_j = float(JG.gmm_threshold(jnp.asarray(x), jv))
    thr_p = PG.gmm_threshold(torch.from_numpy(x), pv)
    assert abs(float(thr_p) - thr_j) <= REL * abs(thr_j)
    mask_j, _ = JTH.gmm_mask(jnp.asarray(x), jv)
    mask_p, _ = PTH.gmm_mask(torch.from_numpy(x), pv)
    print(f"sep {sep}, valid {masked}: threshold {float(thr_p):.8g} (JAX {thr_j:.8g}), "
          f"nearest margin {_margin(x, thr_j):.3g}")
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))


def test_equal_variance_is_the_midpoint():
    gmm = (np.array([0.5, 2.0], np.float32), np.array([0.09, 0.09], np.float32),
           np.array([0.7, 0.3], np.float32))
    want = JG.gaussian_intersection_threshold(JG.GMM1D(*map(jnp.asarray, gmm)))
    got = PG.gaussian_intersection_threshold(PG.GMM1D(*map(torch.from_numpy, gmm)))
    assert float(got) == float(want) == 1.25


def test_one_mode():
    rng = np.random.default_rng(3)
    x = np.exp(rng.normal(np.log(0.5), 0.3, 5000)).astype(np.float32)
    want = JG.fit_gmm2(jnp.asarray(x))
    got = PG.fit_gmm2(torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REL)
    thr_j = float(JG.gmm_threshold(jnp.asarray(x)))
    thr_p = float(PG.gmm_threshold(torch.from_numpy(x)))
    assert np.isfinite(thr_j) and abs(thr_p - thr_j) <= REL * abs(thr_j)


@pytest.mark.parametrize("masked", [False, True])
def test_iqr_and_ensemble_match_jax(masked):
    x, v = bimodal(5)
    jv, pv = (jnp.asarray(v), torch.from_numpy(v)) if masked else (None, None)
    for q in (25.0, 75.0):
        want = np.asarray(JS.percentile(jnp.asarray(x), q) if jv is None
                          else JS.masked_percentile(jnp.asarray(x), jv, q))
        got = (PS.percentile(torch.from_numpy(x), q) if pv is None
               else PS.masked_percentile(torch.from_numpy(x), pv, q)).numpy()
        assert got.tobytes() == want.tobytes()
    want = np.asarray(JS.iqr_threshold(jnp.asarray(x), jv))
    assert PS.iqr_threshold(torch.from_numpy(x), pv).numpy().tobytes() == want.tobytes()
    mask_j, thr_j = JTH.ensemble_mask(jnp.asarray(x), jv)
    mask_p, thr_p = PTH.ensemble_mask(torch.from_numpy(x), pv)
    assert abs(float(thr_p) - float(thr_j)) <= REL * abs(float(thr_j))
    print(f"ensemble threshold {float(thr_p):.8g} (JAX {float(thr_j):.8g}), nearest margin "
          f"{_margin(x, thr_j):.3g}")
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))


@pytest.mark.parametrize("n_true,ratio,want", [(45_000, 0.9, 40_500), (45_000, 0.7, 31_500),
                                               (20_000, 0.8, 16_000), (1_234, 0.9, 1_110)])
def test_keep_count_and_truncation_match_jax(n_true, ratio, want):
    rng = np.random.default_rng(n_true)
    mask = np.zeros(n_true + 5_000, bool)
    mask[rng.choice(mask.size, n_true, replace=False)] = True
    jcount = (jnp.sum(jnp.asarray(mask)) * ratio).astype(jnp.int32)
    pcount = PE.keep_count(torch.from_numpy(mask), ratio)
    assert int(pcount) == int(jcount) == want
    got = PE._truncate_in_order(torch.from_numpy(mask), pcount).numpy()
    np.testing.assert_array_equal(got, np.asarray(JE._truncate_in_order(jnp.asarray(mask),
                                                                         jcount)))
    assert got.sum() == want and got[:np.nonzero(got)[0][-1]].sum() == want - 1


# ---------------------------------------------------------------- the engines
WIDTH, MAX_SYNTH = 8, 150


def _cfgs(name):
    jcfg = JC.get_preset(name)
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, ndf=WIDTH, ngf=WIDTH,
                                                  compute_dtype="float32"),
                        strain=dataclasses.replace(jcfg.strain, score_batch=64))
    return jcfg, PC.ExperimentConfig.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def data():
    jcfg, pcfg = _cfgs("loss_gmm")
    jds = JDataset(jax_mixture(jcfg.data, max_synth=MAX_SYNTH))
    pds = DeviceDataset(build_mixture(pcfg.data, max_synth=MAX_SYNTH), "cpu")
    np.testing.assert_array_equal(pds.images.numpy(), np.asarray(jds.images))
    gen = JGen(nz=100, ngf=WIDTH, compute_dtype=jnp.float32)
    disc = JDisc(ndf=WIDTH, compute_dtype=jnp.float32)
    state = jax.jit(lambda k: create_state(jcfg, gen, disc, k))(jax.random.PRNGKey(2))
    return jds, pds, disc, state


def _perturbed(state, epoch):
    """D's weights moved by seeded noise, the same on both sides, and its
    last layer scaled by 4,000: the initial D scores every image near
    log 2, and two mixture components fitted to such losses coincide,
    where the intersection is a ratio of two rounding errors (ROADMAP §3)."""
    rng = np.random.default_rng(100 + epoch)
    params = jax.tree.map(lambda p: np.asarray(p) * (1 + 0.3 * rng.standard_normal(p.shape))
                          .astype(np.float32), state.d_params)
    params["Conv2dTorch_4"]["kernel"] = params["Conv2dTorch_4"]["kernel"] * np.float32(4000)
    stats = jax.tree.map(np.asarray, state.d_stats)
    return state.replace(d_params=jax.tree.map(jnp.asarray, params)), params, stats


@pytest.mark.parametrize("name,epochs", [("loss_gmm", 4), ("loss_ensemble", 6)])
def test_engine_arms_match_jax(data, name, epochs):
    jds, pds, jdisc, state = data
    jcfg, pcfg = _cfgs(name)
    tdisc = Discriminator64(WIDTH)
    jeng = JE.StrainerEngine(jcfg, jdisc, jds, score_batch=64)
    peng = PE.StrainerEngine(pcfg, tdisc, pds, score_batch=64)
    sc = pcfg.strain
    for e in range(epochs):
        st, params, stats = _perturbed(state, e)
        bridge.load_dcgan_from_flax(tdisc, params, stats)
        jmask = np.asarray(jeng.on_epoch_start(e, st, jax.random.PRNGKey(e)))
        pmask = peng.on_epoch_start(e).numpy()
        np.testing.assert_array_equal(pmask, jmask, err_msg=f"epoch {e}")
        if e < sc.start_epoch:
            assert pmask.all() and peng.last_mask is None
        else:
            jl, pl_ = np.asarray(jeng.last_scores), peng.last_scores.numpy()
            np.testing.assert_allclose(pl_, jl, rtol=1e-5, atol=1e-6)
            thr_j = float(jeng.last_threshold)
            assert abs(float(peng.last_threshold) - thr_j) <= REL * abs(thr_j)
            kept = int(pmask.sum())
            print(f"{name} epoch {e}: kept {kept}/{pmask.size}, threshold "
                  f"{float(peng.last_threshold):.8g} (JAX {thr_j:.8g}), nearest margin "
                  f"{_margin(jl, thr_j):.3g}")
            assert 0 < kept < pmask.size
            if name == "loss_ensemble":
                # the clean-ratio schedule truncates the ensemble's keep in order
                full = np.asarray(JTH.ensemble_mask(jnp.asarray(jl))[0])
                ratio = dict(sc.clean_ratio_schedule)[max(k for k, _ in sc.clean_ratio_schedule
                                                         if k <= e)]
                assert kept == int(np.float32(full.sum()) * np.float32(ratio))
        assert peng.d_bn_eval == jeng.d_bn_eval == (sc.bn_eval_after_score and e >= sc.start_epoch)
        jend = np.asarray(jeng.on_epoch_end(e))
        pend = peng.on_epoch_end(e).numpy()
        np.testing.assert_array_equal(pend, jend)
        assert pend.all()  # reset_each_epoch: back to the full set


def test_loss_space_scores_the_whole_set(data):
    """With a base subset present (here set by hand), loss_gmm still scores
    and thresholds every sample."""
    jds, pds, jdisc, state = data
    jcfg, pcfg = _cfgs("loss_gmm")
    state, params, stats = _perturbed(state, 0)
    tdisc = bridge.load_dcgan_from_flax(Discriminator64(WIDTH), params, stats)
    base = np.random.default_rng(9).random(pds.n) > 0.3
    jeng = JE.StrainerEngine(jcfg, jdisc, jds, score_batch=64)
    peng = PE.StrainerEngine(pcfg, tdisc, pds, score_batch=64)
    jeng._set_base(jnp.asarray(base))
    peng._set_base(torch.from_numpy(base))
    assert peng._base_subset is not None
    jmask = np.asarray(jeng.on_epoch_start(0, state, jax.random.PRNGKey(0)))
    pmask = peng.on_epoch_start(0).numpy()
    assert np.isfinite(peng.last_scores.numpy()).all()
    np.testing.assert_array_equal(pmask, jmask)
    assert pmask[~base].any()


# ----------------------------------------------------------- the parity report
@pytest.mark.parametrize("method", ["loss_gmm", "loss_ensemble", "autoencoder",
                                    "batch_quantile_mask"])
def test_agreement_report_matches_jax(method):
    rng = np.random.default_rng(12)
    scores, _ = bimodal(12, n=600)
    mask = scores < np.quantile(scores, 0.8)
    mask[:7] = ~mask[:7]
    engine = dict(last_scores=scores, last_mask=mask,
                  last_batch_scores=rng.random(128).astype(np.float32),
                  last_batch_mask=rng.random(128) > 0.1)
    preset = {"batch_quantile_mask": "batch_mask"}.get(method, method)
    jt = types.SimpleNamespace(cfg=JC.get_preset(preset), engine=types.SimpleNamespace(
        last_batch_valid=77, **engine))
    pt = types.SimpleNamespace(cfg=PC.get_preset(preset), engine=types.SimpleNamespace(
        last_batch_valid=77, **{k: torch.from_numpy(v) for k, v in engine.items()}))
    want = JAG.agreement_report(jt, epoch=5)
    got = PAG.agreement_report(pt, epoch=5)
    assert got == want and got["method"] == method
    assert got["n"] == (77 if method == "batch_quantile_mask" else 600)
