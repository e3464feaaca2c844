"""Multi-host sample-sharded staging on the CPU (gloo, one torch thread a
rank), against the replicated rank path and against the JAX package.

* Each rank's shard (``parallel.multihost.shard_bounds``,
  ``DeviceDataset.from_rank_local``) is byte-equal to the rows the JAX
  Trainer's formula (`strainer_gan_tpu/train/loop.py:188-191`) cuts from
  the JAX package's ``build_mixture``, at world sizes 2 and 3, with a
  trimmed ``n``.
* Two spawned ranks, each a host of its own (``LOCAL_WORLD_SIZE=1``:
  ``host_count() == 2``), through tests/test_torch_multihost_worker.py:

  - a ``basic`` step and a ``batch_mask`` step on a sharded dataset whose
    rows are shuffled, so that each rank's lanes come from both shards
    through the exchange, bit-equal to the replicated 2-rank step of
    tests/test_torch_dp_worker.py (which tests/test_torch_dp.py holds to
    the JAX dp mesh): metrics, parameters, buffers, Adam moments, lanes;
  - tiny ``final`` (z-score prefilter, then the band path's loss strain),
    ``autoencoder`` (the AE trained on every rank) and
    ``strainer_concat_fast`` (prefilter, the outlier pool, the pooled
    step, the loss strain), each staged sharded by the Trainer and bit-equal
    to the replicated 2-rank run on the trimmed mixture: masks, scores,
    parameters, buffers, Adam state, the pool's bytes and rows, the AE,
    losses, console text; every strain epoch of a sharded run blocks;
  - ``final``'s masks, step and active counts equal the JAX Trainer's on
    the same trimmed dataset with its draws and initial state injected,
    its console values and loss series within 2e-2
    (tests/test_torch_deferred.py's bound);
  - ``--dp 2`` through the command line stages halves, and the periodic
    FID and ``--eval`` (rank 0's ``evaluate_run`` replaced by a recorder)
    get the rows the replicated dataset gives, without a hang.

The ranks are joined with a 240 s limit and every collective times out
after 60 s, so a hang fails these tests instead of the suite.
"""
import dataclasses
import io
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from strainer_gan_tpu.config import ExperimentConfig as JConfig
from strainer_gan_tpu.data import DeviceDataset as JDataset, build_mixture as jax_mixture
from strainer_gan_tpu.data.mixers import Mixture as JMixture
from strainer_gan_tpu.models.resnet import load_torch_resnet_state_dict, resnet18_features
from strainer_gan_tpu.models.synth_weights import synth_resnet_state_dict
from strainer_gan_tpu.obs.metrics import MetricsLogger as JLogger
from strainer_gan_tpu.train import loop as JL
from strainer_gan_tpu.train.loop import Trainer as JTrainer

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.data import DeviceDataset, Mixture, build_mixture
from strainer_gan_tpu_torch.models import Discriminator64, Generator64, build_models
from strainer_gan_tpu_torch.parallel.multihost import shard_bounds

import test_torch_dp_worker as DW
import test_torch_multihost_worker as W
import test_torch_ranks as R

JOIN_S = 240
WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(cfg):
    return JConfig.from_json(cfg.to_json())


def _jax_cut(images, pid, np_):
    """`strainer_gan_tpu/train/loop.py:188-191`."""
    n = images.shape[0]
    n = (n // np_) * np_
    lo, hi = pid * n // np_, (pid + 1) * n // np_
    return images[lo:hi], n


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("preset", ["batch_mask", "final"])
def test_shards_are_the_jax_cut(preset, world):
    cfg = W.tiny_cfg(preset) if preset == "final" else DW.tiny(get_preset(preset))
    want = jax_mixture(_jax_cfg(cfg).data, max_synth=W.MAX_SYNTH)
    mix = build_mixture(cfg.data, max_synth=W.MAX_SYNTH)
    n_all = len(mix)
    assert n_all in (27, 37)
    trimmed = False
    for r in range(world):
        lo, hi, n = shard_bounds(n_all, r, world)
        cut, jn = _jax_cut(want.images, r, world)
        ds = DeviceDataset.from_rank_local(
            Mixture(mix.images[lo:hi], mix.source_id[lo:hi], mix.labels[lo:hi]), n, "cpu",
            rank=r)
        assert ds.sharded and ds.n == jn and ds.lo == lo
        np.testing.assert_array_equal(ds.images.numpy(), cut)
        np.testing.assert_array_equal(ds.source_id.numpy(), _jax_cut(want.source_id, r, world)[0])
        trimmed |= n < n_all
    assert trimmed or (world, n_all) == (3, 27)


def _jax_feature_fn():
    fmodel = resnet18_features(3)
    fvars = jax.jit(lambda k, a: fmodel.init({"params": k}, a))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    fvars = jax.tree.map(jnp.asarray, load_torch_resnet_state_dict(
        fvars, synth_resnet_state_dict(fvars)))
    return jax.jit(lambda x: fmodel.apply(fvars, x, train=False))


def _jax_final(n_trim):
    """The JAX Trainer for ``final`` on the trimmed mixture (per-step
    dispatch: the same draws, without the chunked executors' compiles), its
    initial state and the draws its run makes."""
    jcfg = _jax_cfg(W.tiny_cfg("final"))
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, steps_per_dispatch=1))
    mix = jax_mixture(jcfg.data, max_synth=W.MAX_SYNTH)
    ds = JDataset(JMixture(images=mix.images[:n_trim], source_id=mix.source_id[:n_trim],
                           labels=mix.labels[:n_trim]))
    build = JL.create_state
    JL.create_state = lambda cfg, gen, disc, k: jax.jit(
        lambda kk: build(cfg, gen, disc, kk))(k)
    stream = io.StringIO()
    try:
        jtr = JTrainer(jcfg, feature_fn=_jax_feature_fn(), dataset=ds,
                       logger=JLogger(log_every=2, stream=stream))
    finally:
        JL.create_state = build
    # the JAX Trainer's keys (`strainer_gan_tpu/train/loop.py:213,275,335`)
    key = jax.random.split(jax.random.PRNGKey(jcfg.train.seed))[0]
    key = jax.random.split(key, 3)[0]
    rows = -(-n_trim // W.B)
    perms, zs = [], []
    for _ in range(jcfg.train.epochs):
        key, _, k_perm, k_steps = jax.random.split(key, 4)
        bits = np.asarray(jax.random.bits(k_perm, (n_trim,), jnp.uint32) >> jnp.uint32(1))
        perms.append(torch.from_numpy(np.argsort(bits, kind="stable").astype(np.int64)))
        zs.append(torch.from_numpy(np.stack([np.asarray(jax.random.normal(
            jax.random.split(k, 6)[0], (W.B, 100), jnp.float32))
            for k in jax.random.split(k_steps, rows)])))
    state = jtr.state
    width = W.tiny_cfg("final").model.ngf
    gen = bridge.load_dcgan_from_flax(Generator64(100, width), _np(state.g_params),
                                      _np(state.g_stats))
    disc = bridge.load_dcgan_from_flax(Discriminator64(width), _np(state.d_params),
                                       _np(state.d_stats))
    return jtr, stream, dict(jax_gen=gen.state_dict(), jax_disc=disc.state_dict(),
                             jax_perms=perms, jax_z=zs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, and the JAX ``final`` run made while they
    train."""
    tmp = tmp_path_factory.mktemp("multihost")
    n_trim = shard_bounds(len(build_mixture(W.tiny_cfg("final").data, W.MAX_SYNTH)), 0,
                          WORLD)[2]
    jtr, jstream, jax_inputs = _jax_final(n_trim)
    gen, disc = build_models(DW.tiny(get_preset("basic")).model, seed=5)
    rng = np.random.default_rng(0)
    order = torch.from_numpy(rng.permutation(DW.B))
    inputs = dict(gen=gen.state_dict(), disc=disc.state_dict(),
                  batch=torch.from_numpy(rng.integers(0, 256, (DW.B, 64, 64, 3)).astype(np.uint8)),
                  src=torch.from_numpy((rng.uniform(size=DW.B) < 0.3).astype(np.int32)),
                  z=torch.from_numpy(rng.standard_normal((DW.B, 100)).astype(np.float32)),
                  order=order, lr=2e-4, **jax_inputs)
    torch.save(inputs, tmp / "inputs.pt")
    ranks = R.Ranks(W.run_rank, WORLD, tmp, "multihost", args=(str(tmp),), local_world=1)
    try:
        jout = jtr.run()  # while the ranks train
    finally:
        ranks.join(JOIN_S)
    outs = [torch.load(tmp / f"out_{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(ranks=outs, inputs=inputs, jtr=jtr, jout=jout, jtext=jstream.getvalue(),
                n_trim=n_trim)


def _equal(a, b, what):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b), what
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def test_every_rank_is_a_host(runs):
    assert [r["hosts"] for r in runs["ranks"]] == [WORLD, WORLD]


@pytest.mark.parametrize("case", ["full", "mask"])
def test_sharded_step_bit_equal_replicated(runs, case):
    where = torch.argsort(runs["inputs"]["order"])
    half = DW.B // WORLD
    for r, out in enumerate(runs["ranks"]):
        # the rank's lanes come from both shards
        lanes = where[r * half:(r + 1) * half]
        assert (lanes < half).any() and (lanes >= half).any()
        _equal(out["steps"][(case, "sharded")], out["steps"][(case, "replicated")],
               f"rank {r} {case}")
    a, b = (out["steps"][(case, "sharded")] for out in runs["ranks"])
    _equal(a["metrics"], b["metrics"], f"{case} across ranks")
    _equal(a["state"], b["state"], f"{case} across ranks")
    if case == "mask":
        keep = a["metrics"]["keep_mask"]
        assert 0 < int(keep.sum()) < DW.B


@pytest.mark.parametrize("preset", W.PRESETS)
def test_sharded_trainer_bit_equal_replicated(runs, preset):
    n = runs["n_trim"]
    want = jax_mixture(_jax_cfg(W.tiny_cfg(preset)).data, max_synth=W.MAX_SYNTH)
    assert n == (len(want.images) // WORLD) * WORLD < len(want.images)
    for r, out in enumerate(runs["ranks"]):
        got = out["trainers"][preset]
        sharded, lo, images, src, n_ds = got["shard"]
        assert sharded and n_ds == n and lo == r * n // WORLD
        np.testing.assert_array_equal(images.numpy(), _jax_cut(want.images, r, WORLD)[0])
        np.testing.assert_array_equal(src.numpy(), _jax_cut(want.source_id, r, WORLD)[0])
        s, rep = got["sharded"], got["replicated"]
        _equal(s, {k: v for k, v in rep.items() if k != "paths"} | {"paths": s["paths"]},
               f"rank {r} {preset}")
        # every strain event of the sharded run blocks
        assert s["paths"][0] == 0 and s["paths"][1] == 2, s["paths"]
        assert len(s["masks"]) == 2 and s["text"]
    a, b = (out["trainers"][preset]["sharded"] for out in runs["ranks"])
    _equal({k: v for k, v in a.items() if k != "text"},
           {k: v for k, v in b.items() if k != "text"}, f"{preset} across ranks")
    if preset == "final":
        assert not a["masks"][-1].all()  # the loss strain removed samples
    if preset == "autoencoder":
        assert a["ae"] is not None
        # the replicated run deferred its strain epoch; the sharded one blocked
        assert runs["ranks"][0]["trainers"][preset]["replicated"]["paths"][0] == 1
    if preset == "strainer_concat_fast":
        assert a["pool"] is not None and a["pool"].shape[0] == max(int(n * 0.1), 1)


def test_sharded_final_matches_jax(runs):
    got = runs["ranks"][0]["trainers"]["final"]["sharded"]
    jtr, jout = runs["jtr"], runs["jout"]
    assert [(s, a) for s, a, _, _ in got["results"]] == [(o["steps"], o["active"]) for o in jout]
    assert len(got["masks"]) == len(jtr.mask_history) == 2
    for m, jm in zip(got["masks"], jtr.mask_history):
        np.testing.assert_array_equal(m, np.asarray(jm))
    lines = [ln for ln in got["text"].splitlines() if ln.startswith(("[", "Epoch"))]
    jlines = [ln for ln in runs["jtext"].splitlines() if ln.startswith(("[", "Epoch"))]
    assert [ln for ln in lines if "Removed" in ln] == [ln for ln in jlines if "Removed" in ln]
    num = re.compile(r"-?\d+\.\d+")
    assert len(lines) == len(jlines)
    for ln, jln in zip(lines, jlines):
        np.testing.assert_allclose([float(v) for v in num.findall(ln)],
                                   [float(v) for v in num.findall(jln)], atol=2e-2)
    np.testing.assert_allclose(got["G"], jtr.logger.G_losses, atol=2e-2)
    np.testing.assert_allclose(got["D"], jtr.logger.D_losses, atol=2e-2)
    for h, jh in zip(got["history"], jtr.epoch_loss_history):
        np.testing.assert_allclose(h, np.asarray(jh), atol=2e-2)


def test_cli_stages_halves_and_gathers_eval_rows(runs):
    cfg = W.tiny_cfg("final")
    mix = build_mixture(cfg.data, max_synth=W.MAX_SYNTH)
    n = runs["n_trim"]
    src = mix.source_id[:n]
    for r, out in enumerate(runs["ranks"]):
        sharded, lo, images, n_ds = out["cli"]["shard"]
        assert sharded and n_ds == n and lo == r * n // WORLD
        np.testing.assert_array_equal(images.numpy(), mix.images[lo:lo + n // WORLD])
        assert len(out["cli"]["masks"]) == cfg.train.epochs
    seen = runs["ranks"][0]["cli"]["seen"]
    assert runs["ranks"][1]["cli"]["seen"] == [] and runs["ranks"][1]["cli"]["eval"] is None
    assert runs["ranks"][0]["cli"]["eval"] == {"fid_real": 0.0}
    # the periodic FID after each of the 2 epochs, then --eval
    assert [k for _, _, k in seen] == [6, 6, 5]
    for images, ids, k in seen:
        rows = np.sort(np.concatenate([np.nonzero(src == 0)[0][:k], np.nonzero(src != 0)[0][:k]]))
        np.testing.assert_array_equal(images.numpy(), mix.images[rows])
        np.testing.assert_array_equal(ids.numpy(), src[rows])
