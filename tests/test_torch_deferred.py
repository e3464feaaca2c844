"""The deferred-stats executor (CPU, float32, one torch thread): the gated
chunk and the gated partial tail against the JAX package's
``make_gated_chunked_train_step`` and ``make_gated_tail_step``, and the
port's deferred Trainer against its blocking Trainer and against the JAX
deferred Trainer.

* Gated chunk (chunk 2, from weights bridged out of a flax state, on a
  fixed uint8 dataset, with the noise the JAX step draws from each key,
  entry 0 of ``jax.random.split(key, 6)``), the three cases of
  `tests/test_deferred.py:75-150`: all live (``n_valid`` 2), a live
  prefix (``n_valid`` 1: the second step dead) and none live.  Live rows
  of the metrics, parameters, BatchNorm buffers and Adam moments at
  tests/test_torch_step.py's atol 1e-5 / rtol 1e-4 after one step; after
  two free-running steps the same, except that parameters whose Adam
  first moment is at float32 noise level (|mu| <= 1e-6 of the tensor's
  largest) are held to |update| <= 2 lr (Adam turns the last bits of a
  noise-level gradient into an O(lr) update of either sign).  A dead step
  or chunk leaves every parameter, buffer, Adam moment and Adam step count
  bit-unchanged, on both sides.
* Gated tail, ``tail_count`` 5 (one lane-masked step at the tolerance
  above) and 0 (bit-unchanged); its step reads no lane count on the host.
* ``final`` (tiny) over four epochs whose strain makes epoch 2 shrink
  (its guess overshoots: wholly dead trailing chunks) and epoch 3 grow (a
  catch-up), both with a partial tail: ``defer_epoch_stats`` True against
  False, bit for bit (parameters, buffers, Adam state, epoch results,
  console text and, with ``collect``, the loss series, mask and
  per-sample loss histories), for both values of ``collect``; the
  generators' states after every epoch equal (the draw invariant), also
  for a fake-pool config, whose pool rows come from a second generator.
* The port's deferred strain epoch against the JAX Trainer's (which
  defers every strain epoch), with the JAX draws handed to the port:
  step counts, active counts and masks exactly; console values, loss
  series and per-sample losses within 2e-2 (tests/test_torch_chunked.py's
  bound for free-running chains).
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
from strainer_gan_tpu.data import DeviceDataset as JDataset
from strainer_gan_tpu.data.mixers import Mixture as JMixture
from strainer_gan_tpu.data.pipeline import epoch_batch_indices as jax_epoch_indices
from strainer_gan_tpu.obs.metrics import MetricsLogger as JLogger
from strainer_gan_tpu.train import loop as JL
from strainer_gan_tpu.train.loop import Trainer as JTrainer

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.data import DeviceDataset, Mixture, build_mixture, normalize_u8
from strainer_gan_tpu_torch.data.pipeline import device_full_and_tail, device_step_count
from strainer_gan_tpu_torch.models import build_models
from strainer_gan_tpu_torch.obs.metrics import MetricsLogger
from strainer_gan_tpu_torch.train import steps as ST
from strainer_gan_tpu_torch.train.loop import Trainer
from strainer_gan_tpu_torch.train.state import make_optimizers

from test_torch_batch_mask import _port_modules
from test_torch_chunked import _HostOps
from test_torch_step import ATOL, RTOL, _np

WIDTH, B = 8, 8
LR = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfg, **train):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=B),
        model=dataclasses.replace(cfg.model, ngf=WIDTH, ndf=WIDTH, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **train))


# ---- one JAX deferred run: its gated executors, and the port's run beside it

CHUNK = 4
N_JAX = 100  # 50 kept at epoch 0 (6 full steps, a tail of 2), 40 at 1 (5 full)


def _jax_cfg(cfg):
    cfg = _tiny(cfg, epochs=2, log_every=2, sample_every=0, steps_per_dispatch=CHUNK,
                defer_epoch_stats=True, seed=11)
    return cfg.replace(strain=dataclasses.replace(
        cfg.strain, start_epoch=0, prefilter=False, score_precision="f32", score_batch=32,
        clean_ratio_schedule=((0, 0.5), (1, 0.6))))


@pytest.fixture(scope="module")
def jax_run():
    """``final`` (tiny, strain from epoch 0 with f32 scoring, drop_last off)
    for two epochs: the JAX Trainer defers both; the port blocks at epoch 0
    (its warm-up) and defers epoch 1, on the JAX draws.  Also the JAX
    Trainer's own gated executors and its initial state, for the executor
    tests (its static arguments: d_train off, as after final's strain)."""
    jcfg, pcfg = _jax_cfg(jax_preset("final")), _jax_cfg(get_preset("final"))
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (N_JAX, 64, 64, 3)).astype(np.uint8)
    src = (rng.random(N_JAX) < 0.2).astype(np.int32)
    labels = np.zeros((N_JAX,), np.int64)
    jstream = io.StringIO()
    # the JAX state built in one compiled program, not op by op (the same
    # state reaches both sides, so its last bits do not matter)
    build = JL.create_state
    JL.create_state = lambda cfg, gen, disc, k: jax.jit(
        lambda kk: build(cfg, gen, disc, kk))(k)
    try:
        jtr = JTrainer(jcfg, logger=JLogger(log_every=2, stream=jstream),
                       dataset=JDataset(JMixture(images=images, source_id=src, labels=labels)))
    finally:
        JL.create_state = build
    state0 = jax.tree.map(jnp.copy, jtr.state)
    pstream = io.StringIO()
    tr = Trainer(pcfg, device="cpu", dataset=DeviceDataset(Mixture(images, src, labels), "cpu"),
                 logger=MetricsLogger(log_every=2, stream=pstream))
    for mod, params, stats in ((tr.gen, state0.g_params, state0.g_stats),
                               (tr.disc, state0.d_params, state0.d_stats)):
        bridge.load_dcgan_from_flax(mod, _np(params), _np(stats))
    # the JAX Trainer's keys (`strainer_gan_tpu/train/loop.py:196,262,334`);
    # a deferred epoch splits its step keys over the capacity's rows
    key = jax.random.split(jax.random.PRNGKey(jcfg.train.seed))[0]
    key = jax.random.split(key, 3)[0]  # setup()
    rows = -(-(-(-N_JAX // B)) // CHUNK) * CHUNK
    perms, keys = [], []
    for _ in range(jcfg.train.epochs):
        key, _, k_perm, k_steps = jax.random.split(key, 4)
        perms.append(k_perm)
        keys.append(jax.random.split(k_steps, rows))
    zs = [[np.asarray(jax.random.normal(jax.random.split(k, 6)[0], (B, 100), jnp.float32))
           for k in ks] for ks in keys]

    def indices(e, active, s):
        a = active.numpy()
        return torch.from_numpy(np.asarray(jax_epoch_indices(
            perms[e], jnp.asarray(a), s, B, all_active=bool(a.all()))).astype(np.int64))

    tr.epoch_indices = indices
    tr.step_noise = lambda e, i: torch.from_numpy(zs[e][i].copy())
    jout, out = jtr.run(), tr.run()
    return dict(jtr=jtr, jout=jout, jtext=jstream.getvalue(), tr=tr, out=out,
                text=pstream.getvalue(), state0=state0, images=images, src=src,
                keys=keys[1], z=np.stack(zs[1]), idx=rng.integers(0, N_JAX, (rows, B)))


def test_deferred_epoch_matches_jax(jax_run):
    r = jax_run
    tr, jtr, out, jout = r["tr"], r["jtr"], r["out"], r["jout"]
    assert tr.graph_stats["deferred_epochs"] == 1 and tr.graph_stats["blocking_epochs"] == 1
    for o, jo in zip(out, jout):
        assert (o["steps"], o["active"]) == (jo["steps"], jo["active"])
    assert out[0]["active"] % B and N_JAX > out[0]["active"] > out[1]["active"] > 0
    for m, jm in zip(tr.mask_history, jtr.mask_history):
        np.testing.assert_array_equal(m, np.asarray(jm))
    lines = [ln for ln in r["text"].splitlines() if ln.startswith(("[", "Epoch"))]
    jlines = [ln for ln in r["jtext"].splitlines() if ln.startswith(("[", "Epoch"))]
    assert [ln.split("\t")[0] for ln in lines] == [ln.split("\t")[0] for ln in jlines]
    assert [ln for ln in lines if "Removed" in ln] == [ln for ln in jlines if "Removed" in ln]
    num = re.compile(r"-?\d+\.\d+")
    for ln, jln in zip(lines, jlines):
        np.testing.assert_allclose([float(v) for v in num.findall(ln)],
                                   [float(v) for v in num.findall(jln)], atol=2e-2)
    np.testing.assert_allclose(tr.logger.G_losses, jtr.logger.G_losses, atol=2e-2)
    np.testing.assert_allclose(tr.logger.D_losses, jtr.logger.D_losses, atol=2e-2)
    assert len(tr.epoch_loss_history) == len(jtr.epoch_loss_history) == 2
    for h, jh in zip(tr.epoch_loss_history, jtr.epoch_loss_history):
        np.testing.assert_allclose(h, np.asarray(jh), atol=2e-2)


def _port_gated(r, tail=False):
    cfg = _tiny(get_preset("final"))
    gen, disc, opt_g, opt_d = _port_modules(cfg, r["state0"])
    ds = DeviceDataset(Mixture(r["images"], r["src"], np.zeros(N_JAX, np.int64)), "cpu")
    scfg = ST.step_config_from(cfg)
    # the metrics' shapes, from a step of a throwaway copy
    like = ST.train_step(*_port_modules(cfg, r["state0"]), normalize_u8(ds.gather(
        torch.arange(B))), ds.source_id[:B], torch.zeros((B, 100)), LR, LR, scfg)
    return ST.GatedChunkedStep(gen, disc, opt_g, opt_d, ds, scfg, 1 if tail else CHUNK, like,
                               mask_on=False, d_train=False, stats={}, tail=tail)


def _snapshot(ex):
    """Every tensor a step writes: parameters, buffers, Adam state."""
    out = {f"gen.{k}": v.clone() for k, v in ex.gen.state_dict().items()}
    out.update({f"disc.{k}": v.clone() for k, v in ex.disc.state_dict().items()})
    for name, opt in (("opt_g", ex.opt_g), ("opt_d", ex.opt_d)):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": torch.as_tensor(v).clone() for k, v in st.items()})
    return out


def _assert_state_close(ex, jstate, before, steps):
    """The port's state against a JAX state after ``steps`` live steps
    (parameters with the noise-level carve-out of the module docstring)."""
    for name, params, stats, opt, prev, popt in (
            ("gen", jstate.g_params, jstate.g_stats, jstate.g_opt, before.g_params, ex.opt_g),
            ("disc", jstate.d_params, jstate.d_stats, jstate.d_opt, before.d_params, ex.opt_d)):
        module = getattr(ex, name)
        got = bridge.dcgan_to_flax(module)
        mu, nu = bridge.adam_moments_to_flax(module, popt)
        for want, have, what in ((stats, got["batch_stats"], "BN"), (opt.mu, mu, "Adam mu"),
                                 (opt.nu, nu, "Adam nu")):
            for (path, w), h in zip(jax.tree_util.tree_leaves_with_path(want),
                                    jax.tree_util.tree_leaves(have)):
                np.testing.assert_allclose(h, np.asarray(w), atol=ATOL, rtol=RTOL,
                                           err_msg=f"{name} {what} {path}")
        for (path, w), h, b, m in zip(jax.tree_util.tree_leaves_with_path(params),
                                      jax.tree_util.tree_leaves(got["params"]),
                                      jax.tree_util.tree_leaves(prev),
                                      jax.tree_util.tree_leaves(opt.mu)):
            w, h, b, m = (np.asarray(a) for a in (w, h, b, m))
            noisy = np.abs(m) <= 1e-6 * np.abs(m).max()
            np.testing.assert_allclose(h[~noisy], w[~noisy], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{name} params {path}")
            for p in (h, w):
                assert np.all(np.abs(p[noisy] - b[noisy]) <= steps * LR * (1 + 1e-3)), path
        assert all(float(st["step"]) == steps for st in popt.state.values())


def _jax_args(r, n):
    return (jax.tree.map(jnp.copy, r["state0"]), r["jtr"].dataset.images,
            r["jtr"].dataset.source_id, jnp.asarray(r["idx"][:n].astype(np.int32)))


@pytest.mark.parametrize("n_valid", [CHUNK, 2, 0], ids=["all_live", "prefix", "none_live"])
def test_gated_chunk_matches_jax(jax_run, n_valid):
    """The JAX Trainer's own gated executor (`steps.py:476`) and the port's
    ``GatedChunkedStep`` on one chunk from the same state and draws."""
    r = jax_run
    s0 = r["state0"]
    s1, jm = r["jtr"]._gated_fn(*_jax_args(r, CHUNK), r["keys"][:CHUNK], 0, jnp.int32(n_valid),
                                LR, LR, False, jnp.asarray(False), None, False)
    ex = _port_gated(r)
    before = _snapshot(ex)
    idx = torch.from_numpy(r["idx"][:CHUNK].astype(np.int64))
    z = torch.from_numpy(r["z"][:CHUNK])
    m = ex(idx, z, LR, LR, 0, torch.tensor(n_valid))
    if n_valid == 0:
        assert all(torch.equal(_snapshot(ex)[k], v) for k, v in before.items())
        assert int(s1.step) == int(s0.step)
        for a, b in zip(jax.tree_util.tree_leaves((s1.g_params, s1.d_params, s1.g_stats)),
                        jax.tree_util.tree_leaves((s0.g_params, s0.d_params, s0.g_stats))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return
    _assert_state_close(ex, s1, s0, n_valid)
    assert int(s1.step) == int(s0.step) + n_valid
    for k in jm:
        np.testing.assert_allclose(m[k][:n_valid].numpy(), np.asarray(jm[k])[:n_valid],
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    # a chunk that starts at the live count is dead: nothing moves
    before = _snapshot(ex)
    ex(idx, z, LR, LR, n_valid, torch.tensor(n_valid))
    assert all(torch.equal(_snapshot(ex)[k], v) for k, v in before.items())


@pytest.mark.parametrize("tail", [5, 0])
def test_gated_tail_matches_jax(jax_run, tail):
    """The JAX Trainer's gated tail (`steps.py:575`) on row ``n_full`` of
    the epoch's index matrix, and the port's, its row taken on the device."""
    r = jax_run
    s0, n_full, rows = r["state0"], 3, r["idx"].shape[0]
    s1, jm = r["jtr"]._gated_tail_fn(*_jax_args(r, rows), r["keys"], jnp.int32(n_full),
                                     jnp.int32(tail), LR, LR, False, jnp.asarray(False), None,
                                     False)
    ex = _port_gated(r, tail=True)
    before = _snapshot(ex)
    idx = torch.from_numpy(r["idx"].astype(np.int64))
    row = torch.clamp(torch.tensor(n_full), max=rows - 1).reshape(1)
    m = ex(idx.index_select(0, row), torch.from_numpy(r["z"][n_full:n_full + 1]), LR, LR,
           0, torch.tensor(tail))
    if tail == 0:
        assert all(torch.equal(_snapshot(ex)[k], v) for k, v in before.items())
        assert int(s1.step) == int(s0.step)
        return
    _assert_state_close(ex, s1, s0, 1)
    for k in jm:
        np.testing.assert_allclose(m[k][0].numpy(), np.asarray(jm[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_tail_step_reads_no_lane_count_on_the_host(monkeypatch):
    """The gated tail's step with its lane count a device tensor: nothing a
    CUDA graph capture refuses (the optimizer's own step aside: torch's
    capturable Adam on the card)."""
    cfg = _tiny(get_preset("batch_mask"))
    gen, disc = build_models(cfg.model, seed=0)
    opt_g, opt_d = make_optimizers(cfg, gen, disc)
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    x = normalize_u8(torch.randint(0, 256, (B, 64, 64, 3), dtype=torch.uint8))
    src, z, lanes = torch.zeros(B, dtype=torch.int32), torch.randn((B, 100)), torch.tensor(5)
    with _HostOps() as mode:
        ST.step_body(gen, disc, opt_g, opt_d, x, src, z, ST.step_config_from(cfg),
                     lane_count=lanes, mask_on=True)
    assert mode.seen == []


def test_device_counts():
    active = torch.zeros(50, dtype=torch.bool)
    active[:37] = True
    assert device_full_and_tail(active, 8).tolist() == [4, 5]
    assert int(device_step_count(active, 8)) == 4
    assert int(device_step_count(active, 8, drop_last=False)) == 5
    active[:] = False
    assert device_full_and_tail(active, 8).tolist() == [0, 0]
    assert int(device_step_count(active, 8, drop_last=False)) == 0


# ---- the deferred Trainer against the blocking one

# the strain keeps ~50 % from epoch 1, ~10 % at 2 (``final``'s ratio
# inversion), ~50 % at 3
SCHEDULE = ((0, 1.0), (1, 0.5), (2, 0.9), (3, 0.5))
EPOCHS = 4


def _final_cfg(defer):
    cfg = _tiny(get_preset("final"), epochs=EPOCHS, log_every=3, sample_every=0,
                steps_per_dispatch=4, defer_epoch_stats=defer)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=4),
        strain=dataclasses.replace(cfg.strain, start_epoch=1, score_batch=16,
                                   clean_ratio_schedule=SCHEDULE))


def _run(cfg, dataset, collect, calls=None):
    """Run ``cfg`` recording the generators' states after each epoch and,
    into ``calls``, each gated call's (first step, live count)."""
    tr = Trainer(cfg, device="cpu", dataset=dataset,
                 logger=MetricsLogger(log_every=cfg.train.log_every, stream=io.StringIO(),
                                      collect=collect))
    tr.gen_states = []
    tr.setup()
    for e in range(cfg.train.epochs):
        mark = len(calls) if calls is not None else 0
        tr.run_epoch(e)
        tr.gen_states.append(tr._generator_states())
        if calls is not None:
            calls[mark:] = [(e, *c) for c in calls[mark:]]
    return tr


@pytest.fixture(scope="module")
def final_runs():
    """The four runs, and each deferred run's gated calls: (epoch, tail?,
    first step, live count)."""
    ds = DeviceDataset(build_mixture(_final_cfg(True).data, max_synth=64), "cpu")
    calls = {True: [], False: []}
    into = []
    call = ST.GatedChunkedStep.__call__

    def watched(self, idx, z, lr_g, lr_d, c0, bound, **kw):
        into[-1].append((self.tail, c0, int(bound)))
        return call(self, idx, z, lr_g, lr_d, c0, bound, **kw)

    ST.GatedChunkedStep.__call__ = watched
    out = {}
    try:
        for c in (True, False):
            into.append(calls[c])
            out[True, c] = _run(_final_cfg(True), ds, c, calls[c])
    finally:
        ST.GatedChunkedStep.__call__ = call
    out[False] = _run(_final_cfg(False), ds, True)
    return out, calls


def _assert_same_run(a, b, histories=True):
    for name in ("gen", "disc"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa), name
    for name in ("opt_g", "opt_d"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i in sa["state"]:
            for k in sa["state"][i]:
                assert torch.equal(sa["state"][i][k], sb["state"][i][k]), f"{name} {i} {k}"
    keys = ("steps", "active", "lr_g", "lr_d", "filtered_contam", "total_contam")
    assert [[r[k] for k in keys] for r in a.epoch_results] == \
        [[r[k] for k in keys] for r in b.epoch_results]
    for ra, rb in zip(a.epoch_results, b.epoch_results):
        assert ra["last"].keys() == rb["last"].keys()
        assert all(torch.equal(ra["last"][k], rb["last"][k]) for k in ra["last"])
    assert a.logger.stream.getvalue() == b.logger.stream.getvalue()
    assert len(a.logger.step_times) == len(b.logger.step_times)
    assert a.strain_quality == b.strain_quality
    if histories:
        assert a.logger.G_losses == b.logger.G_losses
        assert a.logger.D_losses == b.logger.D_losses
        for x, y in ((a.epoch_loss_history, b.epoch_loss_history),
                     (a.mask_history, b.mask_history)):
            assert len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize("collect", [True, False], ids=["collect", "no_history"])
def test_deferred_trainer_bit_equal_to_blocking(final_runs, collect):
    runs, calls = final_runs
    d, b = runs[True, collect], runs[False]
    _assert_same_run(d, b, histories=collect)
    steps = [r["steps"] for r in d.epoch_results]
    active = [r["active"] for r in d.epoch_results]
    assert all(a % 4 for a in active[1:]), "every strained epoch ends in a partial tail"
    assert steps[2] < min(steps[1], steps[3]) - 1
    # epochs 0 and 1 (a new capture key: d_train off from the first strain)
    # block and warm up; 2 and 3 are deferred
    assert d.graph_stats["deferred_epochs"] == 2 and d.graph_stats["blocking_epochs"] == 2
    assert b.graph_stats["deferred_epochs"] == 0 and b.graph_stats["blocking_epochs"] == EPOCHS
    mine = calls[collect]
    chunks = {e: [(c0, n) for e2, tail, c0, n in mine if e2 == e and not tail] for e in (2, 3)}
    full = {e: active[e] // 4 for e in (2, 3)}
    # epoch 2 overshoots: its guess (epoch 1's count) dispatches wholly dead
    # chunks; epoch 3 catches up past its guess (epoch 2's count)
    assert any(c0 >= n for c0, n in chunks[2]) and all(n == full[2] for _, n in chunks[2])
    assert len(chunks[3]) > -(-full[2] // 4) and len(chunks[3]) * 4 >= full[3]
    tails = [(e, n) for e, tail, _, n in mine if tail]
    assert [n for e, n in tails if e in (2, 3)] == [active[2] % 4, active[3] % 4]
    if collect:
        assert len(d.mask_history) == EPOCHS and len(d.epoch_loss_history) == EPOCHS
        assert [len(h) for h in d.epoch_loss_history] == active
    else:
        assert d.mask_history == d.epoch_loss_history == [] and d.logger.G_losses == []
        assert d.img_list == []


def test_draws_independent_of_the_path(final_runs):
    """Every generator's state after each epoch is the same whichever path
    the epoch took: epoch e + 1 draws the same either way."""
    runs, _ = final_runs
    for collect in (True, False):
        d, b = runs[True, collect], runs[False]
        for sd, sb in zip(d.gen_states, b.gen_states):
            assert all(torch.equal(x, y) for x, y in zip(sd, sb))


def test_draws_independent_of_the_path_with_a_pool():
    """``fake_concat`` (its pool rows from a second generator), tiny,
    deferred against blocking from epoch 2 on."""
    def cfg(defer):
        c = _tiny(get_preset("fake_concat"), epochs=3, log_every=0, sample_every=0,
                  steps_per_dispatch=2, defer_epoch_stats=defer)
        return c.replace(strain=dataclasses.replace(c.strain, start_epoch=1, score_batch=16,
                                                    fake_concat_start_epoch=1))

    ds = DeviceDataset(build_mixture(cfg(True).data, max_synth=48), "cpu")
    d, b = (_run(cfg(defer), ds, collect=False) for defer in (True, False))
    assert d.graph_stats["deferred_epochs"] >= 1
    _assert_same_run(d, b)
    for sd, sb in zip(d.gen_states, b.gen_states):
        assert all(torch.equal(x, y) for x, y in zip(sd, sb))


def test_no_history_logger_and_trainer_logger():
    """``MetricsLogger(collect=False)`` keeps no loss series, and a Trainer
    given it keeps no histories and draws no grids, even with
    ``sample_every`` set (`strainer_gan_tpu/train/loop.py:365`)."""
    cfg = _tiny(get_preset("basic"), epochs=1, log_every=1, sample_every=2,
                steps_per_dispatch=1)
    stream = io.StringIO()
    log = MetricsLogger(log_every=1, stream=stream, collect=False)
    tr = Trainer(cfg, device="cpu", max_synth=24, logger=log)
    assert tr.logger is log
    out = tr.run()
    assert out[0]["steps"] == 3 and len(log.step_times) == 3
    assert log.G_losses == [] and log.summary()["last_G_loss"] is None
    assert tr.mask_history == tr.epoch_loss_history == tr.img_list == []
    assert stream.getvalue().count("Loss_D") == 3
    jlog = JLogger(log_every=1, stream=io.StringIO(), collect=False)
    assert jlog.collect is log.collect is False
