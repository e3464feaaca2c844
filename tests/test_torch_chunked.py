"""The chunked executor (``steps_per_dispatch`` steps a call) against the
per-step loop, and against the JAX package's chunked Trainer (CPU).

On the CPU ``train/steps.py::ChunkedStep`` runs the per-step body eagerly
over the same static buffers the card's CUDA graph uses, with the same
segmentation, warm-up step and copy-out; so the port's chunked run must
equal its per-step run exactly, and aliasing faults (a result read after
the next chunk overwrote its buffer) show here.

* ``steps_per_dispatch=4`` against ``=1``, exactly: parameters, BatchNorm
  buffers, Adam state, the loss series, the per-sample loss history,
  contamination counts, the parity report's last batch, the console text,
  the strain masks and the fixed-noise grids.  ``batch_mask`` on the JAX
  test's shape (`tests/test_chunked.py:164-197`: 79 samples at batch 8,
  ten steps an epoch with a 7-lane tail; ``sample_every=5`` cuts the
  epochs into a single step, a warm-up plus a chunk, and a remainder),
  ungated then gated; and a tiny ``final`` across its epoch-3 strain (the
  LR cut and the ``d_train`` flip), with a resume from its epoch-2
  checkpoint equal to the uninterrupted run.
* Against the JAX Trainer at ``steps_per_dispatch=4`` with the JAX draws
  injected (as tests/test_torch_batch_mask.py's Trainer test): the same
  console lines, contamination line, epoch results, and loss histories
  within 2e-2 (that file's bound for ten free-running steps).
* The chunk's results survive the next chunk; restoring a checkpoint or
  loading Adam moments from flax empties the executor cache; the step
  body and the serving batch read nothing back to the host and make no
  tensor from host data (what a CUDA graph capture requires).
"""
import dataclasses
import io
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.data.pipeline import epoch_batch_indices as jax_epoch_indices
from strainer_gan_tpu.obs.metrics import MetricsLogger as JLogger
from strainer_gan_tpu.parity.agreement import agreement_report as jax_report
from strainer_gan_tpu.train.loop import Trainer as JTrainer

from strainer_gan_tpu_torch import bridge, get_preset
from strainer_gan_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from strainer_gan_tpu_torch.data import DeviceDataset, build_mixture
from strainer_gan_tpu_torch.parity.agreement import agreement_report
from strainer_gan_tpu_torch.serve import Sampler
from strainer_gan_tpu_torch.train import steps as ST
from strainer_gan_tpu_torch.train.loop import Trainer

WIDTH, B = 8, 8


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


def _batch_mask_cfg(spd):
    cfg = _tiny(get_preset("batch_mask"), epochs=2, log_every=3, sample_every=5,
                steps_per_dispatch=spd)
    return cfg.replace(strain=dataclasses.replace(cfg.strain, mask_start_epoch=1))


def _final_cfg(spd):
    # batch 4: the 22 samples left after the epoch-3 strain still make a
    # warm-up step, a chunk and a tail with d_train off
    cfg = _tiny(get_preset("final"), epochs=4, log_every=4, steps_per_dispatch=spd)
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=4))


def _run(cfg, dataset, epochs=None, ckpt=None):
    tr = Trainer(cfg, device="cpu", dataset=dataset)
    tr.logger.stream = io.StringIO()
    tr.setup()
    for e in range(epochs or cfg.train.epochs):
        tr.run_epoch(e)
        if ckpt is not None:
            save_checkpoint(ckpt, tr, e)
    return tr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case run at steps_per_dispatch 4 and 1 on one staged dataset."""
    out = {}
    bm = DeviceDataset(build_mixture(_batch_mask_cfg(4).data, max_synth=72), "cpu")
    assert bm.n == 79
    out["batch_mask"] = [_run(_batch_mask_cfg(spd), bm) for spd in (4, 1)]
    fcfg = _final_cfg(4)
    fd = DeviceDataset(build_mixture(fcfg.data, max_synth=64), "cpu")
    ckpt = str(tmp_path_factory.mktemp("final") / "ckpt")
    out["final"] = [_run(fcfg, fd, ckpt=ckpt), _run(_final_cfg(1), fd)]
    out["final_ckpt"] = (ckpt, fd)
    return out


def _assert_same_state(a, b):
    for name in ("gen", "disc"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), f"{name}.{k}"
    for name in ("opt_g", "opt_d"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        assert sa["param_groups"] == sb["param_groups"], name
        for i in sa["state"]:
            for k in sa["state"][i]:
                assert torch.equal(sa["state"][i][k], sb["state"][i][k]), f"{name} {i} {k}"


@pytest.mark.parametrize("case", ["batch_mask", "final"])
def test_chunked_equals_per_step(runs, case):
    a, b = runs[case]
    _assert_same_state(a, b)
    assert a.logger.stream.getvalue() == b.logger.stream.getvalue()
    assert a.logger.G_losses == b.logger.G_losses and a.logger.D_losses == b.logger.D_losses
    assert len(a.logger.step_times) == len(b.logger.step_times) == a.logger.summary()["steps"]
    assert len(a.epoch_loss_history) == len(b.epoch_loss_history)
    for x, y in zip(a.epoch_loss_history, b.epoch_loss_history):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.mask_history, b.mask_history):
        np.testing.assert_array_equal(x, y)
    keys = ("steps", "active", "lr_g", "lr_d", "filtered_contam", "total_contam")
    assert [[r[k] for k in keys] for r in a.epoch_results] == \
        [[r[k] for k in keys] for r in b.epoch_results]
    for ra, rb in zip(a.epoch_results, b.epoch_results):
        assert ra["last"].keys() == rb["last"].keys()
        for k in ra["last"]:
            assert torch.equal(ra["last"][k], rb["last"][k]), k
    assert agreement_report(a) == agreement_report(b)
    # the chunked run really ran chunks (on the CPU: the eager body)
    assert a._executors and not b._executors
    if case == "batch_mask":
        assert a.epoch_results[1]["total_contam"] == 7
        assert {k[1] for k in a._executors} == {False, True}  # mask_on off and on
        assert a.engine.last_batch_valid == b.engine.last_batch_valid == 79 % B
    else:
        assert a.engine.d_bn_eval and a.epoch_results[3]["lr_d"] < a.epoch_results[2]["lr_d"]
        assert {k[2] for k in a._executors} == {True, False}  # d_train before and after
        assert 0 < a.mask_history[3].sum() < a.mask_history[2].sum()


def test_fixed_noise_grids_under_chunking(runs):
    """The same grids at the same iterations (0 and 5 in epoch 0, 10 and 15
    in epoch 1, and the run's last iteration), as tests/test_chunked.py:200
    asks of the JAX package; here bit-equal."""
    a, b = runs["batch_mask"]
    assert len(a.img_list) == len(b.img_list) == 5
    for x, y in zip(a.img_list, b.img_list):
        np.testing.assert_array_equal(x, y)
    assert np.abs(a.img_list[0] - a.img_list[1]).max() > 1e-5


def test_resume_through_the_executor(runs):
    """A fresh Trainer restored from the chunked run's epoch-2 checkpoint
    strains at epoch 3 and trains it through the executor: the same mask
    and state as the uninterrupted run."""
    a = runs["final"][0]
    ckpt, fd = runs["final_ckpt"]
    tr = Trainer(_final_cfg(4), device="cpu", dataset=fd)
    tr.logger.stream = io.StringIO()
    tr.setup()
    assert restore_checkpoint(ckpt, tr, epoch=2) == 3
    tr.run_epoch(3)
    np.testing.assert_array_equal(tr.mask_history[-1], a.mask_history[3])
    np.testing.assert_array_equal(tr.epoch_loss_history[-1], a.epoch_loss_history[3])
    _assert_same_state(tr, a)
    assert tr._executors


def test_chunk_results_survive_the_next_chunk(runs):
    a = runs["batch_mask"][0]
    ex = a._executors[(4, True, True, True, "float32")]
    gen = torch.Generator().manual_seed(3)
    n = a.dataset.n
    idx = [torch.randint(0, n, (4, B), generator=gen) for _ in range(2)]
    z = [torch.randn((4, B, 100), generator=gen) for _ in range(2)]
    first = ex(idx[0], z[0], 2e-4, 2e-4)
    kept = {k: v.clone() for k, v in first.items()}
    second = ex(idx[1], z[1], 2e-4, 2e-4)
    for k in first:
        assert torch.equal(first[k], kept[k]), k  # not overwritten by the second chunk
        assert torch.equal(second[k], ex.out[k]), k
    assert not torch.equal(first["real_loss_per_sample"], second["real_loss_per_sample"])
    assert first["n_contam"].shape == (4,) and first["keep_mask"].dtype == torch.bool


def test_loading_a_state_drops_the_captures(runs, tmp_path):
    ckpt, fd = runs["final_ckpt"]
    tr = Trainer(_final_cfg(4), device="cpu", dataset=fd)
    tr.logger.stream = io.StringIO()
    tr.setup()
    tr.run_epoch(0)
    assert tr._executors
    restore_checkpoint(ckpt, tr, epoch=1)
    assert not tr._executors
    tr.run_epoch(2)
    assert tr._executors
    mu, nu = bridge.adam_moments_to_flax(tr.gen, tr.opt_g)
    bridge.load_adam_from_flax(tr.gen, tr.opt_g, mu, nu, count=7)
    assert not tr._executors
    assert all(float(st["step"]) == 7.0 for st in tr.opt_g.state.values())


# ops that a CUDA graph capture cannot hold: a read of a device value on the
# host, or a tensor made from host data (a copy from pageable host memory)
HOST_OPS = ("aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero", "aten.is_nonzero",
            "aten.item")


class _HostOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(HOST_OPS):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mask_on", [False, True], ids=["unmasked", "masked"])
def test_step_body_is_capturable(mask_on, monkeypatch):
    """Everything but the optimizer's own step (torch's capturable Adam on
    the card; the CPU Adam reads its step count on the host)."""
    cfg = _batch_mask_cfg(4)
    tr = Trainer(cfg, device="cpu", max_synth=8)
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    ids = torch.arange(B)
    x = ST.normalize_u8(tr.dataset.gather(ids))
    with _HostOps() as mode:
        ST.step_body(tr.gen, tr.disc, tr.opt_g, tr.opt_d, x, tr.dataset.source_id[ids],
                     torch.randn((B, 100)), tr.scfg, mask_on=mask_on)
    assert mode.seen == []


def test_sample_batch_is_capturable():
    cfg = _tiny(get_preset("basic"))
    gen = Trainer(cfg, device="cpu", max_synth=8).gen
    s = Sampler(cfg, gen.state_dict(), batch_size=4, device="cpu")
    with _HostOps() as mode:
        s._sample_batch(torch.randn((4, 100)))
    assert mode.seen == []


MAX_SYNTH = 60  # 60 CelebA-like + 6 CIFAR-like images: 8 full batches and a tail of 2


def test_chunked_trainer_matches_jax(capsys):
    """Both packages at steps_per_dispatch=4 (the blocking path on both
    sides), one gated epoch of nine steps (JAX: two chunks and the tail;
    the port: its warm-up step, a chunk, three steps and the tail), from
    the same weights and draws.  The ungated step is held to JAX's in
    tests/test_torch_batch_mask.py."""
    def tiny(cfg):
        cfg = _tiny(cfg, epochs=1, log_every=4, steps_per_dispatch=4,
                    defer_epoch_stats=False)
        return cfg.replace(strain=dataclasses.replace(cfg.strain, mask_start_epoch=0))

    jcfg, pcfg = tiny(jax_preset("batch_mask")), tiny(get_preset("batch_mask"))
    jstream = io.StringIO()
    jtr = JTrainer(jcfg, max_synth=MAX_SYNTH, logger=JLogger(log_every=4, stream=jstream))
    tr = Trainer(pcfg, device="cpu", max_synth=MAX_SYNTH)
    n = tr.dataset.n
    assert n == jtr.dataset.n == 66 and n % B
    for mod, params, stats in ((tr.gen, jtr.state.g_params, jtr.state.g_stats),
                               (tr.disc, jtr.state.d_params, jtr.state.d_stats)):
        bridge.load_dcgan_from_flax(mod, jax.tree_util.tree_map(np.asarray, params),
                                    jax.tree_util.tree_map(np.asarray, stats))
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
    assert tr._executors  # the port ran chunks
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if ln.startswith(("[", "Epoch"))]
    jlines = [ln for ln in jstream.getvalue().splitlines() if ln.startswith(("[", "Epoch"))]
    # the same lines at the same steps; the first step's values to the
    # printed digits, later ones within 2e-2 (free-running chains)
    assert [ln.split("\t")[0] for ln in lines] == [ln.split("\t")[0] for ln in jlines]
    assert lines[0] == jlines[0]
    assert [ln for ln in lines if "Filtered" in ln] == [ln for ln in jlines if "Filtered" in ln]
    num = re.compile(r"-?\d+\.\d+")
    for ln, jln in zip(lines, jlines):
        np.testing.assert_allclose([float(v) for v in num.findall(ln)],
                                   [float(v) for v in num.findall(jln)], atol=2e-2)
    for o, jo in zip(out, jout):
        assert (o["steps"], o["active"], o["filtered_contam"], o["total_contam"]) == \
            (jo["steps"], jo["active"], jo["filtered_contam"], jo["total_contam"])
    assert out[0]["total_contam"] == 6
    assert len(tr.epoch_loss_history) == len(jtr.epoch_loss_history) == 1
    for h, jh in zip(tr.epoch_loss_history, jtr.epoch_loss_history):
        np.testing.assert_allclose(h, np.asarray(jh), atol=2e-2)
    eng, jeng = tr.engine, jtr.engine
    assert eng.last_batch_valid == jeng.last_batch_valid == n % B
    np.testing.assert_array_equal(eng.last_batch_mask.numpy(), np.asarray(jeng.last_batch_mask))
    report, jrep = agreement_report(tr), jax_report(jtr)
    assert report["agreement"] == jrep["agreement"] == 1.0
    assert report == jrep
