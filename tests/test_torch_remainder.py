"""The blocking path's remainders and partial tails as launches of the
capture key's gated executors (``train/loop.py``, ``steps.GatedChunkedStep``),
on the CPU, where the gated steps run eagerly over the same static buffers
the card's graphs use.

Each case runs at ``steps_per_dispatch=4`` with ``sample_every`` cutting
its epochs into segments (every 5 steps, 9 in ``final``), so that
remainders of one step and of three (a chunk less one) and partial tails
occur; at ``steps_per_dispatch=1``; and at 4 again on a sample-sharded
copy of its dataset, which keeps the remainders and tails step by step.
Cases: ``batch_mask`` (epochs 0-1 unmasked, 2-3 masked: a second capture
key), a tiny ``final`` across its strains from epoch 3 (the LR cut and
``d_train`` off), ``mnist8`` with D dropout (keep masks from ``drop_rng``)
and ``fake_concat`` (pool rows from ``pool_rng``, the pool's gate at
epoch 1).

* The gated run equals the per-step run bit for bit: parameters, BatchNorm
  buffers, Adam state, the console text, the loss series, the per-sample
  loss and mask histories, the grids, the epochs' results and the parity
  report's last batch; and the three generators stand where the per-step
  run leaves them after every epoch.
* The sharded copy is bit-equal too, and its eager remainder and tail
  counts are what the gated run counts as gated (``gated.remainder``,
  ``gated.tail``) plus what it still runs eagerly: only before a key's
  warm-up, so ``eager.remainder`` and ``eager.tail`` read 0 in every epoch
  that starts with its key warmed up.
* A key that never has its warm-up (every segment short of a chunk) keeps
  the eager remainder and tail.
* The gated chunk takes its bound as a host int (filled, as ``c0`` is) or
  as a device tensor (copied), with the same result.
"""
import dataclasses
import io

import numpy as np
import pytest
import torch

from strainer_gan_tpu_torch import get_preset
from strainer_gan_tpu_torch.data import DeviceDataset, build_mixture
from strainer_gan_tpu_torch.parity.agreement import agreement_report
from strainer_gan_tpu_torch.train import steps as ST
from strainer_gan_tpu_torch.train.loop import Trainer

WIDTH = 8
CHUNK = 4
PRESETS = {"batch_mask": "batch_mask", "final": "final", "mnist8_dropout": "mnist8",
           "fake_concat_pool": "fake_concat"}
CASES = list(PRESETS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(case, spd):
    """``case`` at ``steps_per_dispatch`` ``spd``, tiny, with grids every 5
    global steps and a partial tail; and the images to synthesise."""
    cfg = get_preset(PRESETS[case])
    train = dict(log_every=3, sample_every=5, steps_per_dispatch=spd)
    data = dict(drop_last=False)
    model = dict(compute_dtype="float32")
    strain = {}
    if case == "batch_mask":
        train.update(epochs=4)
        data.update(batch_size=8)
        strain.update(mask_start_epoch=2)
        max_synth = 72  # 79 images: ten steps an epoch, a 7-lane tail
    elif case == "final":
        # grids every 9: the strained epochs 3 and 4 (six steps) still warm
        # their new key up (d_train off) and run a gated tail
        train.update(epochs=5, log_every=4, sample_every=9)
        data.update(batch_size=4)
        max_synth = 64
    elif case == "mnist8_dropout":
        train.update(epochs=3)
        model.update(d_dropout=0.3)
        max_synth = 1500  # 162 digits at batch 16: 11 steps, a 2-lane tail
    else:
        train.update(epochs=3)
        data.update(batch_size=8)
        strain.update(start_epoch=1, score_batch=16, fake_concat_start_epoch=1)
        max_synth = 48
    if cfg.model.arch != "mlp":
        model.update(ngf=WIDTH, ndf=WIDTH)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data),
                      model=dataclasses.replace(cfg.model, **model),
                      train=dataclasses.replace(cfg.train, **train),
                      strain=dataclasses.replace(cfg.strain, **strain))
    return cfg, max_synth


def _run(cfg, dataset, calls=None):
    """Run every epoch of ``cfg``, keeping the generators' states after
    each and, into ``calls``, each gated launch's (epoch, tail?, first
    step, bound)."""
    tr = Trainer(cfg, device="cpu", dataset=dataset)
    tr.logger.stream = io.StringIO()
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
def runs():
    """Each case's gated, per-step and sharded runs, and the gated run's
    launches."""
    out = {}
    call = ST.GatedChunkedStep.__call__
    into = []

    def watched(self, idx, z, lr_g, lr_d, c0, bound, **kw):
        if into:
            into[-1].append((self.tail, c0, int(bound)))
        return call(self, idx, z, lr_g, lr_d, c0, bound, **kw)

    ST.GatedChunkedStep.__call__ = watched
    try:
        for case in CASES:
            cfg, max_synth = _cfg(case, CHUNK)
            mixture = build_mixture(cfg.data, max_synth=max_synth)
            ds = DeviceDataset(mixture, "cpu")
            calls = []
            into.append(calls)
            gated = _run(cfg, ds, calls)
            into.pop()
            per_step = _run(_cfg(case, 1)[0], ds)
            shard = DeviceDataset.from_rank_local(mixture, len(mixture), "cpu", rank=0)
            sharded = _run(cfg, shard)
            out[case] = dict(gated=gated, per_step=per_step, sharded=sharded, calls=calls)
    finally:
        ST.GatedChunkedStep.__call__ = call
    return out


def _assert_same_run(a, b):
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
    assert a.logger.stream.getvalue() == b.logger.stream.getvalue()
    assert a.logger.G_losses == b.logger.G_losses and a.logger.D_losses == b.logger.D_losses
    assert len(a.logger.step_times) == len(b.logger.step_times)
    for x, y in ((a.epoch_loss_history, b.epoch_loss_history),
                 (a.mask_history, b.mask_history), (a.img_list, b.img_list)):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    keys = ("steps", "active", "lr_g", "lr_d", "filtered_contam", "total_contam")
    assert [[r[k] for k in keys] for r in a.epoch_results] == \
        [[r[k] for k in keys] for r in b.epoch_results]
    for ra, rb in zip(a.epoch_results, b.epoch_results):
        assert ra["last"].keys() == rb["last"].keys()
        for k in ra["last"]:
            assert torch.equal(ra["last"][k], rb["last"][k]), k
    assert a.engine.last_batch_valid == b.engine.last_batch_valid
    assert agreement_report(a) == agreement_report(b)
    assert len(a.gen_states) == len(b.gen_states)
    for sa, sb in zip(a.gen_states, b.gen_states):
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))


@pytest.mark.parametrize("case", CASES)
def test_gated_remainder_equals_per_step(runs, case):
    r = runs[case]
    _assert_same_run(r["gated"], r["per_step"])
    assert r["gated"]._gated and r["gated"]._gated_tails  # it launched both
    assert not r["per_step"]._gated and not r["per_step"]._executors


@pytest.mark.parametrize("case", CASES)
def test_sharded_copy_keeps_the_eager_remainder(runs, case):
    r = runs[case]
    gated, sharded = r["gated"], r["sharded"]
    _assert_same_run(gated, sharded)
    assert sharded.dataset.sharded and not sharded._gated and not sharded._gated_tails
    warmed = set()
    for e, (g, s) in enumerate(zip(gated.epoch_results, sharded.epoch_results)):
        gc, sc = g["counts"], s["counts"]
        assert sc.get("gated.remainder", 0) == sc.get("gated.tail", 0) == 0
        assert sc.get("eager.remainder", 0) == \
            gc.get("eager.remainder", 0) + gc.get("gated.remainder", 0)
        assert sc.get("eager.tail", 0) == gc.get("eager.tail", 0) + gc.get("gated.tail", 0)
        assert gc.get("eager.tail", 0) + gc.get("gated.tail", 0) == \
            (1 if g["active"] % gated.cfg.data.batch_size else 0)
        eager = sum(v for k, v in gc.items() if k.startswith("eager."))
        if gc.get("eager.warmup", 0) == 0 and g["steps"] > eager:
            # the epoch's key had its warm-up in an earlier epoch
            assert gc.get("eager.remainder", 0) == gc.get("eager.tail", 0) == 0, e
            warmed.add(e)
    assert warmed and min(warmed) > 0


def test_remainders_of_one_step_and_of_a_chunk_less_one(runs):
    """Across the cases, gated remainders of 1 and of 3 live steps and gated
    tails ran; each remainder's bound is its first step plus its length,
    short of a chunk; a tail's bound is its lane count."""
    lengths, tails = set(), 0
    for case in CASES:
        r = runs[case]
        bs = r["gated"].cfg.data.batch_size
        for e, tail, c0, bound in r["calls"]:
            if tail:
                assert c0 == 0 and bound == r["gated"].epoch_results[e]["active"] % bs > 0
                tails += 1
            else:
                assert 0 < bound - c0 < CHUNK
                lengths.add(bound - c0)
        counts = [res["counts"] for res in r["gated"].epoch_results]
        assert sum(c.get("gated.remainder", 0) for c in counts) == sum(
            bound - c0 for _, tail, c0, bound in r["calls"] if not tail)
    assert {1, CHUNK - 1} <= lengths and tails >= 4


def test_key_without_a_warm_up_keeps_the_eager_remainder():
    """Chunks of 32 over ten-step epochs: no segment holds a full chunk, so
    no key has its warm-up and every step runs eagerly."""
    cfg, max_synth = _cfg("batch_mask", 32)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epochs=1))
    tr = _run(cfg, DeviceDataset(build_mixture(cfg.data, max_synth=max_synth), "cpu"))
    c = tr.epoch_results[0]["counts"]
    assert (c.get("eager.remainder", 0), c.get("eager.tail", 0)) == (9, 1)
    assert not any(k.startswith("gated.") for k in c) and c.get("eager.warmup", 0) == 0
    assert not tr._executors and not tr._gated and not tr._gated_tails


def test_bound_as_host_int_or_device_tensor(runs):
    """The gated chunk fills a host-int bound as it fills ``c0``, and copies
    a tensor one: the same live steps, to the bit, either way."""
    tr = runs["batch_mask"]["gated"]
    ex = next(iter(tr._gated.values()))
    tensors = [*tr.gen.state_dict().values(), *tr.disc.state_dict().values()] + [
        t for opt in (tr.opt_g, tr.opt_d) for st in opt.state.values() for t in st.values()
        if torch.is_tensor(t)]
    before = [t.clone() for t in tensors]
    gen = torch.Generator().manual_seed(5)
    idx = torch.randint(0, tr.dataset.n, (CHUNK, 8), generator=gen)
    z = torch.randn((CHUNK, 8, 100), generator=gen)
    outs, afters = [], []
    try:
        for bound in (3, torch.tensor(3)):
            with torch.no_grad():
                for t, b in zip(tensors, before):
                    t.copy_(b)
            m = ex(idx, z, 2e-4, 2e-4, 1, bound)
            assert (int(ex.c0), int(ex.bound)) == (1, 3)
            outs.append(m["errD"][:2])
            afters.append([t.clone() for t in tensors])
    finally:
        with torch.no_grad():
            for t, b in zip(tensors, before):
                t.copy_(b)
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(x, y) for x, y in zip(*afters))
    assert not all(torch.equal(x, y) for x, y in zip(afters[0], before))  # two steps ran
