"""The program's spans and counters (``obs/profiler.py``: ``span``,
``count``, ``host_read``) on the CPU.

* Under a CPU ``torch.profiler`` a tiny blocking-path ``batch_mask``
  Trainer (chunk 4, ``sample_every`` 6, ``drop_last=False``: 79 images at
  batch 8 make ten steps an epoch with a 7-lane tail) records its spans,
  nested as the loop nests them, and as many ``step.eager`` spans as its
  epochs count eager steps, ``step.remainder`` spans as it launches gated
  remainders and tails, ``step.chunk`` spans as its other steps make
  chunks, and ``epoch.grid`` spans as it counts grid reads.
* The eager and gated steps by reason follow the segment arithmetic,
  worked by hand below, over two epochs whose global step offsets (0 and
  10) fall differently against the sample points.
* With no profiler recording, ``span`` enters no ``record_function``; once
  a session has ended the gate reads false again.
* Every read of a device value that the port's own code makes during an
  epoch (``batch_mask`` gated; ``final`` across its band-path strain)
  lies inside a ``host_read`` span, each such span holds a read, and the
  epoch's ``host_read`` counts equal them: an added read fails here.
"""
import dataclasses
import io
import sys
import time
from collections import Counter, defaultdict

import pytest
import torch
import torch.profiler as tp
from torch.overrides import TorchFunctionMode

from strainer_gan_tpu_torch import get_preset
from strainer_gan_tpu_torch.obs import profiler
from strainer_gan_tpu_torch.train import steps as ST
from strainer_gan_tpu_torch.train.loop import Trainer

WIDTH, B = 8, 8
EAGER = ("eager.warmup", "eager.remainder", "eager.tail", "eager.per_step")
GATED = ("gated.remainder", "gated.tail")
SLACK_NS = 1000


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(preset, batch=B, **train):
    cfg = get_preset(preset)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=batch, drop_last=False),
        model=dataclasses.replace(cfg.model, ngf=WIDTH, ndf=WIDTH, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **train))


def _trainer(cfg, max_synth):
    tr = Trainer(cfg, device="cpu", max_synth=max_synth)
    tr.logger.stream = io.StringIO()
    tr.setup()
    return tr


def _batch_mask(mask_start_epoch=10):
    cfg = _tiny("batch_mask", epochs=2, log_every=3, sample_every=6, steps_per_dispatch=4)
    return cfg.replace(strain=dataclasses.replace(cfg.strain,
                                                  mask_start_epoch=mask_start_epoch))


@pytest.fixture(scope="module")
def traced():
    """Two ungated epochs under a CPU profiler: the trainer, the
    program's spans as (name, start, end), in start order, and each
    epoch's launches of a gated executor."""
    tr = _trainer(_batch_mask(), max_synth=72)
    assert tr.dataset.n == 79
    launches = []
    call = ST.GatedChunkedStep.__call__

    def counted(*a, **kw):
        launches[-1] += 1
        return call(*a, **kw)

    ST.GatedChunkedStep.__call__ = counted
    try:
        with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
            for e in range(2):
                launches.append(0)
                tr.run_epoch(e)
    finally:
        ST.GatedChunkedStep.__call__ = call
    spans = sorted(((e.name[len(profiler.SPAN_PREFIX):], e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith(profiler.SPAN_PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    return tr, spans, launches


def _parents(spans):
    """The innermost span around each span (None at the top)."""
    out, stack = [], []
    for s in spans:
        while stack and stack[-1][2] < s[2]:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
        stack.append(s)
    return out


def test_spans_nest_as_the_loop_does(traced):
    tr, spans, _ = traced
    parents = dict(Counter(zip((s[0] for s in spans), _parents(spans))))
    assert parents == {
        ("epoch", None): 2,
        # the first epoch's stats fetch (nothing was fetched before it)
        ("epoch.strain", "epoch"): 2, ("epoch.stats", "epoch"): 1,
        ("host_read.stats", "epoch.stats"): 1,
        ("host_read.mask", "epoch"): 2,
        ("step.eager", "epoch"): 2, ("step.chunk", "epoch"): 2,
        ("step.remainder", "epoch"): 6,
        # log_every 3: steps 0, 3, 6, 9 of each epoch print, one fetch for
        # the prints of a chunk or a gated launch (epoch 0: 0 eager, 3 in a
        # chunk, 6 and 9 gated; epoch 1: 0 gated, 3 and 6 in a chunk, 9
        # gated)
        ("host_read.log", "step.eager"): 1, ("host_read.log", "step.chunk"): 2,
        ("host_read.log", "step.remainder"): 4,
        ("epoch.grid", "epoch"): 4, ("host_read.grid", "epoch.grid"): 5,
        ("epoch.close", "epoch"): 2, ("epoch.grid", "epoch.close"): 1,
        ("host_read.history", "epoch.close"): 2,
    }


def test_step_spans_equal_the_epoch_counts(traced):
    tr, spans, launches = traced
    epochs = [s for s in spans if s[0] == "epoch"]
    for (_, lo, hi), result, n_gated in zip(epochs, tr.epoch_results, launches):
        inside = Counter(s[0] for s in spans if lo < s[1] and s[2] <= hi)
        c = result["counts"]
        eager = sum(c.get(k, 0) for k in EAGER)
        assert inside["step.eager"] == eager
        assert inside["step.chunk"] * 4 + sum(c.get(k, 0) for k in GATED) \
            == result["steps"] - eager
        assert inside["step.remainder"] == n_gated > 0
        assert inside["epoch.grid"] == c["host_read.grid"]
        assert sum(v for k, v in inside.items() if k.startswith("host_read.")) == sum(
            v for k, v in c.items() if k.startswith("host_read."))


def test_eager_counts_follow_the_segments(traced):
    """Ten steps, the last a 7-lane tail, sample points every 6 global
    steps, chunks of 4.  Epoch 0 (global steps 0-9): segments [0, 1)
    (step 0 eager: the key has had no warm-up yet), [1, 7) (the key's
    warm-up step 1, a chunk 2-5, step 6 gated) and [7, 10) (steps 7-8
    gated, the tail 9 gated); grids after global steps 0 and 6.  Epoch 1
    (global 10-19): [0, 3) (three gated: a segment short of a chunk), [3, 9)
    (a chunk 3-6, steps 7-8 gated) and the gated tail; grids after global
    12 and 18, and one after the last epoch."""
    tr, _, launches = traced
    first, second = (r["counts"] for r in tr.epoch_results)
    pick = EAGER + GATED + ("host_read.grid",)
    assert {k: first.get(k, 0) for k in pick} == dict(zip(pick, (1, 1, 0, 0, 3, 1, 2)))
    assert {k: second.get(k, 0) for k in pick} == dict(zip(pick, (0, 0, 0, 0, 5, 1, 3)))
    assert [r["steps"] for r in tr.epoch_results] == [10, 10]
    assert launches == [3, 3]


def test_per_step_counts_every_step_as_per_step():
    cfg = _batch_mask().replace(train=dataclasses.replace(
        _batch_mask().train, steps_per_dispatch=1, epochs=1))
    tr = _trainer(cfg, max_synth=72)
    c = tr.run_epoch(0)["counts"]
    assert {k: c.get(k, 0) for k in EAGER} == {
        "eager.warmup": 0, "eager.remainder": 0, "eager.tail": 0, "eager.per_step": 10}


def test_no_span_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span entered record_function with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiler.span("epoch"), profiler.host_read("stats"):
        pass
    cfg = _batch_mask().replace(train=dataclasses.replace(_batch_mask().train, epochs=1))
    tr = _trainer(cfg, max_synth=72)
    c = tr.run_epoch(0)["counts"]
    assert tuple(c.get(k, 0) for k in EAGER[:3] + GATED) == (1, 1, 0, 3, 1)


def test_gate_reads_false_after_a_session(tmp_path):
    assert profiler.span("epoch") is profiler.span("step.chunk")  # the shared null context
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        inside = profiler.span("epoch")
        assert isinstance(inside.range, torch.profiler.record_function)
    assert profiler.span("epoch") is profiler.span("step.chunk")
    with profiler.trace(str(tmp_path)):
        assert isinstance(profiler.span("epoch").range, torch.profiler.record_function)
    assert profiler.span("epoch") is profiler.span("step.chunk")


def test_span_log_matches_the_profilers_ranges():
    """Each span the profiler records is logged once, by name, inside its
    range on the profiler's clock (which converts an approximate clock to
    Unix time: a microsecond's slack)."""
    tr = _trainer(_batch_mask(), max_synth=72)
    t0 = time.time_ns()
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        tr.run_epoch(0)
    t1 = time.time_ns()
    logged = sorted(s for s in profiler.recorded_spans() if t0 <= s[1] and s[2] <= t1)
    recorded = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in prof.profiler.kineto_results.events()
                      if e.name().startswith(profiler.SPAN_PREFIX))
    assert len(recorded) > 20
    assert [s[0] for s in logged] == [s[0] for s in recorded]
    for (name, lo, hi), (_, r_lo, r_hi) in zip(logged, recorded):
        assert r_lo - SLACK_NS <= lo <= hi <= r_hi + SLACK_NS, name


def test_counts_since_keeps_only_what_moved():
    before = profiler.counts()
    profiler.count("eager.tail", 2)
    profiler.count("eager.warmup", 0)
    assert profiler.counts_since(before) == {"eager.tail": 2}


# what reads a device value on the host (on the card each blocks on it)
READS = {"tolist", "item", "cpu", "numpy", "nonzero", "__bool__", "__int__", "__float__",
         "__index__"}
PORT = "strainer_gan_tpu_torch"


class _Reads(TorchFunctionMode):
    """Each read the port's own code makes, with the ``host_read`` span it
    was made in (None outside any): ``host_read`` is tracked by patching
    ``profiler.span``, which it calls."""

    def __init__(self, monkeypatch):
        super().__init__()
        self.open, self.seen, self.entered = [], [], []
        real = profiler.span

        class Tracked:
            def __init__(s, name):
                s.name = name

            def __enter__(s):
                if s.name.startswith("host_read."):
                    self.entered.append(s.name)
                    self.open.append(len(self.entered) - 1)
                s.inner = real(s.name)
                return s.inner.__enter__()

            def __exit__(s, *exc):
                if s.name.startswith("host_read."):
                    self.open.pop()
                return s.inner.__exit__(*exc)

        monkeypatch.setattr(profiler, "span", Tracked)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        caller = sys._getframe(1).f_code.co_filename
        if name in READS and PORT in caller:
            self.seen.append((name, caller, self.open[-1] if self.open else None))
        return func(*args, **(kwargs or {}))


def _final(epochs=4):
    # batch 4 and 4 epochs: epoch 3 runs the band-path strain on what the
    # prefilter kept
    return _tiny("final", batch=4, epochs=epochs, log_every=4, sample_every=5,
                 steps_per_dispatch=4, check_finite=True)


@pytest.mark.parametrize("case", ["batch_mask_gated", "final_strain"])
def test_every_host_read_is_counted(case, monkeypatch):
    if case == "batch_mask_gated":
        cfg = _batch_mask(mask_start_epoch=0)
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, check_finite=True))
        tr, epochs = _trainer(cfg, max_synth=72), range(2)
    else:
        tr, epochs = _trainer(_final(), max_synth=48), range(4)
    for e in epochs:
        reads = _Reads(monkeypatch)
        with reads:
            counts = tr.run_epoch(e)["counts"]
        monkeypatch.undo()
        outside = [(n, f) for n, f, at in reads.seen if at is None]
        assert outside == [], f"epoch {e}: reads outside a host_read span: {outside}"
        holding = {at for _, _, at in reads.seen}
        assert holding == set(range(len(reads.entered))), \
            f"epoch {e}: host_read spans without a read"
        by_name = Counter(n[len("host_read."):] for n in reads.entered)
        assert {k[len("host_read."):]: v for k, v in counts.items()
                if k.startswith("host_read.")} == dict(by_name)
    if case == "final_strain":
        strain = tr.epoch_results[3]["counts"]
        assert tr.engine.last_score_path == "band"
        assert {"band", "kept"} <= {k[len("host_read."):] for k in strain}
    else:
        assert all(r["counts"]["host_read.contam"] == 1 for r in tr.epoch_results)


def test_prefilter_spans_and_its_one_read():
    before = profiler.counts()
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        _trainer(_final(epochs=1), max_synth=48)
    assert {k: v for k, v in profiler.counts_since(before).items()
            if k.startswith("host_read.")} == {"host_read.base": 1}
    names = Counter(e.name[len(profiler.SPAN_PREFIX):] for e in prof.events()
                    if e.name.startswith(profiler.SPAN_PREFIX))
    assert names == {"prefilter.features": 1, "prefilter.zscore": 1, "host_read.base": 1}


def test_strain_spans_nest_under_epoch_strain():
    tr = _trainer(_final(), max_synth=48)
    for e in range(3):
        tr.run_epoch(e)
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        tr.run_epoch(3)
    spans = sorted(((e.name[len(profiler.SPAN_PREFIX):], e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith(profiler.SPAN_PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    parents = defaultdict(set)
    for s, p in zip(spans, _parents(spans)):
        parents[s[0]].add(p)
    assert parents["strain.bulk"] == parents["strain.band"] == {"epoch.strain"}
    assert parents["host_read.band"] == parents["host_read.kept"] == {"strain.band"}
    assert parents["epoch.strain"] == {"epoch"}
