"""The readers of the program's own spans and counters (``core/program.py``
and the metrics that use it) on synthetic traces, span logs and epoch
results, and the trace's reductions unchanged by the program's spans."""
import types

import pytest

from portbench.core import spec
from portbench.core.trace import Event, Trace
from strainer_gan_tpu_torch.obs import profiler

NEW = ("eager_steps.train", "eager_ms.train", "chunk_gap_ms.train", "host_reads.train",
       "strain_wait_ms.final")


def _host(name, start, end, corr=0):
    return Event(name, False, start, end, corr)


def _device(name, start, end, corr=0):
    return Event(name, True, start, end, corr)


def _base():
    """A unit of the benchmark's: its outer span, a strain span of its own,
    three kernels launched by the runtime, and a gap before the last."""
    return [
        _host("portbench.unit", 0, 2000),
        _host("portbench.strain", 40, 460),
        _host("cudaLaunchKernel", 90, 95, corr=1),
        _host("cudaLaunchKernel", 290, 295, corr=2),
        _host("cudaGraphLaunch", 480, 485, corr=3),
        _device("bce_scores_kernel", 100, 200, corr=1),
        _device("void at::native::elementwise_kernel", 300, 400, corr=2),
        _device("sm90_xmma_fprop_implicit_gemm", 500, 900, corr=3),
    ]


# the program's spans of that unit, each with the annotation its range
# leaves on the device side
PROGRAM = [
    ("strainer.epoch", 50, 1000),
    ("strainer.epoch.strain", 60, 450),
    ("strainer.strain.bulk", 100, 210),
    ("strainer.strain.band", 220, 440),
    ("strainer.host_read.band", 230, 290),
    ("strainer.step.chunk", 460, 950),
    ("strainer.step.eager", 960, 990),
]


def _with_program():
    events = _base()
    for name, lo, hi in PROGRAM:
        events.append(_host(name, lo, hi))
        events.append(_device(name, lo + 5, hi - 5))
    return events


@pytest.fixture
def logged(monkeypatch):
    """The program's span log holds the unit's spans, one span of an
    earlier session and one of a later, both outside the trace's window."""
    log = [("strainer.step.eager", -300, -100)] + PROGRAM + [("strainer.step.eager", 2100, 2200)]
    monkeypatch.setattr(profiler, "recorded_spans", lambda: list(log))


def test_program_spans_change_no_reduction():
    plain, traced = Trace(_base()), Trace(_with_program())
    assert len(traced.device) == len(plain.device) == 3
    for t in (plain, traced):
        assert t.busy_iv == [(100, 200), (300, 400), (500, 900)]
    assert plain.busy_s == traced.busy_s
    assert plain.window_s == traced.window_s
    assert plain.top_ops() == traced.top_ops()
    assert plain.idle_gaps() == traced.idle_gaps()
    assert plain.span_device_seconds("strain") == traced.span_device_seconds("strain")
    for names in (["bce_scores_kernel"], ["elementwise_kernel", "implicit_gemm"]):
        assert plain.kernel_seconds(names) == traced.kernel_seconds(names)


def _run(trace, kind="epoch", counts=None, units=2):
    results = [{"steps": 10}] * 3 if counts is None else [{"steps": 10}] + [
        {"steps": 10, "counts": c} for c in counts]
    return types.SimpleNamespace(kind=kind, trace=trace, window={"units": [{}] * units},
                                 trainer=types.SimpleNamespace(epoch_results=results))


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_span_readers_by_hand(logged):
    run = _run(Trace(_with_program()))
    # one eager step of 30 ns
    assert _read("eager_ms.train", run) == pytest.approx(30e-6)
    # the chunk 460-950: busy 500-900, idle 90 ns
    assert _read("chunk_gap_ms.train", run) == pytest.approx(90e-6)
    # the strain event 60-450: busy 100-200 and 300-400, idle 190 ns
    assert _read("strain_wait_ms.final", run) == pytest.approx(190e-6)


@pytest.mark.parametrize("units", [2, 3])
def test_counter_readers_by_hand(units):
    # the window's epochs, after the set-up epoch: the first (the traced
    # one) is read, however many follow it
    counts = [{"eager.warmup": 1, "eager.remainder": 30, "eager.tail": 1,
               "host_read.log": 7, "host_read.stats": 1, "host_read.grid": 1}] + [
              {"eager.remainder": 61, "eager.tail": 1, "host_read.log": 6,
               "host_read.band": 1, "host_read.grid": 2}] * (units - 1)
    run = _run(None, counts=counts, units=units)
    assert _read("eager_steps.train", run) == 32
    assert _read("host_reads.train", run) == 9


def test_nothing_to_read_gives_none(monkeypatch):
    # the parent program: no span log, no counts in its results
    monkeypatch.delattr(profiler, "recorded_spans")
    run = _run(Trace(_base()))
    for name in NEW:
        assert _read(name, run) is None, name
    # a strain span with no strain pass inside is no strain event
    monkeypatch.setattr(profiler, "recorded_spans",
                        lambda: [("strainer.epoch.strain", 60, 450)], raising=False)
    assert _read("strain_wait_ms.final", _run(Trace(_base()))) is None
    # spans logged outside the traced window are none of its spans
    monkeypatch.setattr(profiler, "recorded_spans",
                        lambda: [(n, lo + 5000, hi + 5000) for n, lo, hi in PROGRAM])
    run = _run(Trace(_with_program()))
    for name in ("eager_ms.train", "chunk_gap_ms.train", "strain_wait_ms.final"):
        assert _read(name, run) is None, name


def test_prefilter_cell_reads_none(monkeypatch):
    spans = [("strainer.prefilter.features", 50, 900), ("strainer.prefilter.zscore", 910, 990)]
    monkeypatch.setattr(profiler, "recorded_spans", lambda: list(spans))
    events = _base() + [_host(*s) for s in spans]
    run = _run(Trace(events), kind="prefilter", counts=[{"host_read.base": 1}] * 2)
    for name in NEW:
        assert _read(name, run) is None, name
