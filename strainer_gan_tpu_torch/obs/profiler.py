"""Profiling, spans and counters (counterpart of `strainer_gan_tpu/obs/profiler.py`).

* ``trace(log_dir)``: a ``torch.profiler`` trace of the enclosed block, CPU
  and (when the card is there) CUDA activity, written as a Chrome trace
  (``log_dir/trace.json``, for chrome://tracing or Perfetto); the context
  yields the profiler, and ``summarize`` reads it: device time by kernel,
  kernel launches, and the device-busy share of the traced wall time.
* ``debug_nans``: the counterpart of ``jax_debug_nans`` is torch's autograd
  anomaly mode, ``torch.autograd.set_detect_anomaly(True)``: it raises when
  a backward function returns NaN, naming the forward op that made it.  It
  does not check forward values that no backward reads (the scoring passes,
  anything under ``no_grad``), nor the optimizer's in-place updates; for
  those, ``utils.trees.finite_check`` (``TrainConfig.check_finite``) checks
  the parameters after each epoch.
* ``span(name)``: the program's own range, ``strainer.<name>``, around a
  phase of the epoch, the strain or the prefilter.  While a
  ``torch.profiler`` session records (``trace``, or any other), it is a
  ``record_function`` range, in the same trace and on the same clock as
  the card's activity, so each idle gap of the card falls inside the
  spans the host was in, and its range on the profiler's clock (Unix
  nanoseconds, ``time.time_ns``) is also kept in a bounded log,
  ``recorded_spans()``, for a reader that holds a reduced trace without
  the host's ranges.  With no session recording it costs one check and
  enters nothing.  No span is opened inside a CUDA graph capture: they
  go around an executor's capture and replay calls, never in its body.
* ``count(name, n)`` / ``counts()``: the program's counters, plain
  integers that are always on and are only added to where the host
  already knows the value (no device read): eager steps by reason
  (``eager.warmup``, ``eager.remainder``, ``eager.tail``,
  ``eager.per_step``) and host reads by what they read
  (``host_read.<what>``).  ``counts_since(before)`` is what was counted
  after a ``counts()`` snapshot; ``Trainer.run_epoch`` returns its
  epoch's under ``counts``.  Chunks are counted by ``graph_stats`` (the
  replays on the card), replayed steps are an epoch's steps less its
  eager ones, grids are ``host_read.grid``.
* ``host_read(what)``: the span ``host_read.<what>`` and its count, around
  a read that blocks the host on the card.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional, Tuple

import torch

SPAN_PREFIX = "strainer."
_recording = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()
_COUNTS: Dict[str, int] = defaultdict(int)
# the newest recorded spans, (name, start ns, end ns): a traced epoch holds
# a few hundred
_SPANS: deque = deque(maxlen=1 << 16)


class _Span:
    """A ``record_function`` range whose range is logged when it closes."""

    __slots__ = ("name", "range", "start")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        _SPANS.append((self.name, self.start, time.time_ns()))
        return self.range.__exit__(*exc)


def span(name: str):
    """``strainer.<name>`` as a logged ``record_function`` range while a
    profiler session records; otherwise a context that does nothing."""
    if not _recording():
        return _NO_SPAN
    return _Span(SPAN_PREFIX + name)


def recorded_spans() -> List[Tuple[str, int, int]]:
    """The newest recorded spans as (name, start ns, end ns), in the order
    they closed; each lies inside its ``record_function`` range."""
    return list(_SPANS)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def counts() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_COUNTS)


def counts_since(before: Dict[str, int]) -> Dict[str, int]:
    """What was counted after the snapshot ``before``, nonzero counts only."""
    return {k: v - before.get(k, 0) for k, v in _COUNTS.items() if v != before.get(k, 0)}


def host_read(what: str):
    """The span ``host_read.<what>``, counted, around one read that blocks
    the host on the card."""
    _COUNTS["host_read." + what] += 1
    return span("host_read." + what)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator["torch.profiler.profile"]:
    """Trace the enclosed block into ``log_dir/trace.json`` (by default a
    ``strainer_trace`` directory under the temporary directory)."""
    import torch.profiler as tp

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "strainer_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(tp.ProfilerActivity.CUDA)
    with tp.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def summarize(prof, steps: int = 1, top: int = 10) -> Dict:
    """What a trace says about ``steps`` steps: the ``top`` device
    operations by total device time (name, count, ms), kernel launches
    (device operations) per step, device-busy ms (the union of the device
    operations' intervals), the traced wall ms (first to last event), and
    the busy share of it."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    # the device's own operations: kernels, copies and sets; not the ranges
    # that annotate them (``Optimizer.step#Adam.step`` spans its kernels
    # and the gaps between them, and also has a CPU event of its name)
    host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.name not in host_names]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in device:
        by_name[e.name][0] += 1
        by_name[e.name][1] += (e.time_range.end - e.time_range.start) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    busy, end = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e.time_range.start):
        lo = max(e.time_range.start, end)
        if e.time_range.end > lo:
            busy += e.time_range.end - lo
        end = max(end, e.time_range.end)
    wall = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
            if events else 0.0)
    return dict(
        top=[dict(name=n, count=c, ms=ms) for n, (c, ms) in ranked],
        launches_per_step=len(device) / max(steps, 1),
        device_busy_ms=busy / 1e3, wall_ms=wall / 1e3,
        busy_share=busy / wall if wall else 0.0,
    )


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Raise on NaN gradients inside the block (see the module docstring for
    what this does not catch)."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)

