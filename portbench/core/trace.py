"""The device trace of a traced run, reduced to what the metrics read.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activity) over one unit
of the window (an epoch or a pass) and keeps its raw events as (name,
kind, start ns, end ns, correlation id) tuples: the events are read from
the profiler's result directly, without building its event tree, which
costs minutes at a million kernels.  ``Trace`` holds the reduction: the
arithmetic of ``strainer_gan_tpu_torch/obs/profiler.py::summarize``,
copied so that later changes to the program cannot change the yardstick:
device operations are the CUDA events that are not annotations (an
annotation's name is also a host event's), busy time is the union of
their intervals, the traced window runs from the first to the last
event.  Host spans are the benchmark's own ``record_function`` ranges
(names ``portbench.<what>``), recorded around the calls it makes into
the program's layers.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Tuple

import torch

SPAN_PREFIX = "portbench."
OUTER = ("unit",)  # the span around a whole epoch or pass
TOP = 10


def span(name: str):
    """A host span of the benchmark's, visible in the trace."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


@dataclass(slots=True)
class Event:
    name: str
    device: bool  # a CUDA-side event
    start: int  # ns
    end: int
    corr: int


class Tracer:
    def __init__(self):
        import torch.profiler as tp

        self._prof = tp.profile(activities=[tp.ProfilerActivity.CPU, tp.ProfilerActivity.CUDA])
        self.events: List[Event] = []

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.events = self._read()
        return False

    def _read(self) -> List[Event]:
        from torch.autograd import DeviceType

        out = []
        for e in self._prof.profiler.kineto_results.events():
            start, dur = _ns(e, "start"), _ns(e, "duration")
            if dur <= 0:
                continue
            out.append(Event(e.name(), e.device_type() == DeviceType.CUDA, start, start + dur,
                             int(e.correlation_id())))
        return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


class Trace:
    """What a trace of one unit says."""

    def __init__(self, events: List[Event]):
        host = [e for e in events if not e.device]
        host_names = {e.name for e in host}
        self.device = [e for e in events if e.device and e.name not in host_names
                       and not e.name.startswith(SPAN_PREFIX)]
        self.spans = [e for e in host if e.name.startswith(SPAN_PREFIX)]
        # the runtime's launches (``cudaLaunchKernel``, ``cudaGraphLaunch``, copies) carry
        # the correlation ids of the device operations they start
        self._launch_corr = [(e.start, e.corr) for e in host
                             if e.corr and e.name.startswith("cu")]
        self._launch_corr.sort()
        self.busy_iv = _union([(e.start, e.end) for e in self.device])
        self.t0 = min((e.start for e in events), default=0)
        self.t1 = max((e.end for e in events), default=0)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_iv) / 1e9

    def kernel_seconds(self, names) -> Tuple[float, int]:
        """(device seconds, launches) of the device operations whose
        (demangled, so signed) name holds one of ``names`` as a word."""
        words = [re.compile(r"\b" + re.escape(n) + r"\b") for n in names]
        sel = [e for e in self.device if any(w.search(e.name) for w in words)]
        return sum(e.end - e.start for e in sel) / 1e9, len(sel)

    def top_ops(self, n: int = TOP) -> List[List]:
        by = defaultdict(int)
        for e in self.device:
            by[e.name] += e.end - e.start
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def span_device_seconds(self, name: str) -> List[float]:
        """For each host span ``name``: the busy device seconds of the
        operations launched inside it (matched by correlation id)."""
        by_corr = defaultdict(list)
        for e in self.device:
            by_corr[e.corr].append((e.start, e.end))
        starts = [s for s, _ in self._launch_corr]
        out = []
        for sp in self.spans:
            if sp.name != SPAN_PREFIX + name:
                continue
            lo = bisect.bisect_left(starts, sp.start)
            hi = bisect.bisect_right(starts, sp.end)
            iv = [x for _, c in self._launch_corr[lo:hi] for x in by_corr.get(c, ())]
            out.append(sum(b - a for a, b in _union(iv)) / 1e9)
        return out

    def idle_gaps(self, n: int = TOP) -> List[List]:
        """The device's idle time by the host span it fell in: the inner
        span (one that holds no other of the benchmark's spans) around the
        gap's middle, else the outer one (``OUTER``), else ``outside``;
        the ``n`` largest sums."""
        gaps = []
        prev = self.t0
        for lo, hi in self.busy_iv:
            if lo > prev:
                gaps.append((prev, lo))
            prev = max(prev, hi)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        outer = [s for s in self.spans if s.name[len(SPAN_PREFIX):] in OUTER]
        inner = sorted((s for s in self.spans if s.name[len(SPAN_PREFIX):] not in OUTER),
                       key=lambda s: s.start)
        starts = [s.start for s in inner]
        by = defaultdict(int)
        for lo, hi in gaps:
            mid = (lo + hi) // 2
            i = bisect.bisect_right(starts, mid) - 1
            hit = inner[i] if i >= 0 and inner[i].end >= mid else None
            if hit is None:
                hit = next((s for s in outer if s.start <= mid <= s.end), None)
            name = hit.name[len(SPAN_PREFIX):] if hit is not None else "outside"
            by[name] += hi - lo
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
