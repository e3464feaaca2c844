"""What the program says about itself: its own spans in the traced unit
(the ``strainer.<name>`` ranges of ``strainer_gan_tpu_torch/obs/profiler.py``,
which the program logs on the profiler's clock, ``recorded_spans()``: a
``Trace`` keeps only the benchmark's own host ranges) and its counters
(each epoch's ``counts`` in ``Trainer.epoch_results``).  A program that
has neither gives nothing to read: every reader here returns None or an
empty list, and never raises.

The counters are read from one fixed unit, the window's first (the traced
unit of a traced run): the global step runs on from unit to unit, so
later units may run other numbers of eager steps, and a mean over the
window would move with how many units fit in it.

The spans of one thread nest, so a span's children are the spans that
start and end inside it, and the device's idle time inside a span is its
wall time less the busy time of the trace's device operations inside it
(``Trace.busy_iv``, their merged intervals).
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional

from .trace import Event

PREFIX = "strainer."
EAGER = ("eager.warmup", "eager.remainder", "eager.tail", "eager.per_step")


# ------------------------------------------------------------ counters
def unit_counts(run) -> Optional[Dict[str, int]]:
    """The counts of the window's first epoch; None for a run of another
    kind or a program that keeps no counts."""
    if run.kind != "epoch":
        return None
    n = len(run.window.get("units", []))
    results = run.trainer.epoch_results
    if not n or len(results) < n or "counts" not in results[-n]:
        return None
    return results[-n]["counts"]


def unit_count(run, keep: Callable[[str], bool]) -> Optional[int]:
    """The first unit's counts summed over the names ``keep`` accepts."""
    c = unit_counts(run)
    return None if c is None else sum(v for k, v in c.items() if keep(k))


# ------------------------------------------------------------ spans
def program_spans(trace) -> List[Event]:
    """The program's logged spans that lie in the trace's window; none for
    a program that logs none."""
    try:
        from strainer_gan_tpu_torch.obs.profiler import recorded_spans
    except ImportError:
        return []
    return [Event(n, False, lo, hi, 0) for n, lo, hi in recorded_spans()
            if trace.t0 <= lo and hi <= trace.t1]


def spans(trace, name: str) -> list:
    """The program's spans ``name`` in the trace."""
    return [e for e in program_spans(trace) if e.name == PREFIX + name]


class Busy:
    """The busy device time between two instants, from the trace's merged
    busy intervals."""

    def __init__(self, trace):
        iv = trace.busy_iv
        self.starts = [lo for lo, _ in iv]
        self.ends = [hi for _, hi in iv]
        self.cum = [0]
        for lo, hi in iv:
            self.cum.append(self.cum[-1] + hi - lo)

    def between(self, a: int, b: int) -> int:
        """Busy ns in [a, b]."""
        if b <= a:
            return 0
        i = bisect.bisect_right(self.ends, a)  # the first interval ending after a
        j = bisect.bisect_left(self.starts, b)  # the intervals from i to j start before b
        if i >= j:
            return 0
        return (self.cum[j] - self.cum[i] - max(0, a - self.starts[i])
                - max(0, self.ends[j - 1] - b))

    def idle(self, e) -> int:
        """Idle ns inside the span ``e``, its children's included."""
        return (e.end - e.start) - self.between(e.start, e.end)


def idle_inside_s(trace, name: str) -> List[float]:
    """Device idle seconds inside each span ``name``, children included."""
    busy = Busy(trace)
    return [busy.idle(e) / 1e9 for e in spans(trace, name)]


def _tree(trace):
    """The program's spans in start order (outer first at a tie) and the
    index of each one's parent (None at the top)."""
    ordered = sorted(program_spans(trace), key=lambda e: (e.start, -e.end))
    parent, stack = [], []
    for i, e in enumerate(ordered):
        while stack and ordered[stack[-1]].end < e.end:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    return ordered, parent


def strain_events(trace) -> list:
    """The ``epoch.strain`` spans that hold a strain pass (a ``strain.``
    span): the strain events."""
    ordered, parent = _tree(trace)
    holding = set()
    for i, e in enumerate(ordered):
        if e.name.startswith(PREFIX + "strain."):
            p = parent[i]
            while p is not None and ordered[p].name != PREFIX + "epoch.strain":
                p = parent[p]
            if p is not None:
                holding.add(p)
    return [ordered[i] for i in sorted(holding)]
