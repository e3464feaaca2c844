"""What decides ``correct``: the program's outputs on the window's entry,
at the timed sizes, against a plain reference.  A cell's traffic file
names its judge (``judge``), found by name in ``judges/<judge>.py``
(``spec.judge_module``); each judge gives

* ``outputs(run)``: what the program produced, in the form it reads;
* ``reference(run, out)``: the plain reference's answers;
* ``judge(run, out, ref)``: the compared numbers;
* ``control(run, out)``: the reference in the program's place, one
  precision below the configuration's, and ``fault(run, out, ref, name)``,
  the program's outputs with one of its ``FAULTS`` planted (both for
  ``calibrate.py``, which sets the limits).

``decide`` holds the numbers against the cell's limits.
"""
from __future__ import annotations

import math
from typing import Dict

from . import spec


def judge_of(run):
    return spec.judge_module(run.traffic["judge"])


def readings(run) -> Dict[str, float]:
    """The compared numbers of the program's run."""
    j = judge_of(run)
    out = j.outputs(run)
    return j.judge(run, out, j.reference(run, out))


def decide(nums: Dict[str, float], limits: Dict) -> tuple:
    """(correct, [(name, value, limit)]): every number with a limit at or
    below it; a number without a limit is printed, not decided on.  A cell
    without limits is never correct, nor one with a limit on a number its
    judge did not give."""
    rows, ok = [], bool(limits)
    for name, value in nums.items():
        lim = limits.get(name)
        rows.append((name, value, lim))
        if lim is not None and (math.isnan(value) or value > lim):
            ok = False
    for k in limits:
        if k not in nums:
            rows.append((k, float("nan"), limits[k]))
            ok = False
    return ok, rows
