"""Profiling and throughput (counterpart of `strainer_gan_tpu/obs/profiler.py`).

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
* ``measure_throughput``: host-clock seconds per step of a chained step
  function, the card synchronised before and after the timed steps (the
  step returns before the card finishes).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional

import torch


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


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_throughput(step_fn: Callable, make_args: Callable[[int], tuple], *,
                       iters: int = 30, warmup: int = 5, items_per_step: int,
                       device: Optional[torch.device] = None) -> Dict:
    """Time ``step_fn(*make_args(i))`` over ``iters`` calls after ``warmup``
    calls; ``device`` is synchronised before and after the timed calls."""
    for i in range(warmup):
        step_fn(*make_args(i))
    _sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        step_fn(*make_args(warmup + i))
    _sync(device)
    dt = time.perf_counter() - t0
    return dict(seconds_per_step=dt / iters, items_per_second=items_per_step * iters / dt,
                iters=iters)
