"""The work a run did, from shapes and the program's counters: what the
metric readers divide by time."""
from __future__ import annotations

import statistics
from typing import Optional

from . import flops as FL
from .peaks import peaks_for


def masked_steps(run) -> bool:
    """Whether the cell's epoch runs the in-step mask."""
    s = run.config.get("strain", {})
    return (s.get("method") == "batch_quantile_mask"
            and int(run.traffic.get("epoch", -1)) >= s.get("mask_start_epoch", 10))


def k1_elements(engine: dict) -> Optional[int]:
    """Losses K1 wrote in a strain event: the base's bfloat16 bulk, then the
    float32 band (or, after an overflow, the whole base again)."""
    if engine.get("score_path") is None:
        return None
    m = engine["base_rows"]
    if engine.get("score_path") != "band":
        return m
    return 2 * m if engine.get("fell_back") else m + int(engine.get("n_rescored", 0))


def train_unit_flops(run) -> float:
    """Model FLOPs of the traced epoch: its steps at the full batch, and
    the strain's D forwards over the base (and the re-scored band)."""
    model = run.config["model"]
    steps = run.traced["steps"]
    bs = run.config["data"]["batch_size"]
    total = steps * bs * FL.dcgan_step_flops(model, masked_steps(run))
    k1 = k1_elements(run.traced.get("engine", {}))
    if k1:
        total += k1 * FL.dcgan_d_forward_flops(model)
    return float(total)


def peaks(run) -> dict:
    return peaks_for(run.device_kind)


def window_rate(run, kind: str) -> Optional[float]:
    """Images a second over the whole window, if the cell's units are of
    ``kind``."""
    if run.kind != kind or not run.window.get("units"):
        return None
    return sum(u["images"] for u in run.window["units"]) / run.window["seconds"]


def untraced_unit_s(run) -> Optional[float]:
    """A traced run's median untraced unit, in seconds: what the traced
    unit's device time is set against, since the profiler stretches the
    traced unit's host-paced parts (the trace's own span is
    ``device.window_s``)."""
    units = run.window.get("units", [])[1:]
    if run.trace is None or not units:
        return None
    return statistics.median(u["seconds"] for u in units)


def idle_share(run, kind: str) -> Optional[float]:
    """100 x (1 - the traced unit's busy device seconds over the median
    untraced unit's seconds), for a cell whose units are of ``kind``; not
    capped: a reading under 0 says the untraced units ran shorter than the
    traced one's device time."""
    unit_s = untraced_unit_s(run)
    if run.kind != kind or not unit_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / unit_s)
