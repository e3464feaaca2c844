"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix,
metrics and limits are found by the names in ``BENCHMARK.json``
(``core/spec.py``).  The run makes its inputs and weights from the seed
on the card, runs the set-up (counted as ``setup_s``), measures whole
units of work for ``--seconds``, reads the end-to-end metrics
(``--trace 0``) or the per-layer ones from a traced run (``--trace 1``),
then checks the program's outputs against the plain references and
prints the numbers it compared, each beside its limit, as the last lines
of standard error and under ``compared``, the last key of the result.
The last line of standard output is one JSON object.  Without a card, or
with fewer than the cell asks for, it exits 3 and prints no result; if
JAX or the JAX package was loaded, it exits 4.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "_portbench_cache"  # the build and kernel caches, inside the checkout


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             scale=None, setup_clock: float = None):
    """Set-up, window, metrics and checks of one run: the result dict and
    the compared rows.  A ``device`` other than the card and a ``scale``
    (``drivers.Run``) are for the CPU tests only."""
    import torch

    from portbench.core import checks, drivers, spec

    cell = spec.load_cell(workload)
    t_setup0 = T_START if setup_clock is None else setup_clock
    run = drivers.Run(cell, seed, device, scale=scale)
    run.setup()
    run.setup_s = time.perf_counter() - t_setup0
    run.run_window(seconds, traced=trace)
    on_card = run.device.type == "cuda"
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    run.device_kind = torch.cuda.get_device_name(run.device) if on_card else "cpu"
    run.power_limit = _power_limit() if on_card else "none"
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m.name)(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    units = run.window["units"]
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": run.device_kind,
                   "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes),
                   "power_limit": run.power_limit}
    breakdown = None
    if trace and run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        breakdown = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    # the program's state goes before the reference runs: what the checks
    # read was kept by the run
    run.trainer.drop_captures()
    nums = checks.readings(run)
    correct, rows = checks.decide(nums, cell.limits)
    result = {"correct": bool(correct), "attempted": len(units), "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # the window's units, for a reader of the log (outside the result's contract)
    result["window"] = {"seconds": run.window["seconds"],
                        "units": [[u["images"], u["steps"], u["seconds"]] for u in units]}
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    run.close()
    return result, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.core import guard, spec

    chips = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, rows = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = guard.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules were loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, value, lim in rows:
        print(f"compared {name} = {value!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
