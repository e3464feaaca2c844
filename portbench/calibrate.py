"""The readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out <file.json>]

For every seed: the program's compared numbers (a sound run: set-up and,
for a pass-type cell, one pass).  For each control seed also: the
control's numbers (the reference put in the program's place, computed one
precision below the configuration's: fp8 steps for bfloat16 training,
TF32 scoring and features for float32 decisions) and each fault's (the
cell's judge, ``judges/<judge>.py``, names them and plants them).  No
window is timed; the cell runs at its own size.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings_for(run, controls: bool):
    """The program's numbers and, with ``controls``, the control's and each
    fault's (the judge's ``FAULTS``), against one reference."""
    from portbench.core import checks as C

    j = C.judge_of(run)
    out = j.outputs(run)
    ref = j.reference(run, out)
    res = {"program": j.judge(run, out, ref)}
    if controls:
        res["control"] = j.judge(run, j.control(run, out), ref)
        for f in j.FAULTS:
            bad = j.fault(run, out, ref, f)
            if bad is not None:
                res[f] = j.judge(run, bad, ref)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from portbench.core import drivers, spec

    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    out = {"workload": args.workload, "runs": {}}
    for seed in seeds + sorted(ctrl - set(seeds)):
        run = drivers.Run(cell, seed, "cuda")
        run.setup()
        if run.kind == "prefilter":
            run.run_window(0.0)
        run.trainer.drop_captures()
        res = readings_for(run, seed in ctrl)
        if seed not in seeds:
            res.pop("program")
        out["runs"][str(seed)] = res
        print(json.dumps({"seed": seed, **res}), flush=True)
        run.close()
        del run
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
