"""Steps run inside a CUDA graph launch, plain or gated, over all steps the
window ran, in %: each epoch's ``steps`` less its eager counts (the
program's ``eager.*`` counters of that epoch), summed over the window's
epochs.  A window that runs no eager step reads 100.0; it never passes
100.  None for a program that keeps no counts."""
from portbench.core.program import EAGER


def read(run):
    if run.kind != "epoch":
        return None
    units = run.window["units"]
    steps = sum(u["steps"] for u in units)
    if not steps or any(u.get("counts") is None for u in units):
        return None
    eager = sum(v for u in units for k, v in u["counts"].items() if k in EAGER)
    return 100.0 * (steps - eager) / steps
