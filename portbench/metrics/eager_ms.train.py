"""Wall milliseconds of an eager step, the mean over the program's
``step.eager`` spans in the traced epoch (draws, gather, step and
accounting; on the host's clock, under the profiler)."""
from portbench.core.program import durations_s


def read(run):
    if run.trace is None or run.kind != "epoch":
        return None
    d = durations_s(run.trace, "step.eager")
    return 1000.0 * sum(d) / len(d) if d else None
