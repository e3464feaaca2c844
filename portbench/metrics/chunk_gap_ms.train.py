"""The card's idle milliseconds a chunk: its idle time inside the
program's ``step.chunk`` spans of the traced epoch (the draws, the
stacking, the replay's launch, the console's reads), over their number."""
from portbench.core.program import idle_inside_s


def read(run):
    if run.trace is None or run.kind != "epoch":
        return None
    idle = idle_inside_s(run.trace, "step.chunk")
    return 1000.0 * sum(idle) / len(idle) if idle else None
