"""The card's idle milliseconds a strain event: its idle time inside the
program's ``epoch.strain`` spans that hold a strain pass, in the traced
epoch (the host's reads of the band and the kept count, and the
launches between the passes), over their number."""
from portbench.core.program import Busy, strain_events


def read(run):
    if run.trace is None:
        return None
    events = strain_events(run.trace)
    if not events:
        return None
    busy = Busy(run.trace)
    return 1000.0 * sum(busy.idle(e) for e in events) / 1e9 / len(events)
