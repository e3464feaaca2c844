"""Device milliseconds of a strain event: the busy time of the operations
launched inside the benchmark's span around ``engine.on_epoch_start``
(the scoring passes, K1, the percentile), averaged over the traced
events."""


def read(run):
    if run.trace is None:
        return None
    per = [s for s in run.trace.span_device_seconds("strain") if s > 0]
    return 1000.0 * sum(per) / len(per) if per else None
