"""Images scored a second by the prefilter, over the whole window."""
from portbench.core.work import window_rate


def read(run):
    return window_rate(run, "prefilter")
