"""Images trained a second: each epoch's live rows (the strain's kept
rows; all rows without a strain), over the whole window, strain events,
grids and eager steps included."""
from portbench.core.work import window_rate


def read(run):
    return window_rate(run, "epoch")
