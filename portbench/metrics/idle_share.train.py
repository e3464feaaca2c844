"""The share of a training epoch in which no operation ran on the card,
in %: the traced epoch's busy device time over the run's median untraced
epoch (``work.idle_share``)."""
from portbench.core.work import idle_share


def read(run):
    return idle_share(run, "epoch")
