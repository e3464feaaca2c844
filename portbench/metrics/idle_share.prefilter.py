"""The share of a prefilter pass in which no operation ran on the card,
in %: the traced pass's busy device time over the run's median untraced
pass (``work.idle_share``)."""
from portbench.core.work import idle_share


def read(run):
    return idle_share(run, "prefilter")
