"""Steps run eagerly (not by a chunk executor) in the window's first epoch
(the traced one of a traced run): the program's counts of the capture
key's warm-up, the segments' remainders, the partial tail and per-step
runs."""
from portbench.core.program import EAGER, unit_count


def read(run):
    return unit_count(run, lambda k: k in EAGER)
