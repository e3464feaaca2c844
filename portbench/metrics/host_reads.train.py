"""Reads that block the host on the card in the window's first epoch (the
traced one of a traced run): console values, the epoch's stats, the mask,
the strain's reads, the grids, the epoch's close; the program's
``host_read.<what>`` counts."""
from portbench.core.program import unit_count


def read(run):
    return unit_count(run, lambda k: k.startswith("host_read."))
