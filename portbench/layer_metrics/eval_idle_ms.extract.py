"""The device's idle ms an evaluation while the port's ``rank.extract``
span (``ranking.rank_fused``'s k rounds of max extraction) is open on the
host."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "rank.extract")
