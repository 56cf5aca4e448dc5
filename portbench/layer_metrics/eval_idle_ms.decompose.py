"""The device's idle ms an evaluation while the port's ``rank.decompose``
span (``ranking.rank_fused``'s ``model.dot_decomposition``: LightGCN's
propagation) is open on the host."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "rank.decompose")
