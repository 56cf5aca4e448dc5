"""A whole evaluation's share of the card's peak: the least time of its
required work (the configuration's ``evaluate`` count) over its wall
time, averaged over the window's evaluations, in %."""


def read(run):
    if run.kind != "eval" or not run.units:
        return None
    return 100.0 * run.least("evaluate") * len(run.units) / sum(
        run.unit_seconds())
