"""The whole epoch's share of the card's peak: the least time of its
required work (the configuration's ``train_epoch`` count) over its wall
time, averaged over the window's epochs, in %."""


def read(run):
    if run.kind != "train" or not run.units:
        return None
    return 100.0 * run.least("train_epoch") * len(run.units) / sum(
        run.unit_seconds())
