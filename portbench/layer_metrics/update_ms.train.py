"""The epoch's steps and updates, ms an epoch: each epoch's span less its
sampler span."""


def read(run):
    rest = [u["t1"] - u["t0"] - u["spans"]["sample"] for u in run.units
            if "sample" in u["spans"]]
    return 1e3 * sum(rest) / len(rest) if rest else None
