"""The sampler's epoch draw (``Trainer.sample_epoch``), ms an epoch: the
benchmark's span around it, the device synchronised on both sides."""


def read(run):
    spans = [u["spans"]["sample"] for u in run.units if "sample" in u["spans"]]
    return 1e3 * sum(spans) / len(spans) if spans else None
