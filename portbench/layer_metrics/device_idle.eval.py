"""The device's idle share of the traced eval units: 1 - (the union of
the profiler's device records) / (the traced window), in %."""


def read(run):
    return run.idle_share() if run.kind == "eval" else None
