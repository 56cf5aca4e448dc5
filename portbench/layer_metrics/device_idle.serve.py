"""The device's idle share of the traced serve units: 1 - (the union of
the profiler's device records) / (the traced window), in %."""


def read(run):
    return run.idle_share() if run.kind == "serve" else None
