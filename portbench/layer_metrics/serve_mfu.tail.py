"""The card's share of the tail call: the least time of a call's required
work (the configuration's ``serve_call`` count) over the 95th percentile
of the window's latencies (due to ids on the host), in %."""

import numpy as np


def read(run):
    if run.kind != "serve" or not run.units:
        return None
    p95 = float(np.percentile([u["work"]["latency_s"] for u in run.units],
                              95))
    return 100.0 * run.least("serve_call") / p95
