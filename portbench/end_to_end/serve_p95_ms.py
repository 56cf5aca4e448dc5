"""The 95th percentile of every call's latency in the window, from issue
until its [B, k] ids are on the host, in ms."""

import numpy as np


def read(run):
    if run.kind != "serve":
        return None
    return 1e3 * float(np.percentile([u["work"]["latency_s"]
                                      for u in run.units], 95))
