"""Find the highest rate a serve cell's configuration sustains.

    python3 portbench/sweep.py --workload <serve cell> --rates 250,300,...
        [--seconds 5] [--seed 1]

Sets up once, then offers each rate (calls a second) for ``--seconds``
through the cell's own kind and prints, a rate a line, the calls
completed a second, the latencies' median and 95th percentile, and the
last call's lateness.  A rate is sustained where the calls completed
keep up with it and the last call is not late by more than a few
calls: the cells' rates (``traffic/<mix>.json`` ``calls_per_s``) are set
from the highest one, once, when a cell is defined.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from portbench import harness, synth
    from portbench.kinds import KINDS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = harness.workload(harness.load_bench(), args.workload)
    conf, mix = harness.config(w["config"]), dict(harness.traffic(
        w["traffic"]))
    kind = KINDS[mix["kind"]](conf, mix, "cuda:0",
                              synth.ensure(conf["dataset"]))
    kind.build()
    kind.reseed(args.seed)
    for rate in (float(r) for r in args.rates.split(",")):
        mix["calls_per_s"] = rate
        kind.prepare()
        units, window_s = harness.window(kind, args.seconds, False)
        lat = [u["work"]["latency_s"] for u in units]
        print(json.dumps({
            "offered_calls_per_s": rate,
            "completed_calls_per_s": len(units) / window_s,
            "latency_p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "latency_p95_ms": 1e3 * float(np.percentile(lat, 95)),
            "last_late_ms": 1e3 * lat[-1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
