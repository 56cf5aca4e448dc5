"""The readings that each limit of ``limits/<cell>.json`` is set from.

    python3 portbench/calibrate.py --workload <cell> [--seeds 12]
        [--faults 3] [--base 4000000000] [--out FILE]

In one process (set-up once): the port's numbers on ``--seeds`` seeds
(its lower readings), then on ``--faults`` seeds each the reference in
the port's place, as the control (the precision below the configured
one) and with each planted fault of the cell's kind (its upper
readings).  The port runs what the timed path runs: the first steps of
a training run, an evaluation and its top-k, or a sample of retrieval
calls.  Writes every reading as JSON to ``--out`` and prints, for each
number, the largest port reading and the smallest of each stand-in.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--base", type=int, default=4_000_000_000)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from portbench import harness, synth
    from portbench.kinds import KINDS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_bench()
    w = harness.workload(bench, args.workload)
    conf, mix = harness.config(w["config"]), harness.traffic(w["traffic"])
    kind = KINDS[mix["kind"]](conf, mix, "cuda:0",
                              synth.ensure(conf["dataset"]))
    t0 = time.perf_counter()
    kind.build()
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    stand_ins = ("control",) + kind.FAULTS
    readings = {how: [] for how in ("port",) + stand_ins}
    seeds = [args.base + 7919 * n for n in range(args.seeds)]
    for n, seed in enumerate(seeds):
        kind.reseed(seed)
        kind.prepare(warm=False)
        for _ in range(2 * int(mix.get("check_calls", 0))):
            kind.unit()
        t = time.perf_counter()
        readings["port"].append({"seed": seed, **kind.check(kind.collect())})
        print(json.dumps(readings["port"][-1]),
              f"check {time.perf_counter() - t:.1f} s", flush=True)
        if n < args.faults:
            for how in stand_ins:
                readings[how].append({"seed": seed, **kind.check(
                    kind.reference_outputs(how))})
                print(how, json.dumps(readings[how][-1]), flush=True)
    summary = {}
    for name in readings["port"][0]:
        if name == "seed":
            continue
        summary[name] = {"port_max": max(r[name] for r in readings["port"])}
        for how in stand_ins:
            summary[name][f"{how}_min"] = min(r[name] for r in readings[how])
    print(json.dumps(summary, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"readings": readings, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
