"""Where fused retrieval stops beating dense retrieval, on a GPU.

    python3 tools/serve_crossover.py [--sizes 1682,4096,...] [--repeats 5]

For each catalog size, BPR at the width of ``conf/BPR.properties``
(embed 128, random tables from seed 0) over a synthetic seen table
(4,096 users, 40 items each, Pareto(1.2) popularity as in
``chip_smoke.write_catalog``), serves the two call shapes of
``chip_smoke.py``'s phases A (256 users, k=10) and B (1,024 users, k=20)
through ``build_retrieval_fn`` with ``backend="fused"`` and ``"dense"``,
in turns (fused, dense, dense, fused, ``--repeats`` rounds), and prints
one JSON line per size and shape: ms per synchronised call of each
backend (the mean of 10 calls, the median over the rounds) and which is
faster.  The last line gives, per shape, the smallest size from which
dense is faster at every size measured, and the card's name and power
limit.  ``serving.FUSED_MAX_ITEMS`` is set from it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from cleverrec_tpu_torch.config import Config  # noqa: E402
from cleverrec_tpu_torch.models import make_model  # noqa: E402
from cleverrec_tpu_torch.models.base import DataMeta  # noqa: E402
from cleverrec_tpu_torch.sampling import build_member_table  # noqa: E402
from cleverrec_tpu_torch.serving import build_retrieval_fn  # noqa: E402

SIZES = (1682, 2048, 2560, 3072, 3584, 4096, 4097, 6000, 8192, 16384,
         32768, 65536, 103523)
SHAPES = ((256, 10), (1024, 20))
N_USERS, PER_USER = 4096, 40


def seen_table(n_items: int, rng):
    head = np.clip((rng.pareto(1.2, (N_USERS, PER_USER)) * n_items / 50)
                   .astype(np.int64), 0, n_items - 1)
    return build_member_table({u: head[u].tolist() for u in range(N_USERS)},
                               N_USERS, n_items)


def per_call_ms(fn, u, calls: int = 10) -> float:
    fn(u)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(u)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_crossover: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    faster = {shape: [] for shape in SHAPES}
    for n_items in map(int, args.sizes.split(",")):
        dd = types.SimpleNamespace(seen=seen_table(n_items, rng))
        cfg = Config({"recommender": "BPR", "embed_size": "128",
                      "reg": "0.01", "seed": "0"})
        model = make_model(cfg, DataMeta(N_USERS, n_items))
        for b, k in SHAPES:
            fns = {name: build_retrieval_fn(model, {}, dd, k=k, backend=name)
                   for name in ("fused", "dense")}
            u = np.sort(rng.choice(N_USERS, b, replace=False))
            times = {"fused": [], "dense": []}
            for _ in range(args.repeats):
                for name in ("fused", "dense", "dense", "fused"):
                    times[name].append(per_call_ms(fns[name], u))
            row = {"items": n_items, "users": b, "k": k,
                   **{f"{name}_ms": statistics.median(t)
                      for name, t in times.items()}}
            row["faster"] = ("dense" if row["dense_ms"] < row["fused_ms"]
                             else "fused")
            faster[(b, k)].append((n_items, row["faster"]))
            print(json.dumps(row), flush=True)
    crossover = {}
    for (b, k), rows in faster.items():
        dense_from = None
        for n_items, which in sorted(rows):
            if which == "dense":
                dense_from = n_items if dense_from is None else dense_from
            else:
                dense_from = None
        crossover[f"{b}x{k}"] = dense_from
    print(json.dumps({"dense_faster_from": crossover, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
