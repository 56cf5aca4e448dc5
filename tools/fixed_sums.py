"""Does an epoch come out the same twice, with and without fixed sums?

    python3 tools/fixed_sums.py

(on a GPU).  For each case that ``chip_smoke.py``'s phases Q (Q-split)
and R hold to an unmeshed epoch at a tolerance (SoHRML's dual epoch,
LightGCN at its conf with the full-catalog split, EATNN, SAMN's flat
scan tier, FM) on the smoke's rebuilt ml-100k: the unmeshed epoch from
the seed's state and draw, run twice with ``index_add``'s and indexing's
backward atomics as they are, then twice under ``chip_smoke.fixed_sums``
(torch's deterministic algorithms).  Prints one JSON line a case and
mode: the largest difference between the two runs' states, their losses,
the ops that ``fixed_sums`` found without a fixed order, and each run's
ms; then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from cleverrec_tpu_torch.ops import build  # noqa: E402

CASES = (("SoHRML", {"train.fused_kernel": "False"}),
         ("LightGCN", cs.Q_FULL), ("EATNN", {}),
         ("SAMN", {"train.grouped_pairs": "False"}), ("FM", {}))


def state_diff(a: dict, b: dict) -> float:
    return max((a["state"][p][n] - b["state"][p][n]).abs().max().item()
               for p in a["state"] for n in a["state"][p])


def main() -> int:
    if not torch.cuda.is_available():
        print("fixed_sums: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    cs.write_ml100k()
    cs.write_trusts()
    cs.write_ml100k_libfm()
    for fixed in (False, True):
        for name, over in CASES:
            a, b = (cs.r_run(name, over, None, fixed=fixed) for _ in "ab")
            print(json.dumps({"case": name, "fixed": fixed,
                              "max_diff": state_diff(a, b),
                              "loss": [a["loss"], b["loss"]],
                              "unfixed": a["unfixed"] + b["unfixed"],
                              "ms": [a["epoch_ms"], b["epoch_ms"]]}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
