"""Where does a scan-tier epoch's time go, model by model?

    python3 tools/epoch_profile.py [--models DiffNet,SML,...] [--epochs 5]

(on a GPU).  For each model (default: ``chip_smoke.py`` phase K's
seven), on its conf and phase K's files (the rebuilt ml-100k and the
seeded trust graph), builds a ``Trainer``, trains 3 warm-up epochs, then
times ``--epochs`` epochs and 5 evals on the host clock (each ending in
a synchronise), and profiles one more epoch with ``chip_smoke.breakdown``
(the device's records summed by kernel).  Prints one JSON line a model:
its steps, the epoch and eval times, the profiled epoch's wall and
device ms, ``busy`` (device ms over the median unprofiled epoch) and
the top kernels by device time; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from cleverrec_tpu_torch.data import load_ranking_data  # noqa: E402
from cleverrec_tpu_torch.models import make_model  # noqa: E402
from cleverrec_tpu_torch.models.base import DataMeta  # noqa: E402
from cleverrec_tpu_torch.train import Trainer  # noqa: E402

WARMUP = 3


def profile(name: str, epochs: int) -> dict:
    cfg = cs.config("ml-100k", recommender=name)
    data = load_ranking_data(cfg)
    trainer = Trainer(make_model(cfg, DataMeta(data.user_nums,
                                               data.item_nums)),
                      data, cfg)
    params, state = trainer.init_state()
    for _ in range(WARMUP):
        trainer.train_epoch(params, state)
    walls = [cs.sync_s(lambda: trainer.train_epoch(params, state))[1] * 1e3
             for _ in range(epochs)]
    evals = [cs.sync_s(trainer.evaluate)[1] * 1e3 for _ in range(5)]
    prof = cs.breakdown(lambda: trainer.train_epoch(params, state), top=6)
    return {"model": name, "steps": trainer.steps_per_epoch,
            "epoch_ms": walls, "eval_ms": evals,
            "profiled_wall_ms": prof["wall_ms"],
            "device_ms": prof["device_ms"],
            "busy": prof["device_ms"] / float(np.median(walls)),
            "top": prof["top"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=",".join(cs.K_EPOCHS))
    ap.add_argument("--epochs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("epoch_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.write_ml100k()
    cs.write_trusts()
    for name in args.models.split(","):
        print(json.dumps(profile(name, args.epochs)), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
