"""When does a recipe leave its early plateau, run after run?

    python3 tools/mlp_plateau.py [--model MLP] [--runs 40] [--epochs 30]
        [--tier fused|scan] [--seeds 1,2,...]

(on a GPU).  Trains ``--model``'s conf (``chip_smoke.py`` phase E's
recipe on its rebuilt ml-100k) ``--runs`` times from the conf's seed
through ``Trainer`` on the given tier, evaluating every epoch, then once
for each of ``--seeds``.  ``conf/MLP.properties`` sits near HR@10 0.4
for about ten epochs before it learns; with sums whose order varies
from run to run, when it leaves varies too.  Prints one JSON line a run:
its seed, the first epoch with HR@10 above 0.6 (``leaves``, null if
none), its best HR@10 (at the best NDCG@10 epoch, as the trainer picks
it), and its per-epoch losses; then a summary line of each group: the
``leaves`` epochs, the best HR@10s and how many distinct loss
sequences the runs gave (1: the runs repeat bit for bit).  Then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from cleverrec_tpu_torch.data import load_ranking_data  # noqa: E402
from cleverrec_tpu_torch.models import make_model  # noqa: E402
from cleverrec_tpu_torch.models.base import DataMeta  # noqa: E402
from cleverrec_tpu_torch.train import Trainer  # noqa: E402

LEAVE_HR10 = 0.6


def one_run(model: str, epochs: int, tier: str, seed: int | None) -> dict:
    over = {"epoches": epochs,
            "train.fused_kernel": str(tier == "fused")}
    if seed is not None:
        over["seed"] = seed
    cfg = cs.config("ml-100k", recommender=model, **over)
    data = load_ranking_data(cfg, rng=np.random.default_rng(cfg.seed))
    trainer = Trainer(make_model(cfg, DataMeta(data.user_nums,
                                               data.item_nums)),
                      data, cfg)
    cs.check(trainer.fused == (tier == "fused"), f"{model}: tier {tier}")
    params, state = trainer.init_state()
    losses, hr, ndcg = [], [], []
    for _ in range(epochs):
        params, state, loss = trainer.train_epoch(params, state)
        res = trainer.evaluate()
        losses.append(float(loss))
        hr.append(res[10][0])
        ndcg.append(res[10][2])
    best = max(range(epochs), key=lambda e: (ndcg[e], -e))
    return {"seed": cfg.seed,
            "leaves": next((e + 1 for e, h in enumerate(hr)
                            if h > LEAVE_HR10), None),
            "best_hr10": hr[best], "best_epoch": best + 1,
            "losses": losses}


def summary(group: str, runs: list) -> dict:
    return {"group": group, "leaves": [r["leaves"] for r in runs],
            "best_hr10": [r["best_hr10"] for r in runs],
            "distinct_loss_sequences": len({tuple(r["losses"])
                                            for r in runs})}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="MLP")
    ap.add_argument("--runs", type=int, default=40)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--tier", choices=("fused", "scan"), default="fused")
    ap.add_argument("--seeds", default="",
                    help="comma-separated seeds, one run each")
    args = ap.parse_args()
    cs.write_ml100k()
    groups = {"conf_seed": [None] * args.runs,
              "seeds": [int(x) for x in args.seeds.split(",") if x]}
    for group, seeds in groups.items():
        runs = []
        for seed in seeds:
            runs.append(one_run(args.model, args.epochs, args.tier, seed))
            print(json.dumps({"group": group, **runs[-1]}), flush=True)
        if runs:
            print(json.dumps(summary(group, runs)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
