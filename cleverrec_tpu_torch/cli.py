"""CLI entry point of the port (as ``cleverrec_tpu/cli.py``).

Reads ./CleverRec.properties + conf/<Model>.properties like the
reference's ``python main.py``, with --config/--conf-dir/--model/--set
overrides, then loads the data, trains and evaluates on ``--device``
(default ``cuda``: without a card it exits with an error; pass ``cpu`` to
run on the CPU).

Usage:
    python -m cleverrec_tpu_torch.cli --config CleverRec.properties
           [--model BPR] [--set epoches=5 --set lr=0.01] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.utils.logging import get_logger

# Flags of the JAX CLI that the port does not have yet, and where
# ROADMAP.md queues them.
_UNPORTED_FLAGS = {
    "mesh": ("--mesh", "queue 1, item 16 (parallel)"),
    "distributed": ("--distributed", "queue 1, item 16 (parallel)"),
    "export_serving": ("--export-serving", "queue 1, item 6 (export)"),
    "resume": ("--resume", "queue 1, item 15 (checkpoints)"),
    "tune": ("--tune", "queue 1, item 15 (tuning)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cleverrec-tpu-torch",
        description="cleverrec-tpu on PyTorch and CUDA")
    p.add_argument("--config", default="./CleverRec.properties",
                   help="global properties file ([default] section)")
    p.add_argument("--conf-dir", default=None,
                   help="per-model properties dir (default: config_dir key)")
    p.add_argument("--model", default=None,
                   help="override the recommender name")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="config override, repeatable")
    p.add_argument("--list-models", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--mesh", default=None, metavar="DxM",
                   help="not ported yet")
    p.add_argument("--distributed", action="store_true",
                   help="not ported yet")
    p.add_argument("--export-serving", default=None, metavar="DIR",
                   help="not ported yet")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="not ported yet")
    p.add_argument("--tune", action="store_true", help="not ported yet")
    return p


def run_experiment(cfg: Config, device="cuda", logger=None):
    """Load data, build the model and trainer, run the full loop; returns
    the trainer's best-epoch summary."""
    from cleverrec_tpu_torch.data import load_ranking_data
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.train import Trainer

    logger = logger or get_logger(cfg.get("log.dir"), cfg.recommender)
    logger.info("=" * 80)
    logger.info("Current model: %s", cfg.recommender)
    data = load_ranking_data(cfg, rng=np.random.default_rng(cfg.seed),
                             logger=logger)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device=device)
    return Trainer(model, data, cfg, logger=logger, device=device).run()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_models:
        from cleverrec_tpu_torch.models import available_models
        print("\n".join(available_models()))
        return 0
    for attr, (flag, where) in _UNPORTED_FLAGS.items():
        if getattr(args, attr):
            print(f"{flag} is not ported yet (ROADMAP.md {where})",
                  file=sys.stderr)
            return 2
    overrides = {}
    if args.model:
        overrides["recommender"] = args.model
    for kv in args.set:
        if "=" not in kv:
            print(f"bad --set {kv!r} (want key=value)", file=sys.stderr)
            return 2
        k, v = kv.split("=", 1)
        overrides[k] = v
    cfg = Config.from_properties(args.config, args.conf_dir, overrides)
    if cfg.model_type != "ranking":
        print(f"model_type={cfg.model_type} is not ported yet (ROADMAP.md "
              "queue 1, item 13: rating)", file=sys.stderr)
        return 2
    run_experiment(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
