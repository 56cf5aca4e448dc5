"""CLI entry point of the port (as ``cleverrec_tpu/cli.py``).

Reads ./CleverRec.properties + conf/<Model>.properties like the
reference's ``python main.py``, with --config/--conf-dir/--model/--set
overrides, then loads the data, trains and evaluates on ``--device``
(default ``cuda``: without a card it exits with an error; pass ``cpu`` to
run on the CPU).

Usage:
    python -m cleverrec_tpu_torch.cli --config CleverRec.properties
           [--model BPR] [--set epoches=5 --set lr=0.01] [--device cpu]
           [--resume saved_model/BPR] [--tune] [--export-serving DIR]

``--resume`` restarts a run from a checkpoint that ``save.best=True``
wrote (``saved_dir/<model>``); ``--tune`` grid-searches the list-valued
embed_size, reg and neg_ratio (``tuning.py``) instead of one run;
``--export-serving DIR`` writes a serving bundle of the trained model
(``serving.export_bundle``: retrieval and rerank ``torch.export``
programs and ``meta.json``) after the run, on ``--device``.  With
``model_type=rating`` (FM, FFM: ``rating.py``) the run trains on the
libFM files ``<data.root_dir>/<data.dataset>/<data.dataset><train>`` and
``...<test>``, and ``--resume`` and ``--export-serving`` are ignored, as
the JAX CLI ignores them there.
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
                   help="after training, write a serving bundle "
                        "(retrieval + rerank torch.export programs + "
                        "meta.json) to DIR; serve.batch / serve.n_cand / "
                        "serve.backend config keys tune it")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume from a train-state checkpoint directory")
    p.add_argument("--tune", action="store_true",
                   help="grid-search list-valued keys (embed_size/reg/"
                        "neg_ratio, the main_tuning.py axes) instead of a "
                        "single run")
    return p


def run_experiment(cfg: Config, device="cuda", logger=None,
                   resume_from=None, export_serving=None):
    """Load data, build the model and trainer, run the full loop (from
    the checkpoint ``resume_from`` if given; a ``model_type=rating`` run
    always starts afresh), then write a serving bundle to
    ``export_serving`` if given (not for rating); returns the trainer's
    best-epoch summary."""
    from cleverrec_tpu_torch.data import load_ranking_data
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.train import Trainer

    logger = logger or get_logger(cfg.get("log.dir"), cfg.recommender)
    logger.info("=" * 80)
    logger.info("Current model: %s", cfg.recommender)
    if cfg.model_type == "rating":
        from cleverrec_tpu_torch.rating import run_rating
        return run_rating(cfg, logger, device=device)
    data = load_ranking_data(cfg, rng=np.random.default_rng(cfg.seed),
                             logger=logger)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device=device)
    trainer = Trainer(model, data, cfg, logger=logger, device=device)
    best = trainer.run(resume_from=resume_from)
    if export_serving:
        from cleverrec_tpu_torch.serving import export_bundle
        manifest = export_bundle(
            model, trainer.aux, trainer.dd, export_serving,
            batch=cfg.int("serve.batch", 256),
            n_cand=cfg.int("serve.n_cand", 128), k=cfg.topk[0],
            backend=cfg.str("serve.backend", "auto"), device=device)
        logger.info("serving bundle (%s backend) written to %s",
                    manifest["backend"], export_serving)
    return best


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_models:
        from cleverrec_tpu_torch.models import available_models
        print("\n".join(available_models()))
        return 0
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
    for attr, (flag, where) in _UNPORTED_FLAGS.items():
        if getattr(args, attr):
            print(f"{flag} is not ported yet (ROADMAP.md {where})",
                  file=sys.stderr)
            return 2
    # --tune and a rating run ignore --resume and --export-serving, as the
    # JAX CLI does.
    if args.tune:
        from cleverrec_tpu_torch.tuning import run_grid
        logger = get_logger(cfg.get("log.dir"), cfg.recommender + "_tune")
        if args.resume or args.export_serving:
            logger.info("--resume/--export-serving are ignored with --tune")
        run_grid(cfg, logger=logger, device=args.device)
        return 0
    if cfg.model_type == "rating":
        # The JAX CLI returns from a rating run before it reads these.
        logger = get_logger(cfg.get("log.dir"), cfg.recommender)
        if args.resume or args.export_serving:
            logger.info("--resume/--export-serving are ignored with "
                        "model_type=rating")
        run_experiment(cfg, device=args.device, logger=logger)
        return 0
    run_experiment(cfg, device=args.device, resume_from=args.resume,
                   export_serving=args.export_serving)
    return 0


if __name__ == "__main__":
    sys.exit(main())
