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

``--distributed`` initialises the default process group from a
launcher's environment (``torchrun`` / ``python -m torch.distributed.run``:
NCCL and ``cuda:LOCAL_RANK`` with ``--device cuda``, gloo and every rank
on that one card with ``--device cuda:N``, gloo with ``--device cpu``);
``--mesh DxM`` builds a ``data x model`` mesh over that world
(``parallel/mesh.py``; default with ``--distributed``: every rank on the
data axis), and training (ranking or rating, either
``parallel.exchange``), evaluation, ``--tune`` and ``--resume`` run on it:
a model axis M > 1 row-shards the tables over M ranks, e.g.

    torchrun --nproc-per-node 2 -m cleverrec_tpu_torch.cli --distributed
             --mesh 1x2 --config CleverRec.properties

Rank 0 alone logs, checkpoints and exports (the row-sharded tables are
gathered on every rank first).  A world of another size than D * M exits
2.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch.distributed as dist

from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.utils.logging import get_logger


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
                   help="device mesh shape over the process group's ranks, "
                        "e.g. 2x1 = 2-way data parallel, 1x2 = tables "
                        "row-sharded over 2 ranks (default: one device; "
                        "with --distributed: every rank on the data axis)")
    p.add_argument("--distributed", action="store_true",
                   help="initialise torch.distributed from the launcher's "
                        "environment (torchrun): NCCL on cuda:LOCAL_RANK, "
                        "gloo on one card with --device cuda:N, gloo with "
                        "--device cpu")
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


def _logger(cfg: Config, name: str, mesh=None):
    """The run's logger (``utils.logging.get_logger``); on a rank other
    than 0 of a mesh a silent one, so that rank 0 alone logs."""
    if mesh is not None and mesh.rank != 0:
        silent = logging.getLogger(f"cleverrec_tpu_torch.rank{mesh.rank}")
        silent.disabled = True
        return silent
    return get_logger(cfg.get("log.dir"), name)


def run_experiment(cfg: Config, device="cuda", logger=None,
                   resume_from=None, export_serving=None, mesh=None):
    """Load data, build the model and trainer, run the full loop (from
    the checkpoint ``resume_from`` if given; a ``model_type=rating`` run
    always starts afresh), then write a serving bundle to
    ``export_serving`` if given (not for rating); returns the trainer's
    best-epoch summary.  Under ``mesh`` (``parallel.Mesh``) the run is on
    the mesh's device, and rank 0 alone logs and exports."""
    from cleverrec_tpu_torch.data import load_ranking_data
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.train import Trainer

    if mesh is not None:
        device = mesh.device
    logger = logger or _logger(cfg, cfg.recommender, mesh)
    logger.info("=" * 80)
    logger.info("Current model: %s", cfg.recommender)
    if mesh is not None:
        logger.info("mesh: data=%d x model=%d", mesh.shape["data"],
                    mesh.shape["model"])
    if cfg.model_type == "rating":
        from cleverrec_tpu_torch.rating import run_rating
        return run_rating(cfg, logger, device=device, mesh=mesh)
    data = load_ranking_data(cfg, rng=np.random.default_rng(cfg.seed),
                             logger=logger)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device=device)
    trainer = Trainer(model, data, cfg, logger=logger, device=device,
                      mesh=mesh)
    best = trainer.run(resume_from=resume_from)
    if export_serving and mesh is not None:
        # Every rank joins the gather of the row blocks; rank 0 exports
        # the whole model.
        from cleverrec_tpu_torch.parallel.sharding import unshard_model
        unshard_model(model, mesh)
    if export_serving and (mesh is None or mesh.rank == 0):
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
    try:
        try:
            mesh = _mesh(args, cfg)
        except (RuntimeError, ValueError) as e:
            print(f"cleverrec-tpu-torch: {e}", file=sys.stderr)
            return 2
        return _run(args, cfg, mesh)
    finally:
        if args.distributed and dist.is_initialized():
            dist.destroy_process_group()


def _mesh(args, cfg: Config):
    """The run's mesh from --distributed and --mesh (None without
    either).  A world of another size than D * M raises."""
    from cleverrec_tpu_torch.parallel import init_distributed, make_mesh
    from cleverrec_tpu_torch.parallel.mesh import world
    if not (args.mesh or args.distributed):
        return None
    shape = (None, None)
    if args.mesh:
        try:
            shape = tuple(int(x) for x in args.mesh.lower().split("x"))
            if len(shape) != 2:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"--mesh {args.mesh!r}: want DxM, e.g. 2x1") from None
    device = init_distributed(args.device) if args.distributed \
        else args.device
    n = world()[0]
    if args.mesh and shape[0] * shape[1] != n:
        raise ValueError(
            f"--mesh {args.mesh} needs {shape[0] * shape[1]} ranks, the "
            f"world has {n} (launch with torchrun --nproc-per-node "
            f"{shape[0] * shape[1]} ... --distributed)")
    return make_mesh(*shape, device=device)


def _run(args, cfg: Config, mesh) -> int:
    device = args.device if mesh is None else mesh.device
    # --tune and a rating run ignore --resume and --export-serving, as the
    # JAX CLI does.
    if args.tune:
        from cleverrec_tpu_torch.tuning import run_grid
        logger = _logger(cfg, cfg.recommender + "_tune", mesh)
        if args.resume or args.export_serving:
            logger.info("--resume/--export-serving are ignored with --tune")
        run_grid(cfg, logger=logger, device=device, mesh=mesh)
        return 0
    if cfg.model_type == "rating":
        # The JAX CLI returns from a rating run before it reads these.
        logger = _logger(cfg, cfg.recommender, mesh)
        if args.resume or args.export_serving:
            logger.info("--resume/--export-serving are ignored with "
                        "model_type=rating")
        run_experiment(cfg, device=device, logger=logger, mesh=mesh)
        return 0
    run_experiment(cfg, device=device, resume_from=args.resume,
                   export_serving=args.export_serving, mesh=mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
