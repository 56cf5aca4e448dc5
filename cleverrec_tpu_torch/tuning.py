"""Hyperparameter grid search, the reference's ``main_tuning.py`` (as
``cleverrec_tpu/tuning.py``), for the ranking and the rating models.

The data is loaded once; each combination trains a fresh model and
trainer.  Any list-valued config key is a grid axis: pass the axes as
``grid={"embed_size": [64, 128], "reg": [0.1, 0.01]}`` or let
``grid_from_config`` read the reference's three.  Combinations run in
the order of ``itertools.product`` over the sorted axis names.
"""

from __future__ import annotations

import itertools
from typing import Any, Mapping, Sequence

import numpy as np

from cleverrec_tpu_torch.config import Config, _parse_list


def grid_from_config(cfg: Config) -> dict[str, list]:
    """The reference's grid axes, embed_size, reg and neg_ratio
    (main_tuning.py:39-46), where the config gives a list ([a,b,c])."""
    grid = {}
    for key, cast in (("embed_size", int), ("reg", float),
                      ("neg_ratio", int)):
        raw = cfg.get(key)
        if raw is None:
            continue
        s = str(raw)
        if "," in s or s.strip().startswith("["):
            grid[key] = _parse_list(raw, cast)
    return grid


def run_grid(cfg: Config, grid: Mapping[str, Sequence[Any]] | None = None,
             logger=None, device="cuda", mesh=None):
    """Train every combination; returns (best, all_results), the best by
    NDCG@topk[0] for a ranking model (the reference's criterion) or by the
    lowest RMSE for a rating model (FM, FFM).  Each result is
    ``{"params": {axis: value}, "best": the trainer's run() summary}``.
    ``mesh`` goes to every trial's trainer (on the mesh's device: a
    ``mesh`` overrides ``device``)."""
    if mesh is not None:
        device = mesh.device
    from cleverrec_tpu_torch.data import load_ranking_data
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.train import Trainer

    grid = dict(grid) if grid else grid_from_config(cfg)
    if not grid:
        raise ValueError("no grid axes: pass grid= or list-valued config")
    log = logger.info if logger else (lambda *a: None)
    keys = sorted(grid)
    combos = list(itertools.product(*(grid[k] for k in keys)))

    results = []
    if cfg.model_type == "rating":
        from cleverrec_tpu_torch.data.libfm import load_rating_data
        from cleverrec_tpu_torch.rating import FMTrainer, make_rating_model
        data = load_rating_data(cfg)              # preprocess once
        for combo in combos:
            overrides = {k: str(v) for k, v in zip(keys, combo)}
            trial_cfg = cfg.with_overrides(**overrides)
            log("== trial %s", overrides)
            model = make_rating_model(trial_cfg, data)
            best = FMTrainer(model, data, trial_cfg, logger=logger,
                             device=device, mesh=mesh).run()
            results.append({"params": dict(zip(keys, combo)), "best": best})
        top = min(results, key=lambda r: r["best"]["rmse"])
        log("== best trial: %s -> RMSE=%.4f", top["params"],
            top["best"]["rmse"])
        return top, results

    # Preprocess once (main_tuning.py:33-36).
    base = cfg.with_overrides(**{k: str(v[0]) for k, v in grid.items()})
    data = load_ranking_data(base, rng=np.random.default_rng(cfg.seed),
                             logger=logger)
    meta = DataMeta(data.user_nums, data.item_nums)
    for combo in combos:
        overrides = {k: str(v) for k, v in zip(keys, combo)}
        trial_cfg = cfg.with_overrides(**overrides)
        log("== trial %s", overrides)
        model = make_model(trial_cfg, meta, device=device)
        best = Trainer(model, data, trial_cfg, logger=logger,
                       device=device, mesh=mesh).run()
        results.append({"params": dict(zip(keys, combo)), "best": best})
    top = max(results, key=lambda r: r["best"]["ndcg"])
    log("== best trial: %s -> NDCG=%.4f", top["params"], top["best"]["ndcg"])
    return top, results
