"""Does the port's MLP follow the JAX package's from one seed?

    JAX_PLATFORMS=cpu python tests/mlp_seed_parity.py [--seed 1]
        [--epochs 10] [--model MLP]

(on the CPU; a script beside the tests, not collected by pytest: ten
epochs at the conf's width take minutes).  Builds ``--model``'s recipe
(CleverRec.properties and its conf) on ``chip_smoke.py``'s rebuilt
ml-100k in both packages, starts the port from the JAX trainer's
parameters at ``--seed``, and each epoch draws the JAX trainer's own
epoch key (as its CLI's run does) and its scan tier's batches from it,
trains the JAX epoch and the port's ``Trainer._run_epoch`` on those
batches, and evaluates both.  Prints one JSON line an epoch: both
losses, both HR@10 and NDCG@10, and the largest parameter difference.
Where the port follows JAX epoch by epoch, a run of the port that does
not learn at that seed is the draw's doing, not the port's.  With
``--control`` a second JAX trainer, started from the same parameters
each nudged by one f32 ulp toward zero, trains on the same batches
beside them (``control_*`` and its own parameter gap): how far two runs
part from f32 rounding alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cleverrec_tpu.config import Config as JConfig  # noqa: E402
from cleverrec_tpu.data import load_ranking_data as j_load  # noqa: E402
from cleverrec_tpu.models import make_model as j_make_model  # noqa: E402
from cleverrec_tpu.models.base import DataMeta as JMeta  # noqa: E402
from cleverrec_tpu.train import Trainer as JTrainer  # noqa: E402
from cleverrec_tpu_torch.config import Config  # noqa: E402
from cleverrec_tpu_torch.data import load_ranking_data  # noqa: E402
from cleverrec_tpu_torch.models import make_model  # noqa: E402
from cleverrec_tpu_torch.models.base import DataMeta  # noqa: E402
from cleverrec_tpu_torch.train import Trainer  # noqa: E402
from cleverrec_tpu_torch.weights import load_params  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--model", default="MLP")
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args()
    import chip_smoke
    chip_smoke.write_ml100k()
    values = {"recommender": args.model, "seed": str(args.seed),
              "data.root_dir": chip_smoke.DATA, "data.dataset": "ml-100k",
              "data.file_name": "ratings.csv", "data.sep": ",",
              "train.fused_kernel": "False"}
    paths = (os.path.join(ROOT, "CleverRec.properties"),
             os.path.join(ROOT, "conf"))
    jcfg = JConfig.from_properties(*paths, values)
    cfg = Config.from_properties(*paths, values)
    jdata, data = j_load(jcfg), load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    j_tr = JTrainer(jmodel, jdata, jcfg)
    build_xs = j_tr._scan_parts[0]
    params, state = j_tr.init_state()
    trainer = Trainer(model, data, cfg, device="cpu")
    trainer.init_state()
    load_params(model, {k: np.asarray(v) for k, v in params.items()})
    t_params = dict(model.named_parameters())
    t_state = trainer.optimizer.init(t_params)
    control = None
    if args.control:
        c_tr = JTrainer(jmodel, jdata, jcfg)
        c_params, c_state = c_tr.init_state()
        c_params = {k: jax.numpy.asarray(np.nextafter(
            np.asarray(v), np.float32(0))) for k, v in c_params.items()}
        control = [c_tr, c_params, c_state]
    for epoch in range(1, args.epochs + 1):
        j_tr._loop_key, key = jax.random.split(j_tr._loop_key)
        batch, _ = build_xs(key, j_tr.arrays)
        tensors = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
        params, state, loss = j_tr._epoch_body(params, state, key,
                                               j_tr.arrays)
        params = {k: np.asarray(v) for k, v in params.items()}
        t_params, t_state, t_loss = trainer._run_epoch(t_params, t_state,
                                                       tensors)
        gap = max(float(np.abs(t_params[k].detach().numpy() - v).max())
                  for k, v in params.items())
        want, got = j_tr.evaluate(params), trainer.evaluate()
        line = {
            "epoch": epoch, "jax_loss": float(loss), "port_loss": float(t_loss),
            "jax_hr10": float(want[10][0]), "port_hr10": float(got[10][0]),
            "jax_ndcg10": float(want[10][2]), "port_ndcg10": float(got[10][2]),
            "max_param_gap": gap}
        if control:
            c_tr, c_params, c_state = control
            c_params, c_state, c_loss = c_tr._epoch_body(
                c_params, c_state, key, c_tr.arrays)
            c_params = {k: np.asarray(v) for k, v in c_params.items()}
            control[1:] = [c_params, c_state]
            line.update(control_loss=float(c_loss),
                        control_hr10=float(c_tr.evaluate(c_params)[10][0]),
                        control_param_gap=max(
                            float(np.abs(c_params[k] - v).max())
                            for k, v in params.items()))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
