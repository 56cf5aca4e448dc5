"""One rank of tests/test_torch_distributed.py's 2-process gloo mesh on the
CPU.  It imports no JAX: the test hands it the JAX trainer's draws and
initial states in an .npz.

    python tests/torch_dist_worker.py RANK WORLD PORT SPEC.npz OUT_DIR

SPEC.npz holds ``cases`` (JSON: each case's ``name``, ``kind`` and
config) and, for a case trained on given draws, ``<name>/{p,mu,nu}/<leaf>``,
``<name>/count`` and ``<name>/draw/<column>``.  On a ``2 x 1`` mesh the
rank trains each such case one epoch through ``Trainer._run_epoch``
(the fused mesh-DP tier or the scan tier's local Adam, as the config
says); for the ``eval`` case it samples its own epoch (``draw_digest``:
a digest of every column), trains it and evaluates (``full_sharded``),
then ranks 8 test users through ``rank_sharded`` on the ``2 x 1`` mesh
and on a ``1 x 2`` one.  It writes ``OUT_DIR/rank<R>.npz``.
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from cleverrec_tpu_torch.common import AdamState
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.parallel import make_mesh
from cleverrec_tpu_torch.ranking import rank_sharded
from cleverrec_tpu_torch.train import Trainer


def digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].cpu().numpy().tobytes())
    return h.hexdigest()


def state_out(out, name, params, state, loss):
    for part, t in (("p", params), ("mu", state.mu), ("nu", state.nu)):
        for leaf, x in t.items():
            out[f"{name}/{part}/{leaf}"] = x.detach().numpy().copy()
    out[f"{name}/count"] = np.int64(state.count)
    out[f"{name}/loss"] = np.float64(loss)


def main(rank: int, world: int, port: int, spec_path: str,
         out_dir: str) -> int:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    spec = np.load(spec_path)
    mesh = make_mesh(world, 1, "cpu")
    out = {}
    for case in json.loads(str(spec["cases"])):
        name, cfg = case["name"], Config(case["cfg"])
        data = load_ranking_data(cfg)
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                           device="cpu")
        trainer = Trainer(model, data, cfg, mesh=mesh)
        out[f"{name}/tier"] = np.array(trainer.tier)
        params, state = trainer.init_state()
        if case["kind"] == "eval":
            draw = trainer.sample_epoch()
            out[f"{name}/draw_digest"] = np.array(digest(draw))
            params, state, loss = trainer._run_epoch(params, state, draw)
            state_out(out, name, params, state, float(loss))
            out[f"{name}/mode"] = np.array(trainer.evaluator.mode)
            metrics = trainer.evaluate()
            out[f"{name}/metrics"] = np.array(
                [metrics[k] for k in sorted(metrics)])
            users = torch.as_tensor(trainer.dd.test_users[:8]).long()
            rows = torch.as_tensor(trainer.dd.seen.rows[users.numpy()]).long()
            for tag, m in (("2x1", mesh), ("1x2", make_mesh(1, world, "cpu"))):
                v, ids = rank_sharded(model, trainer.aux, users, rows, 10, m)
                out[f"{name}/sharded_{tag}/values"] = v.numpy()
                out[f"{name}/sharded_{tag}/ids"] = ids.numpy()
            continue
        with torch.no_grad():
            for part, t in (("p", params), ("mu", state.mu),
                            ("nu", state.nu)):
                for leaf, x in t.items():
                    x.detach().copy_(torch.as_tensor(
                        spec[f"{name}/{part}/{leaf}"]))
        state = AdamState(int(spec[f"{name}/count"]), state.mu, state.nu)
        draw = {k.split("/")[-1]: torch.as_tensor(spec[k])
                for k in spec.files if k.startswith(f"{name}/draw/")}
        params, state, loss = trainer._run_epoch(params, state, draw)
        state_out(out, name, params, state, float(loss))
    assert "jax" not in sys.modules
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4], sys.argv[5]))
