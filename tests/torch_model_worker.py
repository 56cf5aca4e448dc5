"""One rank of tests/test_torch_model_axis.py's gloo meshes on the CPU
(``1 x 2``, ``2 x 1`` or ``2 x 2``).  It imports no JAX: the test hands it
the JAX trainer's draws and initial states in an .npz.

    python tests/torch_model_worker.py RANK D M PORT SPEC.npz OUT_DIR

SPEC.npz holds ``cases`` (JSON: each case's ``name``, ``kind`` and
config) and the arrays of each case under ``<name>/...``.  Kinds:

- ``epoch``: one epoch of a ranking trainer on the mesh from the given
  parameters (``<name>/p/<leaf>``, whole) on the given draw
  (``<name>/draw/<column>``), through ``train_epoch`` (so ``pre_epoch``
  runs); out: the parameters and optimizer state gathered whole, the
  loss, the tier, the rank's bytes of each leaf and moment, the
  row-sharded names, what the data ranks did with each step (the
  trainer's ``_data_mode``) and the evaluation after the epoch;
- ``fm_epoch``: one ``FMTrainer.train_epoch`` on the given order and
  weights from the given parameters; ``fm_run``: a whole ``run()``;
- ``gather``: ``row_sharded_gather`` of the rank's rows of ``table`` by
  ``ids`` (and, with the data axis, its data-axis form), its value and
  the gradient of sum(rows * cot) joined whole;
- ``step``: one ``sharded_train_step`` on the given batch (the sampler's
  ``pairwise_batch`` returns it);
- ``run``: ``Trainer.run()`` (the config sets ``save.best``,
  ``saved_dir`` and ``profile.dir``), the evaluation of the final
  parameters, then ``resume`` of the checkpoint, held to the file's rows;
- ``eval``: the evaluation of a fresh draw;
- ``agree``: one epoch of a whole-step tier (grouped pairwise, bucketed,
  dual) from the trainer's own seed and draw, rank 1's gradients nudged
  by ``NUDGE`` (``torch.autograd.grad`` wrapped); with ``apart``, the
  data ranks' agreement (``sharding.over_data``) taken out on every
  rank.

It writes ``OUT_DIR/rank<R>.npz``.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from cleverrec_tpu_torch import sampling
from cleverrec_tpu_torch.common import AdagradState, make_optimizer
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.data.libfm import load_rating_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.parallel import make_mesh, sharding
from cleverrec_tpu_torch.rating import FMTrainer, make_rating_model
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  map_optimizer_state)

# What rank 1 adds to every gradient element in an ``agree`` case.
NUDGE = 1e-7


def arrays_of(spec, prefix):
    return {k[len(prefix):]: spec[k] for k in spec.files
            if k.startswith(prefix)}


def set_local(model, params, whole, mesh):
    """This rank's rows of ``whole`` ({leaf: numpy}) into ``params``."""
    shards = sharding.shards_of(model)
    local = sharding.local_tensors(
        {k: torch.as_tensor(v) for k, v in whole.items()}, shards, mesh)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(local[k])


def moments(state):
    if isinstance(state, AdagradState):
        return {"acc": state.sum_of_squares}
    return {"mu": state.mu, "nu": state.nu}


def state_out(out, name, model, params, state, mesh):
    shards = sharding.shards_of(model)
    for k, v in sharding.full_tensors(params, shards, mesh).items():
        out[f"{name}/p/{k}"] = v.detach().numpy().copy()
    whole = map_optimizer_state(
        state, lambda t: sharding.full_tensors(t, shards, mesh))
    for part, t in moments(whole).items():
        for k, v in t.items():
            out[f"{name}/{part}/{k}"] = v.numpy().copy()
    for part, t in (("p", params), *moments(state).items()):
        for k, v in t.items():
            out[f"{name}/bytes/{part}/{k}"] = np.int64(
                v.numel() * v.element_size())
    out[f"{name}/shards"] = np.array(json.dumps(sorted(shards)))


def ranking(cfg, mesh):
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return model, Trainer(model, data, cfg, mesh=mesh)


def epoch_case(out, name, cfg, spec, mesh):
    model, trainer = ranking(cfg, mesh)
    params, state = trainer.init_state()
    set_local(model, params, arrays_of(spec, f"{name}/p/"), mesh)
    draw = {k: torch.as_tensor(v)
            for k, v in arrays_of(spec, f"{name}/draw/").items()}
    trainer.sample_epoch = lambda: draw
    params, state, loss = trainer.train_epoch(params, state)
    state_out(out, name, model, params, state, mesh)
    out[f"{name}/loss"] = np.float64(loss)
    out[f"{name}/tier"] = np.array(trainer.tier)
    out[f"{name}/data_mode"] = np.array(str(trainer._data_mode))
    out[f"{name}/metrics"] = np.array(json.dumps(
        {str(k): v for k, v in trainer.evaluate().items()}))


def fm_trainer(cfg, mesh):
    data = load_rating_data(cfg)
    return FMTrainer(make_rating_model(cfg, data), data, cfg, mesh=mesh)


def fm_epoch_case(out, name, cfg, spec, mesh):
    trainer = fm_trainer(cfg, mesh)
    params, state = trainer.init_state()
    set_local(trainer.model, params, arrays_of(spec, f"{name}/p/"), mesh)
    params, state, loss, *_ = trainer.train_epoch(
        params, state, spec[f"{name}/order"], spec[f"{name}/w"])
    state_out(out, name, trainer.model, params, state, mesh)
    out[f"{name}/loss"] = np.float64(loss)


def gather_case(out, name, spec, mesh):
    table = torch.as_tensor(spec[f"{name}/table"])
    ids = torch.as_tensor(spec[f"{name}/ids"])
    cot = torch.as_tensor(spec[f"{name}/cot"])
    forms = [("model", None)]
    if mesh.shape["data"] > 1:
        forms.append(("data", "data"))
    for tag, data_axis in forms:
        # JAX's data-axis form takes as many ids as divide over 'data'.
        n = len(ids) - len(ids) % mesh.shape["data"] if data_axis else None
        shard = sharding.shard_rows(table, mesh).clone().requires_grad_()
        rows = sharding.row_sharded_gather(shard, ids[:n], mesh,
                                           data_axis=data_axis)
        (grad,) = torch.autograd.grad((rows * cot[:n]).sum(), [shard])
        out[f"{name}/{tag}/rows"] = rows.detach().numpy()
        out[f"{name}/{tag}/grad"] = mesh.all_gather(grad, "model").numpy()


def step_case(out, name, cfg, spec, mesh):
    model, trainer = ranking(cfg, mesh)
    params, state = trainer.init_state()
    set_local(model, params, arrays_of(spec, f"{name}/p/"), mesh)
    batch = {k: torch.as_tensor(v)
             for k, v in arrays_of(spec, f"{name}/batch/").items()}
    rows = torch.as_tensor(spec[f"{name}/rows"])
    valid = torch.as_tensor(spec[f"{name}/valid"])

    def given(gen, r, v, *args, **kwargs):
        assert torch.equal(r, rows) and torch.equal(v, valid)
        return dict(batch)

    sampling.pairwise_batch = given
    arrays = {"pos_u": trainer.aux["pos_u"], "pos_i": trainer.aux["pos_i"],
              "seen": trainer._seen_table()}
    step = sharding.sharded_train_step(
        model, make_optimizer(cfg.optimizer, cfg.lr), mesh,
        trainer.dd.item_nums, cfg.neg_ratio, cfg.str("parallel.exchange",
                                                     "gspmd"))
    params, state, loss = step(params, state, trainer._gen, arrays, rows,
                               valid)
    state_out(out, name, model, params, state, mesh)
    out[f"{name}/loss"] = np.float64(loss)


def run_case(out, name, cfg, mesh):
    model, trainer = ranking(cfg, mesh)
    best = trainer.run()
    out[f"{name}/best_epoch"] = np.int64(best["epoch"])
    state_out(out, name, model, trainer.params, trainer.opt_state, mesh)
    out[f"{name}/metrics"] = np.array(json.dumps(
        {str(k): v for k, v in trainer.evaluate().items()}))
    out[f"{name}/mode"] = np.array(trainer.evaluator.mode)
    dist.barrier()
    path = os.path.join(cfg.str("saved_dir"), model.name)
    params, state, epoch = trainer.resume(path)
    saved = load_checkpoint(path)
    shards = model.row_shards
    want = [(params, saved["params"])] + [
        (getattr(state, part), saved["opt_state"][part])
        for part in ("mu", "nu")]
    out[f"{name}/resumed_equal"] = np.bool_(all(
        torch.equal(got[k], w) for got, whole in want
        for k, w in sharding.local_tensors(whole, shards, mesh).items()))
    out[f"{name}/resumed_epoch"] = np.int64(epoch)


def agree_case(out, name, cfg, mesh, apart):
    model, trainer = ranking(cfg, mesh)
    params, state = trainer.init_state()
    grad, agree = torch.autograd.grad, sharding.over_data

    def nudged(*args, **kwargs):
        return tuple(None if g is None else g + NUDGE
                     for g in grad(*args, **kwargs))

    if mesh.index("data") == 1:
        torch.autograd.grad = nudged
    if apart:
        sharding.over_data = lambda grads, loss, *_, **__: (grads, loss)
    try:
        params, state, loss = trainer.train_epoch(params, state)
    finally:
        torch.autograd.grad, sharding.over_data = grad, agree
    state_out(out, name, model, params, state, mesh)
    out[f"{name}/loss"] = np.float64(loss)
    out[f"{name}/tier"] = np.array(trainer.tier)
    out[f"{name}/data_mode"] = np.array(str(trainer._data_mode))


def main(rank, d, m, port, spec_path, out_dir) -> int:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=d * m, rank=rank)
    spec = np.load(spec_path)
    mesh = make_mesh(d, m, "cpu")
    out = {}
    for case in json.loads(str(spec["cases"])):
        name, kind = case["name"], case["kind"]
        cfg = Config(case["cfg"]) if "cfg" in case else None
        if kind == "epoch":
            epoch_case(out, name, cfg, spec, mesh)
        elif kind == "fm_epoch":
            fm_epoch_case(out, name, cfg, spec, mesh)
        elif kind == "fm_run":
            best = fm_trainer(cfg, mesh).run()
            out[f"{name}/rmse"] = np.float64(best["rmse"])
        elif kind == "gather":
            gather_case(out, name, spec, mesh)
        elif kind == "step":
            step_case(out, name, cfg, spec, mesh)
        elif kind == "eval":
            model, trainer = ranking(cfg, mesh)
            params, state = trainer.init_state()
            state_out(out, name, model, params, state, mesh)
            out[f"{name}/metrics"] = np.array(json.dumps(
                {str(k): v for k, v in trainer.evaluate().items()}))
            out[f"{name}/mode"] = np.array(trainer.evaluator.mode)
        elif kind == "run":
            run_case(out, name, cfg, mesh)
        elif kind == "agree":
            agree_case(out, name, cfg, mesh, case["apart"])
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    assert "jax" not in sys.modules
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                  int(sys.argv[4]), sys.argv[5], sys.argv[6]))
