"""The port's data mesh over real collectives: one spawn of two gloo
processes on the CPU (``tests/torch_dist_worker.py``, which imports no
JAX), fed the JAX trainer's draws and initial states; then the port's CLI
under ``python -m torch.distributed.run``.

The ranks' replicas after a meshed epoch (the fused mesh-DP tier for BPR
with K 0 and 2 and for GMF, the scan tier's local Adam for BPR) must be
equal bit for bit and equal the serial oracle of tests/torch_dp_oracle.py
(which tests/test_torch_parallel.py holds to the JAX package's meshed
epochs); the ranks' own draws must be equal; ``full_sharded`` evaluation
must equal the unmeshed evaluator, and ``rank_sharded`` on a ``2 x 1``
and a ``1 x 2`` mesh ``rank_dense``.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.parallel import Mesh
from cleverrec_tpu_torch.ranking import rank_dense
from cleverrec_tpu_torch.train import Trainer
from tests.test_torch_parallel import (ATOL, LOSS_RTOL, RTOL, _host,
                                       _jax_trainer, _jcfg, _load,
                                       _raw_draw)
from tests.test_torch_parallel import toys  # noqa: F401 (a fixture)
from tests.torch_dp_oracle import fused_oracle, scan_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
# Metrics of the same parameters, sharded against dense ranking.
METRIC_TOL = 1e-6
# (case, model, its overrides, K, combine): the epochs the ranks train on
# the JAX trainer's draws.
CASES = [("bpr_k0", "BPR", {}, 0, "mean"),
         ("bpr_k2", "BPR", {}, 2, "count"),
         ("gmf", "GMF", {}, 0, "mean"),
         ("scan", "BPR", {"train.fused_kernel": "False",
                          "train.dp_local_adam": "True"}, 2, "sum")]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}


def _case_cfg(toys, model, extra, k, combine):
    return _jcfg(toys, model, **{**extra, "train.dp_sync_every": str(k),
                                 "train.dp_delta_combine": combine})


@pytest.fixture(scope="module")
def ranks(toys, tmp_path_factory):
    """The spec (each case's config, JAX's initial state and draw), the
    two ranks' outputs, and each case's inputs for the oracles."""
    out_dir = tmp_path_factory.mktemp("dist")
    spec, cases, inputs = {}, [], {}
    for name, model, extra, k, combine in CASES:
        jcfg = _case_cfg(toys, model, extra, k, combine)
        tr = _jax_trainer(jcfg, 2)
        p0, o0 = tr.init_state()
        init = _host((p0, o0))
        key = jax.random.PRNGKey(7)
        if "train.dp_local_adam" in extra:
            batch, _ = tr._scan_parts[0](key, tr.arrays)
            draw = {n: torch.as_tensor(np.array(v)) for n, v in batch.items()}
        else:
            steps = jax.tree_util.tree_leaves(
                tr._fused_parts[0](key, tr.arrays))[0].shape[0]
            draw = _raw_draw(tr, key, steps)
        inputs[name] = (jcfg, init, draw, k, combine)
        cases.append({"name": name, "kind": "train",
                      "cfg": jcfg.to_dict()})
        for part, t in (("p", init[0]), ("mu", init[1][0].mu),
                        ("nu", init[1][0].nu)):
            for leaf, x in t.items():
                spec[f"{name}/{part}/{leaf}"] = np.asarray(x)
        spec[f"{name}/count"] = np.int64(init[1][0].count)
        for col, x in draw.items():
            spec[f"{name}/draw/{col}"] = x.numpy()
    eval_cfg = _jcfg(toys, "BPR", **{"data.split_way": "rs",
                                     "test.neg_samples": "0"})
    cases.append({"name": "eval", "kind": "eval", "cfg": eval_cfg.to_dict()})
    spec["cases"] = np.array(json.dumps(cases))
    spec_path = str(out_dir / "spec.npz")
    np.savez(spec_path, **spec)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(port), spec_path,
         str(out_dir)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    outs = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2)]
    return {"outs": outs, "inputs": inputs, "eval_cfg": eval_cfg}


def _port_trainer(jcfg, mesh):
    cfg = Config(jcfg.to_dict())
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return model, data, Trainer(model, data, cfg, device="cpu", mesh=mesh)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_ranks_equal_each_other_and_the_serial_oracle(ranks, case):
    """One meshed epoch on JAX's draw: the two ranks' parameters, moments,
    count and loss equal bit for bit, and equal the serial oracle of the
    same pieces (within 1e-5 + 1e-3 |x|, the loss 1e-5 relative, the
    count exactly)."""
    r0, r1 = ranks["outs"]
    keys = [k for k in r0 if k.startswith(f"{case}/")]
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    jcfg, init, draw, k, combine = ranks["inputs"][case]
    model, _, trainer = _port_trainer(jcfg, Mesh(2, 1, "cpu"))
    assert str(r0[f"{case}/tier"]) == trainer.tier
    params, state = _load(model, *init)
    oracle = scan_oracle if trainer.tier == "scan_local_adam" \
        else fused_oracle
    loss = oracle(trainer, params, state, draw, 2, k, combine)
    assert int(r0[f"{case}/count"]) == state.count
    assert float(r0[f"{case}/loss"]) == pytest.approx(loss, rel=LOSS_RTOL)
    for part, t in (("p", params), ("mu", state.mu), ("nu", state.nu)):
        for leaf, x in t.items():
            np.testing.assert_allclose(r0[f"{case}/{part}/{leaf}"],
                                       x.detach().numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{part}/{leaf}")


def test_ranks_draw_equal_epochs_and_evaluate_full_sharded(ranks):
    """Each rank samples the whole epoch from its own generator of one
    seed: equal draws; after a fused mesh-DP epoch on them the replicas
    are equal, and the full_sharded evaluation equals the unmeshed
    evaluator's on the same parameters."""
    r0, r1 = ranks["outs"]
    assert str(r0["eval/draw_digest"]) == str(r1["eval/draw_digest"])
    for k in r0:
        if k.startswith("eval/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert str(r0["eval/mode"]) == "full_sharded"
    assert str(r0["eval/tier"]) == "fused"
    model, data, trainer = _port_trainer(ranks["eval_cfg"], None)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.as_tensor(r0[f"eval/p/{name}"]))
    ev = Evaluator(model, trainer.dd, trainer.cfg, device="cpu")
    assert ev.mode == "full"
    want = ev.evaluate(trainer.aux)
    np.testing.assert_allclose(r0["eval/metrics"],
                               np.array([want[k] for k in sorted(want)]),
                               rtol=0, atol=METRIC_TOL)


def test_rank_sharded_equals_rank_dense(ranks):
    """rank_sharded on the 2 x 1 mesh (the model axis 1) and on a 1 x 2
    mesh (each rank's half of the item axis, the halves' top-k merged)
    gives rank_dense's values, and its ids wherever a value is finite
    (ties to the lowest item id)."""
    r0, r1 = ranks["outs"]
    model, data, trainer = _port_trainer(ranks["eval_cfg"], None)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.as_tensor(r0[f"eval/p/{name}"]))
    users = torch.as_tensor(trainer.dd.test_users[:8]).long()
    rows = torch.as_tensor(trainer.dd.seen.rows[users.numpy()]).long()
    v, ids = rank_dense(model, trainer.aux, users, rows, 10)
    finite = torch.isfinite(v).numpy()
    for tag in ("2x1", "1x2"):
        got_v = r0[f"eval/sharded_{tag}/values"]
        np.testing.assert_array_equal(got_v, v.numpy(), err_msg=tag)
        np.testing.assert_array_equal(
            r0[f"eval/sharded_{tag}/ids"][finite], ids.numpy()[finite],
            err_msg=tag)


def test_cli_trains_under_torch_distributed_run(toys, tmp_path):
    """python -m torch.distributed.run --nproc-per-node 2 ... --distributed
    --mesh 2x1 --device cpu: two BPR epochs on the fused mesh-DP tier
    exit 0, and rank 0 alone logs (each epoch and the summary once)."""
    toy = toys["toy"]
    argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
            "--nproc-per-node", "2", "--master-addr", "localhost",
            "--master-port", str(_free_port()), "-m",
            "cleverrec_tpu_torch.cli", "--distributed", "--mesh", "2x1",
            "--device", "cpu", "--config",
            os.path.join(REPO, "CleverRec.properties"), "--conf-dir",
            os.path.join(REPO, "conf"), "--model", "BPR"]
    for k, v in {"data.root_dir": toy["root"], "data.dataset": toy["name"],
                 "data.file_name": "ratings.csv", "data.sep": ",",
                 "epoches": "2", "batch_size": "64", "embed_size": "16",
                 "test.neg_samples": "10", "train.fused_kernel": "True",
                 "log.dir": str(tmp_path)}.items():
        argv += ["--set", f"{k}={v}"]
    run = subprocess.run(argv, cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=240)
    assert run.returncode == 0, run.stdout + run.stderr
    log = (tmp_path / "BPR.log").read_text()
    assert log.count("mesh: data=2 x model=1") == 1
    assert log.count("mesh 2x1: the fused tier, each rank") == 1
    assert log.count(" epoch 1\n") == log.count(" epoch 2\n") == 1
    assert log.count("best_epoch: ") == 1
