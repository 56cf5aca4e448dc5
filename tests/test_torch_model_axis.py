"""The model axis of the parallel layer, and the scan tier's batch split
over ``data``, in the port against the JAX package: row-sharded tables
and split batches over real gloo collectives on the CPU.

One spawn each of a ``1 x 2``, a ``2 x 1`` and a ``2 x 2`` world
(``tests/torch_model_worker.py``, which imports no JAX) train one epoch
of each case from the JAX trainer's initial state on the JAX trainer's
own draws (its scan tier's ``_scan_parts``, its grouped and dual draws),
and the JAX trainer's meshed epoch on ``make_mesh(1, 2)``,
``make_mesh(2, 1)`` and ``make_mesh(2, 2)`` of the 8 virtual CPU devices
(``tests/conftest.py``) is the reference, at ``tests/test_parallel.py``'s
tolerances.  Beside it: the ranks equal each other bit for bit; at a
data axis of 1 the ``gspmd`` tier equals the port's unmeshed epoch bit
for bit and the ``explicit`` tier within ``EXCHANGE_TOL``, and at 2 the
split scan tier within ``TOL`` (its parts sum the rows in another
order); each rank holds 1/M of every row-sharded table and its moments;
FM and FFM; ``row_sharded_gather`` and ``sharded_train_step`` against
JAX's; a ``1 x 2`` run's checkpoint, evaluation and traces; on ``2 x 1``
the whole-step tiers' one gradient, rank 1's nudged.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu import rating as j_rating
from cleverrec_tpu import sampling as j_sampling
from cleverrec_tpu.config import Config as JConfig
from cleverrec_tpu.data.libfm import load_rating_data as j_load_rating_data
from cleverrec_tpu.parallel.mesh import make_mesh as j_make_mesh
from cleverrec_tpu.parallel.sharding import \
    pad_table_for_sharding as j_pad_table_for_sharding
from cleverrec_tpu.parallel.sharding import \
    param_sharding_tree as j_param_sharding_tree
from cleverrec_tpu.parallel.sharding import \
    row_sharded_gather as j_row_sharded_gather
from cleverrec_tpu.parallel.sharding import \
    sharded_train_step as j_sharded_train_step
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.data.libfm import load_rating_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.parallel import (Mesh, param_sharding_tree,
                                          replicate, shard_batch_spec,
                                          shard_params)
from cleverrec_tpu_torch.rating import FMTrainer, make_rating_model
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.checkpoint import load_checkpoint
from cleverrec_tpu_torch.weights import load_params
from tests.conftest import base_config, make_toy_interactions
from tests.test_torch_graph import _dual_draws
from tests.test_torch_parallel import _host
from tests.test_torch_samn import _jax_grouped_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_model_worker.py")
# tests/test_parallel.py's tolerances, meshed against unmeshed: the
# parameters and moments, the loss relative; the hard models' twice.
RTOL, ATOL, LOSS_RTOL = 1e-4, 1e-5, 1e-4
TOL = {"plain": (RTOL, ATOL, LOSS_RTOL), "hard": (2e-4, 2e-5, 2e-4)}
# The meshed evaluation against the unmeshed one on the same parameters.
METRIC_ATOL = 1e-6
# The explicit exchange against the port's unmeshed epoch: a row's
# duplicate gradients summed through embedding's backward where BPR's
# loss sums them through indexing's.
EXCHANGE_TOL = 1e-6
# row_sharded_gather against JAX's (tests/test_parallel.py:261-289).
GATHER_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-5, 1e-6
# tests/test_parallel.py's configs: BPR's (lr 0.05, batch 64, embed 16,
# neg_ratio 2) and HARD_MODELS' (embed 8, 10 test negatives).
BPR = {"epoches": "1", "batch_size": "64", "embed_size": "16",
       "lr": "0.05", "neg_ratio": "2", "loss_func": "bpr", "reg": "0.01"}
HARD = {"epoches": "1", "batch_size": "64", "embed_size": "8", "lr": "0.05",
        "neg_ratio": "2", "test.neg_samples": "10"}
EXPLICIT = {"parallel.exchange": "explicit"}
SPLIT = ("2x1", "2x2")
# (case, toy, model, overrides, the tier, its TOL, the meshes it runs
# on).
CASES = [
    ("BPR_gspmd", "toy", "BPR", {**BPR, "train.fused_kernel": "False"},
     "scan", "plain", ("1x2",) + SPLIT),
    # 31 users: P does not divide over 2 ranks (replicated; padded in the
    # exchange's view), Q does.
    ("BPR_explicit", "odd", "BPR", {**BPR, **EXPLICIT}, "scan", "plain",
     ("1x2",) + SPLIT),
    ("LightGCN", "toy", "LightGCN",
     {**HARD, "loss_func": "bpr", "reg": "0.0001", "n_layers": "2"},
     "scan", "hard", ("1x2",) + SPLIT),
    # SAMN's flat pairwise loss (its tower's L2 a table term).
    ("SAMN_scan", "toysoc", "SAMN",
     {**HARD, "loss_func": "bpr", "reg1": "0.01", "reg2": "0.01",
      "mem_size": "4", "atten_size": "4", "social_file": "trusts.csv",
      "train.grouped_pairs": "False"}, "scan", "hard", SPLIT),
    # social_weight 0: each package draws the friend edges from its own
    # generator (tests/test_torch_extra.py); EATNN_social draws them.
    ("EATNN", "toysoc", "EATNN",
     {**HARD, "loss_func": "bpr", "reg": "0.001", "social_weight": "0",
      "social_file": "trusts.csv"}, "scan", "hard", SPLIT),
    ("EATNN_social", "toysoc", "EATNN",
     {**HARD, "loss_func": "bpr", "reg": "0.001", "social_weight": "0.5",
      "social_file": "trusts.csv"}, "scan", "hard", ("2x1",)),
    ("SAMN", "toysoc", "SAMN",
     {**HARD, "loss_func": "bpr", "reg1": "0.01", "reg2": "0.01",
      "mem_size": "4", "atten_size": "4", "social_file": "trusts.csv"},
     "grouped_pairs", "hard", ("1x2",)),
    ("SoHRML", "toysoc", "SoHRML",
     {**HARD, "loss_func": "hinge", "margin": "0.5", "gamma": "0.1",
      "reg1": "0.01", "reg2": "0.001", "atten_size": "4", "att_type": "2",
      "mlp_type": "0", "gat_layer_nums": "2", "max_i": "0", "max_s": "0",
      "node_dropout": "0.0", "message_dropout": "0.0",
      "train_batches": "4", "adj_folds": "4", "social_file": "trusts.csv"},
     "dual", "hard", ("1x2",)),
    # att_type 1 as tests/test_torch_graph.py's dual epoch: att_type 2
    # drops its attention's pre-activations in training, from each
    # package's own generator.
    ("RML_DGATs", "toysoc", "RML_DGATs",
     {**HARD, "loss_func": "hinge", "margin": "0.25", "gamma": "0.05",
      "reg1": "0.01", "reg2": "0.001", "atten_size": "4", "att_type": "1",
      "mlp_type": "0", "max_i": "5", "max_s": "5", "train_batches": "4",
      "social_file": "trusts.csv"},
     "dual", "hard", ("1x2",)),
    # The exchange's full-table fallback: CML's covariance over the
    # whole tables (tests/test_parallel.py:181-198), a table term of the
    # split.
    ("CML_explicit", "toy", "CML",
     {**BPR, **EXPLICIT, "margin": "1.0", "reg": "0.1",
      "loss_func": "hinge"}, "scan", "plain", ("1x2",) + SPLIT),
]
# Cases held to the port's unmeshed epoch alone, on the JAX initial state
# and draw of the case named (JAX draws EATNN's edges from its own key).
PORT_ONLY = {"EATNN_social": "EATNN"}
FM_CASES = [("FM", ("1x2",) + SPLIT), ("FFM", ("1x2",))]
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
# The whole-step tiers on 2 x 1 (case, toy, model, overrides, its tier):
# one epoch from the port's own seed and draw, rank 1's gradients
# nudged; the ranks agree bit for bit, and equal the unmeshed epoch.
AGREE_CASES = [
    ("SoHRML", "toysoc", "SoHRML",
     {**HARD, "loss_func": "hinge", "margin": "0.5", "gamma": "0.1",
      "reg1": "0.01", "reg2": "0.001", "atten_size": "4", "att_type": "2",
      "mlp_type": "0", "gat_layer_nums": "2", "max_i": "0", "max_s": "0",
      "node_dropout": "0.1", "message_dropout": "0.1",
      "train_batches": "4", "social_file": "trusts.csv"}, "dual"),
    ("NAIS", "toy", "NAIS",
     {"epoches": "1", "embed_size": "8", "atten_size": "4", "beta": "0.5",
      "optimizer": "Adagrad", "is_pairwise": "False", "lr": "0.05",
      "loss_func": "cross_entropy", "batch_size": "256"}, "bucketed"),
]
# Full-catalog evaluation (a random split; the port's own, so held to
# the port's unmeshed evaluator).  The 1 x 2 run: BPR two epochs, saved
# at its best epoch, the second block traced; MLP evaluated fresh (no dot
# decomposition: its scores from the all-gathered tables).
FULL = {"data.split_way": "rs", "test.neg_samples": "0"}
RUN = {**BPR, **FULL, "epoches": "2", "save.best": "True"}
MLP = {**FULL, "embed_size": "8", "layers": "[16,8]",
       "is_pairwise": "False", "loss_func": "cross_entropy"}


def _np(x):
    return np.asarray(x)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    """The conftest toys (30 users, 40 items; 30 users with a trust graph),
    a toy of 31 users and a libFM toy."""
    root = tmp_path_factory.mktemp("model_axis")
    for name, users, rows in (("toy", 30, 400), ("odd", 31, 400),
                              ("toysoc", 30, 500)):
        (root / name).mkdir()
        make_toy_interactions(root / name / "ratings.csv", n_users=users,
                              n_rows=rows)
    r = np.random.default_rng(5)
    lines = ["u_id,v_id"]
    for u in range(30):
        for v in r.choice(30, size=r.integers(1, 5), replace=False):
            if v != u:
                lines.append(f"{u},{v}")
    (root / "toysoc" / "trusts.csv").write_text("\n".join(lines) + "\n")
    rng = np.random.default_rng(0)
    (root / "toyfm").mkdir()

    def gen(n):
        out = []
        for _ in range(n):
            u, i = rng.integers(8), rng.integers(16)
            out.append(f"{3.0 + 0.1 * u - 0.05 * i:.3f},{u}:1,{8 + i}:1")
        return "\n".join(out) + "\n"

    (root / "toyfm" / "toyfm.train.libfm").write_text(gen(512))
    (root / "toyfm" / "toyfm.test.libfm").write_text(gen(64))
    return str(root)


def _jcfg(root, toy, name, extra):
    return base_config({"root": root, "name": toy},
                       **{"recommender": name, **extra})


def _fm_cfg(root, name):
    """tests/test_parallel.py:221-238's FM config."""
    return JConfig({
        "recommender": name, "model_type": "rating", "data.root_dir": root,
        "data.dataset": "toyfm", "train": ".train.libfm",
        "test": ".test.libfm", "is_real_valued": "True", "epoches": "2",
        "batch_size": "128", "test.batch_size": "64", "embed_size": "4",
        "reg": "0.001", "lr": "0.05", "optimizer": "Adam",
        "loss_func": "square", "init_method": "normal", "stddev": "0.01",
        "seed": "3"})


def _j_mesh(tag):
    d, m = MESHES[tag]
    return j_make_mesh(d, m, devices=jax.devices()[:d * m])


def _jax_case(jcfg, tier, mesh_tag, key):
    """JAX's meshed epoch from its initial state on ``key``: (the initial
    parameters, the draw as the port's columns, the state after, the
    loss)."""
    from cleverrec_tpu.data import load_ranking_data as j_load
    from cleverrec_tpu.models import make_model as j_make_model
    from cleverrec_tpu.models.base import DataMeta as JMeta
    from cleverrec_tpu.train import Trainer as JTrainer
    jdata = j_load(jcfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    tr = JTrainer(jmodel, jdata, jcfg, mesh=_j_mesh(mesh_tag))
    p0, o0 = tr.init_state()
    init = _host((p0, o0))
    if tier == "scan":
        batch, _ = tr._scan_parts[0](key, tr.arrays)
        draw = {k: _np(v) for k, v in batch.items()}
        p1, o1, loss = jax.jit(tr._epoch_body)(p0, o0, key, tr.arrays)
    elif tier == "grouped_pairs":
        _, j, perm = _jax_grouped_draws(tr, key)
        per_step = max(tr.batch_size // tr.model.TARGET_CHUNK, 1)
        draw = {"j": _np(j), "perm": _np(perm).reshape(-1, per_step)}
        p1, o1, loss = jax.jit(tr._epoch_body)(p0, o0, key, tr.arrays)
    else:
        if tr._pre_epoch_fn is not None:
            tr.arrays.update(tr._pre_epoch_fn(p0, tr.arrays))
        draw = _dual_draws(tr, key)
        p1, o1, loss = tr._epoch_fn(p0, o0, key, tr.arrays)
    return init, draw, _host((p1, o1)), float(loss)


def _spawn(d, m, spec, out_dir):
    """Run the worker as the d * m ranks of a d x m mesh; their outputs."""
    spec_path = os.path.join(out_dir, "spec.npz")
    np.savez(spec_path, **spec)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(d), str(m), str(port),
         spec_path, out_dir], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(d * m)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * (d * m), "\n".join(logs)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(d * m)]


def _gather_inputs():
    rng = np.random.default_rng(0)
    return {"gather/table": rng.normal(size=(64, 16)).astype(np.float32),
            "gather/ids": rng.integers(0, 64, 37).astype(np.int64),
            "gather/cot": rng.normal(size=(37, 16)).astype(np.float32)}


def _world(toys, tmp_path_factory, mesh_tag):
    """Both packages' runs of every case on ``mesh_tag``: JAX's in this
    process, the port's on the spawned ranks."""
    out_dir = str(tmp_path_factory.mktemp(f"ranks{mesh_tag}"))
    key = jax.random.PRNGKey(7)
    spec, cases, want = {}, [], {}
    for name, toy, model, extra, tier, hard, meshes in CASES:
        if mesh_tag not in meshes:
            continue
        jcfg = _jcfg(toys, toy, model, extra)
        if name in PORT_ONLY:
            init, draw = (want[PORT_ONLY[name]][k] for k in ("init", "draw"))
            after = loss = None
        else:
            init, draw, after, loss = _jax_case(jcfg, tier, mesh_tag, key)
        want[name] = {"cfg": jcfg.to_dict(), "init": init, "draw": draw,
                      "after": after, "loss": loss}
        cases.append({"name": name, "kind": "epoch", "cfg": jcfg.to_dict()})
        for leaf, x in init[0].items():
            spec[f"{name}/p/{leaf}"] = _np(x)
        for col, x in draw.items():
            spec[f"{name}/draw/{col}"] = x
    for name, meshes in FM_CASES:
        if mesh_tag not in meshes:
            continue
        jcfg = _fm_cfg(toys, name)
        data = j_load_rating_data(jcfg)
        tr = j_rating.FMTrainer(j_rating.make_rating_model(jcfg, data), data,
                                jcfg, mesh=_j_mesh(mesh_tag))
        params = tr.model.init(jax.random.PRNGKey(1))
        start = {k: _np(v).copy() for k, v in params.items()}
        p1, o1, loss, order, w, _ = tr._epoch(
            params, tr.optimizer.init(params), jax.random.PRNGKey(2),
            tr._xi, tr._xv, tr._y)
        want[name] = {"cfg": jcfg.to_dict(), "start": start,
                      "after": _host((p1, o1)), "loss": float(loss)}
        cases.append({"name": name, "kind": "fm_epoch",
                      "cfg": jcfg.to_dict()})
        spec[f"{name}/order"], spec[f"{name}/w"] = _np(order), _np(w)
        for leaf, x in start.items():
            spec[f"{name}/p/{leaf}"] = x
        cases.append({"name": f"{name}_run", "kind": "fm_run",
                      "cfg": jcfg.to_dict()})
    spec.update(_gather_inputs())
    cases.append({"name": "gather", "kind": "gather"})
    if mesh_tag == "1x2":
        jcfg = _jcfg(toys, "toy", "BPR", BPR)
        want["step"] = _jax_step(jcfg, spec)
        cases.append({"name": "step", "kind": "step", "cfg": jcfg.to_dict()})
        run = _jcfg(toys, "toy", "BPR", {
            **RUN, "saved_dir": os.path.join(out_dir, "saved"),
            "profile.dir": os.path.join(out_dir, "traces")})
        cases.append({"name": "run", "kind": "run", "cfg": run.to_dict()})
        want["run"] = {"cfg": run.to_dict(), "dir": out_dir}
        mlp = _jcfg(toys, "toy", "MLP", MLP)
        cases.append({"name": "eval", "kind": "eval", "cfg": mlp.to_dict()})
        want["eval"] = {"cfg": mlp.to_dict()}
    if mesh_tag == "2x1":
        for name, toy, model, extra, _ in AGREE_CASES:
            cfg = _jcfg(toys, toy, model, extra).to_dict()
            want[name] = {"cfg": cfg}
            cases += [{"name": f"{name}_{tag}", "kind": "agree", "cfg": cfg,
                       "apart": tag == "apart"}
                      for tag in ("agree", "apart")]
    spec["cases"] = np.array(json.dumps(cases))
    d, m = MESHES[mesh_tag]
    return {"ranks": _spawn(d, m, spec, out_dir), "want": want,
            "mesh": (d, m)}


def _jax_step(jcfg, spec):
    """JAX's sharded_train_step on make_mesh(1, 2) from the JAX model's
    init, one step of 64 rows; its batch goes into the spec."""
    from cleverrec_tpu.common import make_optimizer
    from cleverrec_tpu.data import load_ranking_data as j_load
    from cleverrec_tpu.models import make_model as j_make_model
    from cleverrec_tpu.models.base import DataMeta as JMeta
    from cleverrec_tpu.train import Trainer as JTrainer
    jdata = j_load(jcfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    tr = JTrainer(jmodel, jdata, jcfg)
    mesh = _j_mesh("1x2")
    params = jmodel.init(jax.random.PRNGKey(3))
    init = _host(params)
    opt = make_optimizer(jcfg.optimizer, jcfg.lr)
    key = jax.random.PRNGKey(4)
    rows = jnp.arange(64, dtype=jnp.int32) * 3
    valid = jnp.ones(64, jnp.float32)
    batch = j_sampling.pairwise_batch(
        key, rows, valid, tr.arrays["pos_u"], tr.arrays["pos_i"],
        tr.arrays["seen"], tr.dd.item_nums, jcfg.neg_ratio)
    step = j_sharded_train_step(jmodel, opt, mesh, tr.dd.item_nums,
                                jcfg.neg_ratio)
    p1, o1, loss = step(params, opt.init(params), key, tr.arrays, rows,
                        valid)
    for leaf, x in init.items():
        spec[f"step/p/{leaf}"] = x
    for col, x in batch.items():
        spec[f"step/batch/{col}"] = _np(x)
    spec["step/rows"], spec["step/valid"] = _np(rows), _np(valid)
    return {"after": _host((p1, o1)), "loss": float(loss)}


@pytest.fixture(scope="module")
def world12(toys, tmp_path_factory):
    return _world(toys, tmp_path_factory, "1x2")


@pytest.fixture(scope="module")
def world21(toys, tmp_path_factory):
    return _world(toys, tmp_path_factory, "2x1")


@pytest.fixture(scope="module")
def world22(toys, tmp_path_factory):
    return _world(toys, tmp_path_factory, "2x2")


def _worlds(request, tag):
    return request.getfixturevalue({"1x2": "world12", "2x1": "world21",
                                    "2x2": "world22"}[tag])


def _port_epoch(want):
    """The port's unmeshed epoch from JAX's initial state on JAX's draw
    (``train_epoch``, so pre_epoch runs), or, without them, from its own
    seed's state and draw: (params, moments, loss, metrics)."""
    cfg = Config(want["cfg"])
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    trainer = Trainer(model, data, cfg, device="cpu")
    params, state = trainer.init_state()
    if "init" in want:
        load_params(model, {k: _np(v) for k, v in want["init"][0].items()})
        draw = {k: torch.as_tensor(np.array(v))
                for k, v in want["draw"].items()}
        trainer.sample_epoch = lambda: draw
    # The ranks' thread count: a CPU kernel's sums may split by thread.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, state, loss = trainer.train_epoch(params, state)
    finally:
        torch.set_num_threads(threads)
    moments = ({"acc": state.sum_of_squares} if hasattr(state,
                                                        "sum_of_squares")
               else {"mu": state.mu, "nu": state.nu})
    return ({k: p.detach() for k, p in params.items()}, moments, loss,
            trainer.evaluate())


def _same_ranks(ranks, prefix):
    keys = [k for k in ranks[0] if k.startswith(prefix)
            and "/bytes/" not in k]
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


EPOCH_PARAMS = [(c[0], tag) for c in CASES for tag in c[6]]


@pytest.mark.parametrize("name,tag", EPOCH_PARAMS)
def test_meshed_epoch_matches_jax_and_the_unmeshed_port(request, name, tag):
    """One epoch on the mesh: the ranks equal each other bit for bit; the
    gathered state and the loss equal the port's unmeshed epoch on the
    same draw (at a data axis of 1 bit for bit under gspmd and within
    EXCHANGE_TOL under explicit; at 2, the batch split over 'data', within
    ``TOL``) and the JAX trainer's meshed epoch within
    tests/test_parallel.py's tolerances (``TOL``; not the ``PORT_ONLY``
    cases); the evaluation after it (``full_sharded`` or candidates,
    through the exchange) equals the unmeshed evaluator's; the tier is the
    JAX trainer's."""
    world = _worlds(request, tag)
    case = next(c for c in CASES if c[0] == name)
    tier, tol = case[4], case[5]
    ranks, want = world["ranks"], world["want"][name]
    _same_ranks(ranks, f"{name}/")
    got = ranks[0]
    assert str(got[f"{name}/tier"]) == tier
    params, moments, loss, metrics = _port_epoch(want)
    rtol, atol, lrtol = TOL[tol]
    split = tier == "scan" and world["mesh"][0] > 1
    assert str(got[f"{name}/data_mode"]) == ("split" if split else "None")
    explicit = "explicit" in name
    for leaf, x in params.items():
        for part, ref in (("p", x), ("mu", moments["mu"][leaf]),
                          ("nu", moments["nu"][leaf])):
            g = got[f"{name}/{part}/{leaf}"]
            if split:
                np.testing.assert_allclose(g, ref.numpy(), rtol=rtol,
                                           atol=atol, err_msg=f"{part}/{leaf}")
            elif explicit:
                np.testing.assert_allclose(g, ref.numpy(), rtol=EXCHANGE_TOL,
                                           atol=EXCHANGE_TOL,
                                           err_msg=f"{part}/{leaf}")
            else:
                np.testing.assert_array_equal(g, ref.numpy(),
                                              err_msg=f"{part}/{leaf}")
    assert float(got[f"{name}/loss"]) == pytest.approx(
        loss, rel=lrtol if split else EXCHANGE_TOL if explicit else 0)
    meshed = json.loads(str(got[f"{name}/metrics"]))
    for k, vals in metrics.items():
        np.testing.assert_allclose(meshed[str(k)], vals, atol=METRIC_ATOL)
    if name in PORT_ONLY:
        return
    (p1, o1) = want["after"]
    assert float(got[f"{name}/loss"]) == pytest.approx(want["loss"],
                                                       rel=lrtol)
    for leaf in params:
        for part, ref in (("p", p1[leaf]), ("mu", o1[0].mu[leaf]),
                          ("nu", o1[0].nu[leaf])):
            np.testing.assert_allclose(got[f"{name}/{part}/{leaf}"],
                                       _np(ref), rtol=rtol, atol=atol,
                                       err_msg=f"{part}/{leaf}")


@pytest.mark.parametrize("name,tier", [(c[0], c[4]) for c in AGREE_CASES])
def test_whole_step_tiers_take_one_gradient(world21, name, tier):
    """SoHRML's dual and NAIS's bucketed epoch on 2 x 1, rank 1's
    gradients nudged: the ranks take data rank 0's gradients and loss
    (``sharding.over_data``), so their states and losses are equal bit
    for bit, and equal to the unmeshed epoch on the same seed; with the
    agreement taken out, the nudge parts them."""
    ranks = world21["ranks"]
    agreed = f"{name}_agree/"
    _same_ranks(ranks, agreed)
    got = ranks[0]
    assert str(got[f"{agreed}tier"]) == tier
    assert str(got[f"{agreed}data_mode"]) == "agree"
    params, moments, loss, _ = _port_epoch(world21["want"][name])
    for leaf, x in params.items():
        for part, ref in (("p", x), *((k, m[leaf])
                                      for k, m in moments.items())):
            np.testing.assert_array_equal(got[f"{agreed}{part}/{leaf}"],
                                          ref.numpy(),
                                          err_msg=f"{part}/{leaf}")
    assert float(got[f"{agreed}loss"]) == float(loss)
    apart = [k for k in ranks[0] if k.startswith(f"{name}_apart/p/")]
    assert apart and any(not np.array_equal(ranks[0][k], ranks[1][k])
                         for k in apart)


@pytest.mark.parametrize("tag", ["1x2", "2x2"])
def test_each_rank_holds_its_rows(request, tag):
    """Each rank's bytes of BPR's P and Q and of their moments are 1/M of
    the whole tables'; a table that does not divide (the 31-user toy's P)
    stays whole on every rank, and so do the dense leaves."""
    world = _worlds(request, tag)
    m = world["mesh"][1]
    for name, sharded in (("BPR_gspmd", ["P", "Q"]),
                          ("BPR_explicit", ["Q"])):
        for got in world["ranks"]:
            assert json.loads(str(got[f"{name}/shards"])) == sharded
            for part in ("p", "mu", "nu"):
                for leaf in ("P", "Q"):
                    whole = got[f"{name}/{part}/{leaf}"].nbytes
                    held = int(got[f"{name}/bytes/{part}/{leaf}"])
                    assert held * (m if leaf in sharded else 1) == whole, (
                        name, part, leaf)


@pytest.mark.parametrize("name,tag", [(n, t) for n, ts in FM_CASES
                                      for t in ts])
def test_fm_under_the_mesh_matches_jax(request, name, tag):
    """FM and FFM: one meshed epoch on JAX's order and weights from JAX's
    parameters against JAX's meshed epoch (every leaf with a leading dim
    that divides M row-sharded, w0 replicated; at a data axis of 2 the
    batch split over 'data'); a whole meshed run's best RMSE equals the
    port's unmeshed run's (rel 1e-4)."""
    world = _worlds(request, tag)
    ranks, want = world["ranks"], world["want"][name]
    _same_ranks(ranks, f"{name}/")
    got = ranks[0]
    assert json.loads(str(got[f"{name}/shards"])) == (
        ["vif", "wi"] if world["mesh"][1] > 1 else [])
    p1, o1 = want["after"]
    assert float(got[f"{name}/loss"]) == pytest.approx(want["loss"],
                                                       rel=LOSS_RTOL)
    for leaf in want["start"]:
        for part, ref in (("p", p1[leaf]), ("mu", o1[0].mu[leaf]),
                          ("nu", o1[0].nu[leaf])):
            np.testing.assert_allclose(got[f"{name}/{part}/{leaf}"],
                                       _np(ref), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{part}/{leaf}")
    cfg = Config(want["cfg"])
    data = load_rating_data(cfg)
    best = FMTrainer(make_rating_model(cfg, data), data, cfg,
                     device="cpu").run()
    for r in ranks:
        assert float(r[f"{name}_run/rmse"]) == pytest.approx(best["rmse"],
                                                             rel=1e-4)


@pytest.mark.parametrize("tag", ["1x2", "2x2"])
def test_row_sharded_gather_matches_jax(request, tag):
    """The gather's rows and the gradient of sum(rows * cot), joined from
    the ranks' blocks, against JAX's row_sharded_gather on the same mesh
    shape (tests/test_parallel.py:261-289); on 2 x 2 its data-axis form
    too."""
    world = _worlds(request, tag)
    inputs = _gather_inputs()
    table, ids, cot = (jnp.asarray(inputs[f"gather/{k}"])
                       for k in ("table", "ids", "cot"))
    mesh = _j_mesh(tag)
    forms = [("model", None)] + ([("data", "data")] if tag == "2x2" else [])
    for form, data_axis in forms:
        # JAX's data-axis form takes as many ids as divide over 'data'.
        n = 36 if data_axis else None
        jids = ids[:n].astype(jnp.int32)

        def f(t):
            return jnp.sum(j_row_sharded_gather(
                t, jids, mesh, data_axis=data_axis) * cot[:n])

        with mesh:
            padded = j_pad_table_for_sharding(table, 2)
            rows = j_row_sharded_gather(padded, jids, mesh,
                                        data_axis=data_axis)
            grad = jax.grad(f)(padded)
        for got in world["ranks"]:
            np.testing.assert_allclose(got[f"gather/{form}/rows"],
                                       _np(rows), rtol=GATHER_RTOL)
            np.testing.assert_allclose(got[f"gather/{form}/grad"],
                                       _np(grad), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)


def test_sharded_train_step_matches_jax(world12):
    """One sharded_train_step on the 1 x 2 mesh on JAX's batch against
    JAX's sharded_train_step on make_mesh(1, 2)."""
    ranks, want = world12["ranks"], world12["want"]["step"]
    _same_ranks(ranks, "step/")
    got = ranks[0]
    p1, o1 = want["after"]
    assert float(got["step/loss"]) == pytest.approx(want["loss"],
                                                    rel=LOSS_RTOL)
    for leaf in p1:
        for part, ref in (("p", p1[leaf]), ("mu", o1[0].mu[leaf]),
                          ("nu", o1[0].nu[leaf])):
            np.testing.assert_allclose(got[f"step/{part}/{leaf}"], _np(ref),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{part}/{leaf}")


def test_meshed_run_checkpoints_evaluates_and_traces(world12):
    """A 1 x 2 BPR run: rank 0 wrote save.best's checkpoint in the
    unmeshed format (whole tables), which resumes unmeshed and on the
    mesh (each rank its rows); full_sharded evaluation (BPR scores its
    own item rows) equals the unmeshed evaluator's on the gathered
    parameters; each rank traced the second block into its own file."""
    ranks, want = world12["ranks"], world12["want"]["run"]
    _same_ranks(ranks, "run/")
    got = ranks[0]
    assert str(got["run/mode"]) == "full_sharded"
    assert all(bool(r["run/resumed_equal"]) for r in ranks)
    cfg = Config(want["cfg"])
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    path = os.path.join(cfg.str("saved_dir"), "BPR")
    saved = load_checkpoint(path)
    trainer = Trainer(model, data, cfg, device="cpu")
    params, state, epoch = trainer.resume(path)
    assert epoch == int(got["run/best_epoch"]) == int(got["run/resumed_epoch"])
    for leaf, p in params.items():
        assert tuple(p.shape) == tuple(got[f"run/p/{leaf}"].shape)
        assert torch.equal(p, saved["params"][leaf])
        assert torch.equal(state.mu[leaf], saved["opt_state"]["mu"][leaf])
    if epoch == 2:
        for leaf, p in params.items():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          got[f"run/p/{leaf}"])
    with torch.no_grad():
        for leaf, p in params.items():
            p.copy_(torch.as_tensor(got[f"run/p/{leaf}"]))
    flat = trainer.evaluate()
    meshed = json.loads(str(got["run/metrics"]))
    for k, vals in flat.items():
        np.testing.assert_allclose(meshed[str(k)], vals, atol=1e-6)
    for r in range(2):
        trace = os.path.join(want["dir"], "traces", f"BPR_rank{r}.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        assert events


def test_full_sharded_without_a_dot_decomposition(world12):
    """MLP on the 1 x 2 mesh (P and Q row-sharded, no dot decomposition):
    full_sharded evaluation of its fresh draw equals the unmeshed
    evaluator's on the same parameters."""
    ranks = world12["ranks"]
    _same_ranks(ranks, "eval/")
    got = ranks[0]
    assert str(got["eval/mode"]) == "full_sharded"
    assert json.loads(str(got["eval/shards"])) == ["P", "Q"]
    cfg = Config(world12["want"]["eval"]["cfg"])
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    trainer = Trainer(model, data, cfg, device="cpu")
    params, _ = trainer.init_state()
    with torch.no_grad():
        for leaf, p in params.items():
            p.copy_(torch.as_tensor(got[f"eval/p/{leaf}"]))
    flat = trainer.evaluate()
    meshed = json.loads(str(got["eval/metrics"]))
    for k, vals in flat.items():
        np.testing.assert_allclose(meshed[str(k)], vals, atol=1e-6)


def test_cli_trains_on_a_model_axis(toys, tmp_path):
    """python -m torch.distributed.run --nproc-per-node 2 ... --distributed
    --mesh 1x2 --device cpu: BPR under the explicit exchange trains two
    epochs to the end, rank 0 alone logging, its log naming the
    row-sharded tables."""
    model = "BPR"
    values = {"epoches": "2", "log.dir": str(tmp_path),
              "data.root_dir": toys, "data.dataset": "toy",
              "data.file_name": "ratings.csv", "data.sep": ",",
              "batch_size": "64", "embed_size": "16",
              "test.neg_samples": "10", "parallel.exchange": "explicit"}
    argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
            "--nproc-per-node", "2", "--master-addr", "localhost",
            "--master-port", str(_free_port()), "-m",
            "cleverrec_tpu_torch.cli", "--distributed", "--mesh", "1x2",
            "--device", "cpu", "--config",
            os.path.join(REPO, "CleverRec.properties"), "--conf-dir",
            os.path.join(REPO, "conf"), "--model", model]
    for k, v in values.items():
        argv += ["--set", f"{k}={v}"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    run = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=240)
    assert run.returncode == 0, run.stdout + run.stderr
    log = (tmp_path / f"{model}.log").read_text()
    assert log.count("mesh: data=1 x model=2") == 1
    assert log.count("mesh 1x2: the scan tier; P, Q row-sharded over 2 "
                     "model ranks") == 1
    assert log.count("best_epoch: ") == 1


@pytest.mark.parametrize("m", [2, 4])
def test_placement_matches_jax(m):
    """param_sharding_tree names the leaves the JAX package places on
    'model' (2-D, an entity cardinality high, dividing M); shard_params
    gives model rank r rows [r N / M, (r + 1) N / M) of those and every
    other leaf whole; replicate and shard_batch_spec (data rank d's chunk
    of a batch's leading axis, uneven chunks too) keep their contracts."""
    from cleverrec_tpu.models.base import DataMeta as JMeta
    meta = DataMeta(30, 40)
    params = {name: np.arange(int(np.prod(shape)), dtype=np.float32).reshape(
        shape) for name, shape in (("P", (30, 4)), ("Q", (40, 4)),
                                   ("S", (31, 4)), ("J", (70, 4)),
                                   ("b", (40,)), ("W", (4, 4)))}
    want = j_param_sharding_tree(params, JMeta(30, 40),
                                 j_make_mesh(1, m, devices=jax.devices()[:m]))
    got = param_sharding_tree(params, meta, Mesh(1, m, "cpu"))
    assert got == {k: tuple(v.spec) for k, v in want.items()}
    for r in range(m):
        mesh = Mesh(2, m, "cpu", rank=m + r)
        held = shard_params({k: torch.as_tensor(v)
                             for k, v in params.items()}, meta, mesh)
        for k, x in params.items():
            if got[k]:
                rows = x.shape[0] // m
                np.testing.assert_array_equal(
                    held[k].numpy(), x[r * rows:(r + 1) * rows], err_msg=k)
            else:
                np.testing.assert_array_equal(held[k].numpy(), x, err_msg=k)
        batch = shard_batch_spec(mesh)({"u": torch.arange(10)})
        assert batch["u"].tolist() == [5, 6, 7, 8, 9]
        batch = shard_batch_spec(mesh)({"u": torch.arange(11)})
        assert batch["u"].tolist() == [6, 7, 8, 9, 10]
        assert replicate(torch.ones(2), mesh).device == torch.device("cpu")
