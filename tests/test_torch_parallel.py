"""The data axis of the parallel layer in the port against the JAX package,
in one process: the delta combine against JAX's under ``shard_map``; the
fused mesh-DP epoch of each fused protocol, grouped under DP and the
scan tier's local Adam, each as a serial oracle of the port's pieces
(``tests/torch_dp_oracle.py``) on the JAX trainer's own draws, held to
the JAX trainer's meshed epoch on the 8 virtual CPU devices
(``tests/conftest.py``); a ``1 x 1`` mesh against the unmeshed run; the
tier each config takes under a mesh against the JAX trainer's; and what
raises.  The collectives themselves are tests/test_torch_distributed.py's.
"""

import logging

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cleverrec_tpu import sampling as j_sampling
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.parallel.mesh import make_mesh as j_make_mesh
from cleverrec_tpu.parallel.sharding import \
    _is_embedding_table as j_is_embedding_table
from cleverrec_tpu.parallel.sharding import \
    pad_table_for_sharding as j_pad_table_for_sharding
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu.train.trainer import _dp_delta_combine as j_combine
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.parallel import (Mesh, pad_table_for_sharding,
                                          single_device_mesh)
from cleverrec_tpu_torch.parallel.sharding import _is_embedding_table
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.trainer import (_state_leaves, _touched,
                                               dp_combine_rule)
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config, make_toy_interactions
from tests.torch_dp_oracle import fused_oracle, grouped_oracle, scan_oracle

# The combine, port against JAX: one sum of D deltas in another order.
COMBINE_TOL = 1e-6
# One meshed epoch, port against JAX: parameters and moments within
# 1e-5 + 1e-3 |x|, the loss within 1e-5 relative, the count exact.
ATOL, RTOL, LOSS_RTOL = 1e-5, 1e-3, 1e-5

# tests/test_torch_grouped.py's shapes (the toy, embed 8) at batch 128, each
# model's form of its conf; SBPR on the toy's trust graph.
BASE = {"epoches": "1", "batch_size": "128", "embed_size": "8",
        "lr": "0.01", "neg_ratio": "2", "reg": "0.01", "stddev": "0.1",
        "train.fused_kernel": "True"}
MODELS = {
    "BPR": {"is_pairwise": "True", "loss_func": "bpr"},
    # lr 0.001 as tests/test_torch_grouped.py: the h chain's f32 order
    # noise stays far below the tolerance.
    "GMF": {"is_pairwise": "False", "loss_func": "cross_entropy",
            "lr": "0.001"},
    "NeuMF": {"is_pairwise": "False", "loss_func": "cross_entropy",
              "layers": "[16,8]", "reg1": "0.02", "reg2": "0.03",
              "lr": "0.001"},
    "CML": {"is_pairwise": "True", "loss_func": "hinge", "margin": "1.0",
            "reg": "0.05", "neg_ratio": "3"},
    "LRML": {"loss_func": "hinge", "margin": "0.2", "reg": "0.001",
             "mem_size": "6"},
    "SBPR": {"is_pairwise": "True", "loss_func": "bpr", "reg": "0.05",
             "social_file": "trusts.csv"},
}
PROTOCOL = {"BPR": "pairwise_bpr", "GMF": "pointwise_bce",
            "NeuMF": "pointwise_mlp", "CML": "cml_hinge", "LRML": "rows",
            "SBPR": "rows"}


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    """The conftest toys, module-scoped: 30 users and 40 items, and 30
    users with a trust graph."""
    root = tmp_path_factory.mktemp("parallel")
    (root / "toy").mkdir()
    make_toy_interactions(root / "toy" / "ratings.csv")
    (root / "toysoc").mkdir()
    make_toy_interactions(root / "toysoc" / "ratings.csv", n_users=30,
                          n_rows=500)
    r = np.random.default_rng(5)
    lines = ["u_id,v_id"]
    for u in range(30):
        for v in r.choice(30, size=r.integers(1, 5), replace=False):
            if v != u:
                lines.append(f"{u},{v}")
    (root / "toysoc" / "trusts.csv").write_text("\n".join(lines) + "\n")
    return {"toy": {"root": str(root), "name": "toy"},
            "toysoc": {"root": str(root), "name": "toysoc"}}


def _jcfg(toys, name, **extra):
    toy = toys["toysoc" if "social_file" in MODELS.get(name, {})
               or name in ("SAMN", "RML_DGATs") else "toy"]
    return base_config(toy, **{**BASE, **MODELS.get(name, {}),
                               "recommender": name, **extra})


def _port(jcfg, d, **extra):
    cfg = Config({**jcfg.to_dict(), **extra})
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    mesh = Mesh(d, 1, "cpu") if d else None
    return model, Trainer(model, data, cfg, device="cpu", mesh=mesh)


def _jax_trainer_args(jcfg):
    jdata = j_load_ranking_data(jcfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    return jmodel, jdata, jcfg


def _jax_trainer(jcfg, d):
    mesh = j_make_mesh(d, 1, devices=jax.devices()[:d]) if d else None
    return JTrainer(*_jax_trainer_args(jcfg), mesh=mesh)


def _host(tree):
    """A JAX pytree as numpy copies (the next call may donate it)."""
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _load(model, p, o):
    load_params(model, p)
    return (dict(model.named_parameters()),
            adam_state_from_jax(o[0].count, o[0].mu, o[0].nu, "cpu",
                                model=model))


def _raw_draw(tr, key, steps):
    """The JAX fused epoch's draw as the sampler's raw columns: the same
    key split and the same (D-padded) static layout as its sample_fn."""
    pkey, _ = jax.random.split(key)
    arrays, sampler = tr.arrays, tr.model.sampler
    static = next(arrays[k] for k in (f"{sampler}_static_dp",
                                      f"{sampler}_static") if k in arrays)
    head = (pkey, static)
    tail = (tr.dd.item_nums, steps, tr.batch_size)
    if sampler == "sbpr":
        batch = j_sampling.sbpr_epoch_tensors(
            *head, arrays["social_neg"], arrays["spu_csr"], *tail)
    else:
        fn = {"pairwise": j_sampling.pairwise_epoch_tensors,
              "pointwise": j_sampling.pointwise_epoch_tensors,
              "cml": lambda *a, **k: j_sampling.cml_epoch_tensors(
                  *a, **k, neg_ratio=tr.neg_ratio)}[sampler]
        batch = fn(*head, arrays["seen"], *tail,
                   pop_cdf=arrays.get("pop_cdf"))
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _hold(params, state, loss, want, names):
    p1, o1, l1 = want
    assert loss == pytest.approx(float(l1), rel=LOSS_RTOL)
    assert state.count == int(o1[0].count)
    for name in names:
        for got, ref in ((params[name], p1[name]),
                         (state.mu[name], o1[0].mu[name]),
                         (state.nu[name], o1[0].nu[name])):
            np.testing.assert_allclose(got.detach().numpy(), _np(ref),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


# -- the combine ------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", ["mean", "sum", "count"])
def test_combine_rule_matches_jax(mode, d):
    """dp_combine_rule on the sums of D ranks' deltas against JAX's
    _dp_delta_combine under shard_map: a table whose rows some ranks leave
    (one row no rank touches), a vector, a 0-d leaf that one rank leaves,
    and an integer leaf, which passes (the port's combine never sees it:
    _state_leaves keeps floats only)."""
    rng = np.random.default_rng(d)
    old = {"P": rng.normal(size=(12, 5)).astype(np.float32),
           "b": rng.normal(size=7).astype(np.float32),
           "s": np.float32(0.3), "n": np.int32(4)}
    news = []
    for r in range(d):
        rows = (rng.random(12) < 0.5)[:, None]
        rows[0] = False
        news.append({
            "P": old["P"] + np.where(rows, rng.normal(size=(12, 5)),
                                     0.0).astype(np.float32),
            "b": old["b"] + (rng.normal(size=7)
                             * (rng.random(7) < 0.6)).astype(np.float32),
            "s": np.float32(old["s"] + (0.0 if r == 0 else 0.1 * (r + 1))),
            "n": np.int32(old["n"] + 3)})
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *news)
    combine = j_combine(mode)

    def per_rank(new, o):
        return jax.tree_util.tree_map(combine, jax.tree_util.tree_map(
            lambda a: a[0], new), o)

    want = shard_map(per_rank, mesh=j_make_mesh(d, 1,
                                                devices=jax.devices()[:d]),
                     in_specs=(P("data"), P()), out_specs=P(),
                     check_vma=False)(stacked, old)
    assert int(want["n"]) == 7
    for name in ("P", "b", "s"):
        o = torch.as_tensor(old[name])
        deltas = [torch.as_tensor(n[name]) - o for n in news]
        got = dp_combine_rule(o, sum(deltas), sum(_touched(x) for x in deltas),
                              mode, d)
        np.testing.assert_allclose(got.numpy(), _np(want[name]),
                                   rtol=COMBINE_TOL, atol=COMBINE_TOL,
                                   err_msg=name)
    assert len(_state_leaves({"n": torch.tensor(4), "P": torch.ones(2)},
                             None)) == 1
    with pytest.raises(ValueError, match="dp_delta_combine"):
        dp_combine_rule(o, o, o, "median", d)


# -- the fused mesh-DP tier ---------------------------------------------------

FUSED_CASES = ([(name, 2, k, "mean") for name in MODELS for k in (0, 2)]
               + [("BPR", 4, 0, "mean"), ("BPR", 2, 0, "sum"),
                  ("BPR", 2, 0, "count"), ("BPR", 2, 2, "count")])


@pytest.mark.parametrize("name,d,k,mode", FUSED_CASES)
def test_fused_dp_oracle_matches_jax(toys, name, d, k, mode):
    """One fused mesh-DP epoch: the port's epoch function on each rank's
    chunk of the JAX trainer's draw, rank after rank from JAX's initial
    state, in K-step rounds combined by the port's rule, against the JAX
    trainer's meshed epoch (its kernels in interpret mode on D virtual
    devices): every parameter and moment, the loss and the count."""
    jcfg = _jcfg(toys, name, **{"train.dp_sync_every": str(k),
                                "train.dp_delta_combine": mode})
    tr = _jax_trainer(jcfg, d)
    assert tr._fused_mesh_dp == d and hasattr(tr, "_fused_parts")
    p0, o0 = tr.init_state()
    init = _host((p0, o0))
    key = jax.random.PRNGKey(123)
    steps = jax.tree_util.tree_leaves(
        tr._fused_parts[0](key, tr.arrays))[0].shape[0]
    draw = _raw_draw(tr, key, steps)
    want = _host(jax.jit(tr._epoch_body)(p0, o0, key, tr.arrays))

    model, trainer = _port(jcfg, d)
    assert trainer.tier == "fused" and trainer._dp == d
    assert trainer.model.fused_protocol == PROTOCOL[name]
    assert (trainer.steps_per_epoch, trainer._sync_k) == (steps, k)
    assert steps % (d * max(k, 1)) == 0
    params, state = _load(model, *init)
    loss = fused_oracle(trainer, params, state, draw, d, k, mode)
    _hold(params, state, loss, want, list(init[0]))


def _group_draws(tr, key):
    """The JAX grouped epoch's per-group draws (tests/test_torch_grouped.py
    's): group g's key is the first half of split(key, G)[g]'s split."""
    statics = tr.arrays["grouped_static"]
    steps = statics["ord_u"].shape[1] // tr.batch_size
    fn = {"pairwise_bpr": j_sampling.pairwise_epoch_tensors,
          "cml_hinge": lambda *a, **k: j_sampling.cml_epoch_tensors(
              *a, **k, neg_ratio=tr.neg_ratio)}[tr.model.fused_protocol]
    draws = []
    for g, gkey in enumerate(jax.random.split(key, len(statics["ord_u"]))):
        pkey, _ = jax.random.split(gkey)
        batch = fn(pkey, {k: v[g] for k, v in statics.items()},
                   tr.arrays["grouped_seen"], tr.dd.item_nums, steps,
                   tr.batch_size, pop_cdf=tr.arrays.get("pop_cdf"))
        draws.append({k: torch.as_tensor(np.array(v))
                      for k, v in batch.items()})
    return draws


@pytest.mark.parametrize("name", ["BPR", "CML"])
def test_grouped_dp_oracle_matches_jax(toys, name):
    """Grouped under DP, 2 groups at D = 2: each rank's block-coordinate
    walk over its chunk of every group's draw (n_sents / D sentinels a
    group), one combine after, against the JAX trainer's meshed grouped
    epoch; the count advances by G * steps_eq / D."""
    d = 2
    jcfg = _jcfg(toys, name, **{"train.fused_groups": "2"})
    tr = _jax_trainer(jcfg, d)
    _, steps_eq, mesh_dp = tr._grouped_parts
    assert mesh_dp == d and steps_eq % d == 0
    p0, o0 = tr.init_state()
    init = _host((p0, o0))
    key = jax.random.PRNGKey(11)
    draws = _group_draws(tr, key)
    want = _host(jax.jit(tr._epoch_body)(p0, o0, key, tr.arrays))

    model, trainer = _port(jcfg, d)
    assert trainer.tier == "fused_grouped" and trainer._dp == d
    assert trainer._group_plan["steps_eq"] == steps_eq
    params, state = _load(model, *init)
    loss = grouped_oracle(trainer, params, state, draws, d, "mean")
    assert state.count == int(init[1][0].count) + 2 * steps_eq // d
    _hold(params, state, loss, want, list(init[0]))


# -- the scan tier's local Adam ---------------------------------------------

@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("name", ["BPR", "SBPR"])
def test_scan_local_adam_oracle_matches_jax(toys, name, k):
    """train.dp_local_adam at D = 2 on the scan tier (BPR's pairwise
    protocol, SBPR's rows protocol through its loss): each rank's
    whole-batch scan steps over its chunk of the JAX trainer's draw, in
    K-step rounds combined by the default sum, against the JAX trainer's
    meshed scan epoch; the loss is the ranks' sum over the unpadded steps."""
    d = 2
    jcfg = _jcfg(toys, name, **{"train.fused_kernel": "False",
                                "train.dp_local_adam": "True",
                                "train.dp_sync_every": str(k)})
    tr = _jax_trainer(jcfg, d)
    _, _, steps, dp, sync_k = tr._scan_parts
    assert (dp, sync_k) == (d, k)
    p0, o0 = tr.init_state()
    init = _host((p0, o0))
    key = jax.random.PRNGKey(42)
    batch, _ = tr._scan_parts[0](key, tr.arrays)
    draw = {n: torch.as_tensor(np.array(v)) for n, v in batch.items()}
    want = _host(jax.jit(tr._epoch_body)(p0, o0, key, tr.arrays))

    model, trainer = _port(jcfg, d)
    assert trainer.tier == "scan_local_adam" and trainer._combine == "sum"
    assert (trainer.steps_per_epoch, trainer._real_steps) == (
        steps, tr.steps_per_epoch)
    params, state = _load(model, *init)
    loss = scan_oracle(trainer, params, state, draw, d, k, "sum")
    _hold(params, state, loss, want, list(init[0]))


# -- a 1 x 1 mesh -------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_single_device_mesh_is_the_unmeshed_run(toys, fused):
    """A 1 x 1 mesh runs the unmeshed program bit for bit (no process
    group): one epoch from the same seed on the fused and the scan tier."""
    jcfg = _jcfg(toys, "BPR", **{"train.fused_kernel": str(fused)})
    runs = []
    for mesh in (None, single_device_mesh("cpu")):
        cfg = Config(jcfg.to_dict())
        data = load_ranking_data(cfg)
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                           device="cpu")
        trainer = Trainer(model, data, cfg, device="cpu", mesh=mesh)
        assert trainer.tier == ("fused" if fused else "scan")
        assert trainer._dp == 1
        params, state = trainer.init_state()
        params, state, loss = trainer.train_epoch(params, state)
        runs.append((loss, state.count,
                     {n: p.detach().clone() for n, p in params.items()},
                     {n: m.clone() for n, m in state.mu.items()}))
    (l0, c0, p0, m0), (l1, c1, p1, m1) = runs
    assert (l1, c1) == (l0, c0)
    for name in p0:
        assert torch.equal(p1[name], p0[name]) and torch.equal(m1[name],
                                                               m0[name])


# -- the tier under a mesh ----------------------------------------------------

def _jax_tier(tr):
    if hasattr(tr, "_grouped_parts"):
        return "fused_grouped"
    if hasattr(tr, "_fused_parts"):
        return "fused"
    if getattr(tr, "_sparse_tier", False):
        return "sparse_rows"
    if getattr(tr, "_bucket_plan", None):
        return "bucketed"
    if tr.model.sampler == "dual":
        return "dual"
    if hasattr(tr, "_scan_parts"):
        return "scan_local_adam" if tr._scan_parts[3] > 1 else "scan"
    return "grouped_pairs"


SAMN = {"embed_size": "16", "mem_size": "4", "atten_size": "6",
        "reg1": "0.01", "reg2": "0.03", "lr": "0.05", "neg_ratio": "1",
        "optimizer": "Adagrad", "social_file": "trusts.csv",
        "train.fused_kernel": "False"}
NAIS = {"embed_size": "16", "atten_size": "8", "beta": "0.5",
        "optimizer": "Adagrad", "is_pairwise": "False",
        "loss_func": "cross_entropy", "batch_size": "256",
        "train.fused_kernel": "False"}
RML = {"embed_size": "16", "atten_size": "8", "train_batches": "3",
       "loss_func": "hinge", "margin": "0.5", "gamma": "0.1", "reg1": "0.1",
       "reg2": "0.01", "att_type": "2", "mlp_type": "0", "max_i": "5",
       "max_s": "3", "social_file": "trusts.csv"}
TIERS = [
    ("BPR", {}, "fused"),
    ("BPR", {"train.fused_groups": "2"}, "fused_grouped"),
    ("BPR", {"train.fused_mesh_dp": "False"}, "scan"),
    ("SBPR", {"train.fused_kernel": "False",
              "train.sparse_rows_force": "True"}, "scan"),
    ("NAIS", NAIS, "bucketed"),
    ("SAMN", SAMN, "grouped_pairs"),
    ("RML_DGATs", RML, "dual"),
    ("BPR", {"train.fused_kernel": "False"}, "scan"),
    ("BPR", {"train.fused_kernel": "False", "train.dp_local_adam": "True"},
     "scan_local_adam"),
]


@pytest.mark.parametrize("name,extra,tier", TIERS)
def test_tier_under_a_mesh_is_the_jax_tier(toys, name, extra, tier):
    """The tier a config takes under a 2 x 1 mesh is the JAX trainer's;
    the data-parallel tiers split the steps, the scan tier the batch, the
    others run the whole step on every rank, and one log line says which;
    the lazy row-Adam tier declines."""
    _tier_case(toys, name, extra, tier, (2, 1))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name,extra,tier", TIERS)
def test_tier_under_a_model_axis_is_the_jax_tier(toys, name, extra, tier,
                                                 shape):
    """The same under a 1 x 2 and a 2 x 2 mesh (``tier`` is the 2 x 1
    one; under a model axis the fused tier and local Adam decline, as in
    the JAX trainer): the log line also names the row-sharded tables."""
    _tier_case(toys, name, extra, tier, shape)


def _tier_case(toys, name, extra, tier, shape):
    d, m = shape
    jcfg = _jcfg(toys, name, **extra)
    want = _jax_tier(JTrainer(
        *_jax_trainer_args(jcfg),
        mesh=j_make_mesh(d, m, devices=jax.devices()[:d * m])))
    if shape == (2, 1):
        assert want == tier
    cfg = Config(jcfg.to_dict())
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    logger, records = _logged(f"{name}.{tier}.{d}x{m}")
    trainer = Trainer(model, data, cfg, device="cpu", logger=logger,
                      mesh=Mesh(d, m, "cpu"))
    assert trainer.tier == want
    split = want in ("fused", "fused_grouped", "scan_local_adam")
    assert trainer._dp == (d if split else 1)
    lines = [r for r in records if r.startswith(f"mesh {d}x{m}: ")]
    assert len(lines) == 1
    assert ("each rank" in lines[0]) == split
    assert ("the batch split over 'data'" in lines[0]) == (
        want == "scan" and d > 1)
    assert trainer._data_mode == (None if d == 1 or split else
                                  "split" if want == "scan" else "agree")
    assert ("row-sharded over" in lines[0]) == (m > 1)
    if "train.sparse_rows_force" in extra:
        assert any("declines under a mesh" in r for r in records)


def _logged(name):
    """A logger that keeps its messages, and the list they go to."""
    records = []
    logger = logging.getLogger(f"test_torch_parallel.{name}")
    logger.handlers[:] = []
    logger.propagate = False
    logger.setLevel(logging.INFO)
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger.addHandler(handler)
    return logger, records


@pytest.mark.parametrize("mesh,extra,says", [
    (2, {"train.fused_groups": "2", "train.dp_sync_every": "2"},
     "mesh 2x1: the fused_grouped tier"),
    (2, {"train.dp_local_adam": "True"}, "mesh 2x1: the fused tier"),
    (0, {"train.dp_local_adam": "True", "train.dp_sync_every": "2"},
     "train.dp_local_adam, train.dp_sync_every shape a data mesh"),
    (1, {"train.dp_delta_combine": "sum"},
     "train.dp_delta_combine shape a data mesh")])
def test_mesh_options_that_do_not_apply_are_named(toys, mesh, extra, says):
    """A data-parallel option that the run does not apply is named in
    the log, not ignored in silence: K on the grouped epoch (one combine
    an epoch), local Adam on the fused tier, any of them without a data
    mesh."""
    model, data, cfg = _trainer_args(_jcfg(toys, "BPR"), **extra)
    logger, records = _logged(f"options.{mesh}.{len(extra)}")
    Trainer(model, data, cfg, device="cpu", logger=logger,
            mesh=Mesh(mesh, 1, "cpu") if mesh else None)
    lines = [r for r in records if says in r]
    assert len(lines) == 1, records
    named = [k for k in extra if k.startswith("train.dp_")]
    assert f"{', '.join(named)} not applied" in lines[0] or (
        not mesh or mesh == 1) and "which this run does not have" in lines[0]


class _LoneRank(Mesh):
    """A rank of a data mesh alone in its process: a collective over an
    axis longer than 1 sees every other rank hold this rank's tensors (the
    scan tier's split sums over 'data' each step)."""

    def all_reduce_sum(self, t, axis):
        return t if self.shape[axis] == 1 else t * self.shape[axis]

    def all_gather(self, t, axis, dim=0):
        return torch.cat([t.detach()] * self.shape[axis], dim=dim)


def test_checkpoints_cross_the_mesh(toys, tmp_path):
    """Rank 0 of a mesh alone writes save.best's checkpoint (rank 1 of the
    same run writes nothing); it resumes unmeshed, and an unmeshed run's
    checkpoint resumes on a mesh rank, the parameters, moments, count and
    generators as saved.  The meshed runs' ranks each train alone
    (``_LoneRank``): the checkpoint's path is what is held here, the
    collectives are tests/test_torch_model_axis.py's."""
    extra = {"train.fused_kernel": "False", "epoches": "1",
             "save.best": "True"}
    runs = {}
    for tag, mesh in (("rank1", _LoneRank(2, 1, "cpu", rank=1)),
                      ("rank0", _LoneRank(2, 1, "cpu", rank=0)),
                      ("flat", None)):
        model, data, cfg = _trainer_args(_jcfg(
            toys, "BPR", **extra, saved_dir=str(tmp_path / tag)))
        trainer = Trainer(model, data, cfg, device="cpu", mesh=mesh)
        trainer.run()
        runs[tag] = (trainer, tmp_path / tag / "BPR")
    assert not runs["rank1"][1].exists()
    for saver, loader in (("rank0", None), ("flat", Mesh(2, 1, "cpu",
                                                          rank=1))):
        want, path = runs[saver]
        model, data, cfg = _trainer_args(_jcfg(toys, "BPR", **extra))
        trainer = Trainer(model, data, cfg, device="cpu", mesh=loader)
        params, state, epoch = trainer.resume(str(path))
        assert epoch == 1 and state.count == want.opt_state.count
        for name, p in params.items():
            assert torch.equal(p, want.params[name])
            assert torch.equal(state.mu[name], want.opt_state.mu[name])
        assert torch.equal(trainer._gen.get_state(),
                           want._gen.get_state())


def test_what_waits_for_the_model_axis_raises(toys):
    """A combine outside mean, sum and count raises; a device that
    contradicts the mesh's raises (what waited for the model axis, now
    ported, is tests/test_torch_model_axis.py's)."""
    jcfg = _jcfg(toys, "BPR")
    with pytest.raises(ValueError, match="dp_delta_combine"):
        Trainer(*_trainer_args(jcfg, **{"train.dp_delta_combine": "max"}),
                mesh=Mesh(2, 1, "cpu"))
    with pytest.raises(ValueError, match="differs from the mesh"):
        Trainer(*_trainer_args(jcfg), device="meta",
                mesh=Mesh(1, 1, "cpu"))


def test_a_rank_without_its_device_raises(monkeypatch):
    """A rank whose card is missing raises, from a mesh or from
    --distributed's launcher environment; neither falls back."""
    from cleverrec_tpu_torch.parallel import init_distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert Mesh(1, 1, "cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="cuda:1 is missing"):
        Mesh(2, 1, "cuda:1", rank=1)
    for key, value in (("RANK", "1"), ("WORLD_SIZE", "2"),
                       ("LOCAL_RANK", "1"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", "1")):
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="cuda:1 is missing"):
        init_distributed("cuda")


def _trainer_args(jcfg, **extra):
    cfg = Config({**jcfg.to_dict(), **extra})
    data = load_ranking_data(cfg)
    return (make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu"), data, cfg)


def test_sharding_rules_match_jax():
    """_is_embedding_table and pad_table_for_sharding are the JAX
    package's; the padding also takes another axis and fill."""
    meta = DataMeta(30, 40)
    for shape in ((30, 4), (31, 4), (40, 4), (41, 4), (70, 4), (32, 4),
                  (40,), (2, 40, 4)):
        x = np.zeros(shape, np.float32)
        assert _is_embedding_table(torch.as_tensor(x), meta) == \
            j_is_embedding_table(x, JMeta(30, 40)), shape
    t = np.arange(15, dtype=np.float32).reshape(5, 3)
    for n in (1, 2, 4, 5):
        np.testing.assert_array_equal(
            pad_table_for_sharding(torch.as_tensor(t), n).numpy(),
            _np(j_pad_table_for_sharding(t, n)))
    got = pad_table_for_sharding(torch.as_tensor(t), 2, dim=1,
                                 value=-np.inf)
    assert got.shape == (5, 4) and bool(torch.isinf(got[:, 3]).all())
