"""Metric-learning training in the port (CML, LRML, TransCF) against the
JAX package: row clipping and neighbourhood means, each model's loss,
grads and scorers, the CML sampler's layout, invariants and draws, the
CML epoch's plain version and the rows epoch's plain version on LRML's
spec against the Pallas kernels in interpret mode, the rows kernel's
plan, ascending ranks on every ranker, one and three epochs of each
trainer tier on JAX's own draws, and the CLI."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from cleverrec_tpu import ranking as j_ranking
from cleverrec_tpu.common import clip_rows_by_norm as j_clip
from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.evalx import Evaluator as JEvaluator
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.models.modules import \
    segment_mean_embeddings as j_segment_mean
from cleverrec_tpu.ops.pallas_train import cml_sentinel_bias as j_cml_bias
from cleverrec_tpu.ops.pallas_train import fused_cml_epoch as j_cml_epoch
from cleverrec_tpu.ops.pallas_train import fused_rows_epoch as j_rows_epoch
from cleverrec_tpu.serving import build_rerank_fn as j_build_rerank_fn
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import cli, ranking, sampling
from cleverrec_tpu_torch.common import clip_rows_by_norm
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.models.modules import segment_mean_embeddings
from cleverrec_tpu_torch.ops import train as T
from cleverrec_tpu_torch.serving import build_rerank_fn, build_retrieval_fn
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.utils.logging import get_logger
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("CML", "LRML", "TransCF")

# The plain versions against the Pallas kernels: f32 sums in another order
# (one-hot products there, index_add_ here; JAX's CML kernel takes the
# distances to the negatives in the expanded form |q|^2 - 2 q.p + |p|^2).
LOSS_RTOL = 1e-5
TABLE_RTOL, TABLE_ATOL = 2e-4, 2e-6
MOMENT_RTOL, MOMENT_ATOL = 2e-4, 2e-7
# One trainer epoch, port against JAX (tests/test_fused_train.py:95-106).
EPOCH_LOSS_RTOL = 1e-4
EPOCH_RTOL, EPOCH_ATOL = 1e-3, 1e-5
# Eval metrics after an epoch: means over the toy's test users of lists
# ranked from parameters equal to ~1e-6.
METRIC_ATOL = 2e-4
# Scores of the same params in the two packages: f32 sums of width 16.
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6

# lr 0.01 and stddev 0.1, as the NCF parity tests (tests/test_fused_train.py
# :214-220); each model's conf otherwise, cut to the toy.
TRAIN = {"epoches": "2", "batch_size": "64", "embed_size": "16",
         "lr": "0.01", "stddev": "0.1", "loss_func": "hinge"}
EXTRA = {"CML": {"margin": "0.5", "reg": "1.0", "neg_ratio": "3",
                 "is_pairwise": "False"},
         "LRML": {"margin": "0.2", "reg": "0.001", "mem_size": "6",
                  "neg_ratio": "2"},
         "TransCF": {"margin": "0.5", "reg1": "0.1", "reg2": "0.01",
                     "neg_ratio": "2"}}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _both_models(toy, name, **overrides):
    jcfg = base_config(toy, recommender=name,
                       **{**TRAIN, **EXTRA[name], **overrides})
    cfg = Config(jcfg.to_dict())
    jdata, data = j_load_ranking_data(jcfg), load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return (jcfg, jdata, jmodel), (cfg, data, model)


def _aux(model, data):
    """The trainer's aux as numpy: the train pairs and build_aux's arrays."""
    dd = build_device_data(data)
    return {"pos_u": dd.pos_u, "pos_i": dd.pos_i,
            **model.build_aux(dd, data)}


def _params(jmodel, model, seed):
    """JAX's initial params, loaded into the port's model."""
    params = dict(jmodel.init(jax.random.PRNGKey(seed)))
    load_params(model, {k: _np(v) for k, v in params.items()})
    return params


# -- the building blocks ------------------------------------------------------

def test_clip_rows_and_segment_means_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20, 8)).astype(np.float32) * np.geomspace(
        0.01, 5.0, 20, dtype=np.float32)[:, None]
    x[3] = 0.0
    got = clip_rows_by_norm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, _np(j_clip(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)
    norms = np.linalg.norm(got, axis=1)
    assert (norms <= 1.0 + 1e-6).all() and norms[3] == 0.0
    np.testing.assert_array_equal(got[:5], x[:5])         # short rows kept
    seg = rng.integers(0, 7, 50).astype(np.int32)
    val = rng.integers(0, 12, 50).astype(np.int32)
    table = rng.normal(size=(12, 8)).astype(np.float32)
    inv = (1.0 / np.maximum(np.bincount(seg, minlength=7), 1)).astype(
        np.float32)
    t_table = torch.as_tensor(table).requires_grad_()
    out = segment_mean_embeddings(torch.as_tensor(seg), torch.as_tensor(val),
                                  t_table, 7, torch.as_tensor(inv))

    def j_fn(tb):
        return j_segment_mean(jnp.asarray(seg), jnp.asarray(val), tb, 7,
                              jnp.asarray(inv))

    np.testing.assert_allclose(out.detach().numpy(),
                               _np(j_fn(jnp.asarray(table))), rtol=1e-6,
                               atol=1e-7)
    weights = rng.normal(size=(7, 8)).astype(np.float32)
    (out * torch.as_tensor(weights)).sum().backward()
    want = jax.grad(lambda tb: jnp.sum(j_fn(tb) * weights))(
        jnp.asarray(table))
    np.testing.assert_allclose(t_table.grad.numpy(), _np(want), rtol=1e-6,
                               atol=1e-7)


# -- the models -------------------------------------------------------------

def _batch(rng, data, name, n=50, k=3):
    batch = {"u": rng.integers(0, data.user_nums, n).astype(np.int32),
             "i": rng.integers(0, data.item_nums, n).astype(np.int32),
             "w": (rng.random(n) < 0.8).astype(np.float32)}
    if name == "CML":
        negs = rng.integers(0, data.item_nums, (n, k)).astype(np.int32)
        negs[:, 1] = negs[:, 0]                     # a duplicated negative
        batch["negs"] = negs
    else:
        batch["j"] = rng.integers(0, data.item_nums, n).astype(np.int32)
    return batch


@pytest.mark.parametrize("name", MODELS)
def test_model_loss_and_grads_match_jax(toy_dataset, name):
    (_, _, jmodel), (_, data, model) = _both_models(toy_dataset, name)
    params = _params(jmodel, model, 3)
    assert [n for n, _ in model.named_parameters()] == list(params)
    assert model.cml_like and jmodel.cml_like
    aux = _aux(model, data)
    batch = _batch(np.random.default_rng(8), data, name)
    want, grads = jax.value_and_grad(jmodel.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in aux.items()})
    loss = model.loss({k: torch.as_tensor(v) for k, v in batch.items()},
                      {k: torch.as_tensor(v) for k, v in aux.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    # TransCF's neighbour means sum up to a user's whole history: its
    # grads carry f32 sums of another order.
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(grads[n]), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("name", MODELS)
def test_model_scores_match_jax(toy_dataset, name):
    (_, _, jmodel), (_, data, model) = _both_models(toy_dataset, name,
                                                    stddev="0.5")
    params = _params(jmodel, model, 4)
    aux = _aux(model, data)
    j_aux = {k: jnp.asarray(v) for k, v in aux.items()}
    t_aux = {k: torch.as_tensor(v) for k, v in aux.items()}
    rng = np.random.default_rng(9)
    u = rng.integers(0, data.user_nums, 40).astype(np.int32)
    i = rng.integers(0, data.item_nums, 40).astype(np.int32)
    users = torch.as_tensor(u[:7]).long()
    with torch.no_grad():
        got = model.score_pairs(torch.as_tensor(u).long(),
                                torch.as_tensor(i).long(), t_aux)
        np.testing.assert_allclose(
            got.numpy(), _np(jmodel.score_pairs(params, jnp.asarray(u),
                                                jnp.asarray(i), j_aux)),
            rtol=SCORE_RTOL, atol=SCORE_ATOL)
        want_all = _np(jmodel.score_all(params, jnp.asarray(u[:7]), j_aux))
        np.testing.assert_allclose(model.score_all(users, t_aux).numpy(),
                                   want_all, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        if name != "CML":
            assert not hasattr(model, "dot_decomposition")
            return
        # stddev 0.5 at width 16: every user row is past norm 1, so the
        # full-catalog scores are of clipped rows, the pair scores not.
        assert (model.P.norm(dim=1) > 1).all()
        for got_x, want_x in zip(model.dot_decomposition(users, t_aux),
                                 jmodel.dot_decomposition(
                                     params, jnp.asarray(u[:7]), j_aux)):
            np.testing.assert_allclose(got_x.numpy(), _np(want_x),
                                       rtol=SCORE_RTOL, atol=SCORE_ATOL)
        uv, table, bias = model.dot_decomposition(users, t_aux)
        offset = (clip_rows_by_norm(model.P[users]) ** 2).sum(dim=1)
        np.testing.assert_allclose((uv @ table.T + bias).numpy(),
                                   want_all - offset.numpy()[:, None],
                                   rtol=1e-4, atol=1e-5)


# -- the CML sampler --------------------------------------------------------

def test_cml_epoch_layout_and_invariants(toy_dataset):
    """The trainer's static layout equals the JAX trainer's; one epoch's
    draw holds the same (u, i, w) rows as the JAX sampler's, K negatives
    per row, none of them seen, and w = 0 exactly on the padding rows."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(
        toy_dataset, "CML", **{"train.fused_kernel": "False"})
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    want = j_tr.arrays["cml_static"]
    assert sorted(tr._static) == sorted(set(want) - {"ord_w"})
    for k, v in tr._static.items():
        np.testing.assert_array_equal(v.numpy(), _np(want[k]), err_msg=k)
    assert tr.n_pairs == j_tr.n_pairs == len(build_device_data(data).pos_u)
    assert tr.steps_per_epoch == j_tr.steps_per_epoch
    tr.init_state()
    ep = tr.sample_epoch()
    jep = j_tr._scan_parts[0](jax.random.PRNGKey(0), j_tr.arrays)[0]
    assert sorted(ep) == sorted(jep) == ["i", "negs", "u", "w"]
    k = cfg.neg_ratio
    assert ep["negs"].shape == (tr.steps_per_epoch, cfg.batch_size, k)
    assert ep["negs"].dtype == torch.int32
    flat = {n: v.reshape(-1).numpy() for n, v in ep.items() if n != "negs"}
    rows = lambda *c: np.unique(np.stack(c, 1), axis=0,  # noqa: E731
                                return_counts=True)
    for got, exp in zip(rows(*(flat[n] for n in "uiw")),
                        rows(*(_np(jep[n]).reshape(-1) for n in "uiw"))):
        np.testing.assert_array_equal(got, exp)
    real = flat["w"] == 1
    assert real.sum() == tr.n_pairs and (flat["w"][~real] == 0).all()
    negs = ep["negs"].reshape(-1, k).numpy()
    for u, i, ns in zip(flat["u"][real], flat["i"][real], negs[real]):
        assert i in data.ui_train[u]
        assert all(0 <= n < data.item_nums and n not in data.ui_train[u]
                   for n in ns)


def test_cml_negatives_are_uniform_over_the_complement():
    """One user, many rows, K columns: the negatives fill the complement
    of the seen set uniformly (chi-square), in every column."""
    id_range, k = 300, 5
    seen = {0: list(range(0, 120, 2)) + [id_range - 1], 1: [3, 4]}
    table = sampling.build_member_table(seen, 2, id_range)
    n_pairs = 12000
    pos_i = np.asarray(seen[0][:40], np.int32)[np.arange(n_pairs) % 40]
    static = {n: torch.as_tensor(v) for n, v in sampling.pairwise_epoch_static(
        np.zeros(n_pairs, np.int32), pos_i, table.lens, id_range, n_pairs,
        1).items()}
    t = sampling.cml_epoch_tensors(
        torch.Generator().manual_seed(6), static, torch.as_tensor(table.rows),
        torch.as_tensor(table.lens), n_pairs, n_pairs // 100, 100,
        neg_ratio=k)
    negs = t["negs"].reshape(-1, k).numpy()
    free = np.setdiff1d(np.arange(id_range), seen[0])
    assert np.isin(negs, free).all()
    for col in range(k):
        counts = np.bincount(np.searchsorted(free, negs[:, col]),
                             minlength=free.size)
        assert scipy.stats.chisquare(counts).pvalue > 1e-3, col
    assert (t["w"] == 1).all()


# -- the CML epoch against the Pallas kernel -----------------------------------

def _cml_inputs(rng, u_n, i_n, d, k, steps, b, t0):
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.2
    negs = rng.integers(0, i_n, (steps, b, k))
    negs[:, :, 1] = negs[:, :, 0]                   # a duplicated negative
    ids = [np.where(invalid, u_pad - 1, rng.integers(0, u_n, (steps, b))),
           np.where(invalid, i_pad - 1, rng.integers(0, i_n, (steps, b))),
           np.where(invalid[..., None], i_pad - 1, negs)]
    state = [rng.normal(size=(n, d)).astype(np.float32) * 0.1
             for n in (u_n, i_n)]
    for n in (u_n, u_n, i_n, i_n):
        m = rng.normal(size=(n, d)).astype(np.float32) * 1e-2
        state.append(np.zeros_like(m) if not t0 else
                     (np.abs(m) * 1e-2 if len(state) % 2 else m))
    return [x.astype(np.int32) for x in ids], state, invalid


@pytest.mark.parametrize("t0", [0, 7])
def test_cml_epoch_plain_version_matches_pallas(t0):
    """fused_cml_epoch_ref against JAX's fused_cml_epoch (2.8) in interpret
    mode: sentinel rows in all three id arrays, a duplicated negative,
    and the loss with each sentinel row's cml_sentinel_bias in both."""
    rng = np.random.default_rng(21 + t0)
    u_n, i_n, d, k, steps, b = 29, 41, 8, 4, 3, 48
    opts = dict(lr=0.02, reg=0.5, margin=0.3, item_nums=i_n)
    ids, state, invalid = _cml_inputs(rng, u_n, i_n, d, k, steps, b, t0)
    want = j_cml_epoch(*(jnp.asarray(x) for x in state),
                       *(jnp.asarray(x) for x in ids), t0, blk=16,
                       interpret=True, **opts)
    got = [_t(x) for x in state]
    before = dict(T.launches)
    loss = T.fused_cml_epoch(*got, *(_t(x) for x in ids), t0, **opts)
    assert T.launches == before                  # CPU tensors: plain path
    assert float(loss) == pytest.approx(float(want[6]), rel=LOSS_RTOL)
    for n, (g, w) in enumerate(zip(got, want[:6])):
        rtol, atol = ((TABLE_RTOL, TABLE_ATOL) if n < 2
                      else (MOMENT_RTOL, MOMENT_ATOL))
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=rtol, atol=atol,
                                   err_msg=f"state {n}")
    bias = T.cml_sentinel_bias(opts["margin"], i_n, k)
    assert bias == pytest.approx(j_cml_bias(opts["margin"], i_n, k),
                                 rel=1e-12)
    assert invalid.sum() > 0


def test_cml_epoch_sentinel_rows_cost_their_bias_only():
    """Steps of sentinel rows only, no regulariser: the loss is n times
    cml_sentinel_bias, and Adam with zero grads leaves fresh state as it
    was."""
    rng = np.random.default_rng(5)
    ids, state, _ = _cml_inputs(rng, 9, 13, 8, 3, 2, 10, 0)
    u_pad, i_pad = T.sentinel_dims(9, 13)
    ids = [np.full_like(ids[0], u_pad - 1), np.full_like(ids[1], i_pad - 1),
           np.full_like(ids[2], i_pad - 1)]
    got = [_t(x) for x in state]
    loss = T.fused_cml_epoch(*got, *(_t(x) for x in ids), 0, lr=0.1, reg=0.0,
                             margin=0.7, item_nums=13)
    assert float(loss) == pytest.approx(20 * T.cml_sentinel_bias(0.7, 13, 3),
                                        rel=1e-6)
    for g, s in zip(got, state):
        np.testing.assert_array_equal(g.numpy(), s)


def test_cml_epoch_rejects_bad_input():
    rng = np.random.default_rng(6)
    ids, state, _ = _cml_inputs(rng, 9, 13, 8, 3, 2, 10, 0)
    state, ids = [_t(x) for x in state], [_t(x) for x in ids]
    opts = dict(lr=0.1, reg=1.0, margin=1.0, item_nums=13)
    with pytest.raises(TypeError):
        T.fused_cml_epoch(*state, *ids[:2], ids[2].long(), 0, **opts)
    with pytest.raises(ValueError, match="negatives"):
        T.fused_cml_epoch(*state, *ids[:2], ids[2][:, :5], 0, **opts)
    with pytest.raises(ValueError, match="match"):
        T.fused_cml_epoch(*state[:2], state[2][:3], *state[3:], *ids, 0,
                          **opts)


# -- LRML's rows epoch --------------------------------------------------------

@pytest.mark.parametrize("t0", [0, 7])
def test_rows_epoch_plain_version_on_lrml_matches_pallas(toy_dataset, t0):
    """The plain rows epoch on the port LRML's spec against JAX's
    fused_rows_epoch (2.6) in interpret mode on the JAX model's spec:
    planes (u, i, j) with sentinel rows, K and M as dense params."""
    (_, _, jmodel), (_, _, model) = _both_models(toy_dataset, "LRML",
                                                 embed_size="8",
                                                 mem_size="5")
    jspec, spec = jmodel.fused_rows_spec(), model.fused_rows_spec()
    assert spec["planes"] == jspec["planes"] and spec["dense"] == \
        jspec["dense"] and spec["floats"] == jspec["floats"] == ()
    rng = np.random.default_rng(31 + t0)
    u_n, i_n, d, mem, steps, b, lr = 29, 41, 8, 5, 3, 48, 0.02
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.2
    planes = [np.where(invalid, (u_pad if sd == "u" else i_pad) - 1,
                       rng.integers(0, u_n if sd == "u" else i_n,
                                    (steps, b))).astype(np.int32)
              for _, sd in spec["planes"]]
    shapes = [(u_n, d), (i_n, d), (d, mem), (mem, d)]
    params = [rng.normal(size=s).astype(np.float32) * 0.3 for s in shapes]
    moments = []
    for s in shapes:
        m = rng.normal(size=s).astype(np.float32) * 1e-2
        moments.append((m, np.abs(m) * 1e-2) if t0 else
                       (np.zeros(s, np.float32), np.zeros(s, np.float32)))

    def state(k, conv):
        vals = [params[n] if k is None else moments[n][k] for n in range(4)]
        return conv(vals)

    def jax_side(vals):
        return (jnp.asarray(vals[0]), jnp.asarray(vals[1]),
                (jnp.asarray(vals[2]), jnp.asarray(vals[3])))

    def port_side(vals):
        return ((_t(vals[0]),), (_t(vals[1]),), (_t(vals[2]), _t(vals[3])))

    sides = ("u", "i", "i")
    want = j_rows_epoch(*(x for k in (None, 0, 1) for x in state(k, jax_side)),
                        tuple(jnp.asarray(p) for p in planes), (),
                        jnp.asarray(t0, jnp.int32), sides=sides,
                        row_loss=jspec["row_loss"], lr=lr, blk=16,
                        interpret=True)
    got = [state(k, port_side) for k in (None, 0, 1)]
    before = dict(T.launches)
    loss = T.fused_rows_epoch(*(x for g in got for x in g),
                              [_t(p) for p in planes], [], t0, sides=sides,
                              spec=spec, lr=lr)
    assert T.launches == before
    assert float(loss) == pytest.approx(float(want[9]), rel=LOSS_RTOL)
    for k, (pu, qi, dense) in enumerate(got):
        rtol, atol = ((TABLE_RTOL, TABLE_ATOL) if k == 0
                      else (MOMENT_RTOL, MOMENT_ATOL))
        w_pu, w_qi, w_dense = want[3 * k:3 * k + 3]
        for label, g, w in (("P", pu[0], w_pu), ("Q", qi[0], w_qi),
                            ("K", dense[0], w_dense[0]),
                            ("M", dense[1], w_dense[1])):
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=rtol,
                                       atol=atol, err_msg=f"{label}, {k}")


def test_rows_epoch_plan_takes_lrml_and_declines_other_forms(toy_dataset):
    (_, _, _), (_, _, model) = _both_models(toy_dataset, "LRML")
    spec = model.fused_rows_spec()
    plan = T.rows_epoch_plan(spec)
    assert plan["form"] == "lrml" and (plan["d"], plan["mem"]) == (16, 6)
    assert (plan["margin"], plan["reg"]) == (0.2, 0.001)
    assert plan["smem_bytes"] <= T.SMEM_LIMIT
    # The conf's width (d 128, mem 50) at its batch of 6,144 rows on an
    # H100's 132 SMs: tiles of 24 rows, two a block, one wave of 128
    # blocks; mem padded to 52; a block's slice holds dK, dM and its loss.
    conf = T.rows_epoch_plan({**spec, "lrml": {**spec["lrml"], "d": 128,
                                               "mem": 50}}, 6144, 132)
    assert (conf["rows"], conf["tiles"], conf["blocks"]) == (24, 256, 128)
    assert (conf["mem_pad"], conf["slice"]) == (52, 2 * 128 * 50 + 1)
    assert conf["smem_bytes"] <= T.SMEM_LIMIT
    for bad, match in (
            ({"lrml": None}, "neither"),
            ({"lrml": {**spec["lrml"], "loss": "bpr"}}, "hinge"),
            ({"planes": spec["planes"][:2]}, "planes"),
            ({"dense": ("K",)}, "dense"),
            ({"lrml": {**spec["lrml"], "d": 4096, "mem": 1000}},
             "shared memory")):
        with pytest.raises(ValueError, match=match):
            T.rows_epoch_plan({**spec, **bad})


@pytest.mark.parametrize("d,mem,b,sms", [
    (128, 50, 6144, 132), (128, 50, 6144, 1), (128, 50, 6144, 7),
    (128, 50, 6144, 100), (128, 50, 6145, 132), (128, 50, 6144, 1000),
    (18, 50, 6144, 132), (16, 6, 64, 132), (40, 7, 37, 132),
    (128, 50, 1, 132), (128, 50, 3, 132), (128, 50, 0, 132)])
def test_lrml_plan_fills_one_wave_within_shared_memory(d, mem, b, sms):
    """LRML's tiles: even, within shared memory, mem padded to a multiple
    of 4; at most one block an SM, each taking the fewest tiles that the
    largest tile which fits allows, in equal shares."""
    plan = T.lrml_plan(d, mem, b, sms)
    rows, tiles, blocks = plan["rows"], plan["tiles"], plan["blocks"]
    fits = [r for r in range(2, T.ROW_MAX + 1, 2)
            if T._lrml_smem(d, mem, r) <= T.SMEM_LIMIT]
    assert rows % 2 == 0 and 2 <= rows <= fits[-1]
    assert plan["smem_bytes"] == T._lrml_smem(d, mem, rows) <= T.SMEM_LIMIT
    assert plan["mem_pad"] % 4 == 0 and mem <= plan["mem_pad"] < mem + 4
    assert tiles == -(-b // rows)
    if not b:
        assert blocks == 0
        return
    per_block = -(-tiles // blocks)
    assert blocks <= sms and per_block == max(1, -(-(-(-b // fits[-1])) // sms))
    assert (blocks - 1) * per_block < tiles      # no block left idle
    # A tile two rows smaller would need more tiles a block.
    assert rows == 2 or (rows - 2) * per_block < -(-b // sms)


# -- ascending ranks ----------------------------------------------------------

def _seen_rows(data, users):
    rows = [sorted(data.ui_train.get(int(u), ())) for u in users]
    width = max(1, max(len(r) for r in rows))
    out = np.full((len(users), width), data.item_nums, np.int32)
    bits = np.zeros((len(users), -(-data.item_nums // 32)), np.uint32)
    for n, r in enumerate(rows):
        out[n, :len(r)] = r
        r = np.asarray(r, np.int64)
        np.bitwise_or.at(bits[n], r >> 5, (np.uint32(1) << (r & 31))
                         .astype(np.uint32))
    return out, bits


def _same_ids(got, want, vals, tol=1e-5):
    """ids equal except among values tied within tol."""
    for r, j in zip(*np.nonzero(got != want)):
        others = np.delete(vals[r], j)
        assert (np.abs(others - vals[r, j]) <= tol).any() or abs(
            vals[r, j] - vals[r, -1]) <= tol, (r, j)


@pytest.mark.parametrize("name", ["CML", "TransCF"])
def test_full_catalog_ranks_ascend_as_jax(toy_dataset, name):
    """rank_dense (and, for CML, rank_fused's plain path) on a distance
    model give JAX's ids on the same params, best (nearest) first; no
    seen item surfaces."""
    (_, _, jmodel), (_, data, model) = _both_models(toy_dataset, name)
    params = _params(jmodel, model, 12)
    aux = _aux(model, data)
    j_aux = {k: jnp.asarray(v) for k, v in aux.items()}
    t_aux = {k: torch.as_tensor(v) for k, v in aux.items()}
    users = np.arange(12, dtype=np.int32)
    rows, bits = _seen_rows(data, users)
    k = 10
    wv, wi = map(_np, j_ranking.rank_dense(jmodel, params, j_aux,
                                           jnp.asarray(users),
                                           jnp.asarray(rows), k))
    v, i = ranking.rank_dense(model, t_aux, torch.as_tensor(users).long(),
                              torch.as_tensor(rows).long(), k)
    np.testing.assert_allclose(v.numpy(), wv, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    _same_ids(i.numpy(), wi, v.numpy())
    with torch.no_grad():
        dist = model.score_all(torch.as_tensor(users).long(), t_aux).numpy()
    for r, u in enumerate(users):
        assert not set(i[r].tolist()) & set(data.ui_train.get(int(u), ()))
        unseen = np.setdiff1d(np.arange(data.item_nums),
                              list(data.ui_train.get(int(u), ())))
        assert dist[r, i[r, 0]] == pytest.approx(dist[r, unseen].min())
    if name != "CML":
        return
    fv, fi = ranking.rank_fused(model, t_aux, torch.as_tensor(users).long(),
                                torch.as_tensor(bits.view(np.int32)), k)
    jfv, jfi = map(_np, j_ranking.rank_fused(jmodel, params, j_aux,
                                             jnp.asarray(users),
                                             jnp.asarray(bits), k,
                                             interpret=True))
    np.testing.assert_allclose(fv.numpy(), jfv, rtol=1e-4, atol=1e-5)
    _same_ids(fi.numpy(), jfi, fv.numpy())
    _same_ids(fi.numpy(), i.numpy(), fv.numpy())      # the dense ranking's


@pytest.mark.parametrize("name", MODELS)
def test_candidate_ranks_and_rerank_ascend_as_jax(toy_dataset, name):
    """The candidate protocol and build_rerank_fn on a distance model: the
    nearest candidate first, as JAX's; padding never surfaces."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(toy_dataset,
                                                             name)
    params = _params(jmodel, model, 13)
    aux = _aux(model, data)
    j_aux = {k: jnp.asarray(v) for k, v in aux.items()}
    rng = np.random.default_rng(14)
    u = np.arange(8, dtype=np.int64)
    cand = rng.integers(0, data.item_nums, (8, 12))
    cand[:, -2:] = -1                                  # padding
    want_i, want_v = map(_np, j_build_rerank_fn(jmodel, params, j_aux, k=5)(
        jnp.asarray(u), jnp.asarray(cand)))
    got_i, got_v = build_rerank_fn(model, aux, k=5, device="cpu")(u, cand)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    _same_ids(got_i.numpy(), want_i, got_v.numpy())
    assert (got_i >= 0).all() and (got_v <= 0).all()
    ev = Evaluator(model, build_device_data(data), cfg, device="cpu")
    j_ev = JEvaluator(jmodel, j_build_device_data(jdata), jcfg)
    assert ev.mode == j_ev.mode == "candidate"
    got = ev.recommend_topk(aux)
    want = j_ev.recommend_topk(params, j_aux)
    np.testing.assert_array_equal(got, want)


def test_distance_model_fused_eval_and_retrieval_equal_dense(toy_dataset):
    """CML on a random split: full_fused eval (the masked-scoring plain
    path on a negated decomposition) equals full eval, and fused retrieval
    gives the dense retrieval's ids with no seen item."""
    (_, _, jmodel), (cfg, data, model) = _both_models(
        toy_dataset, "CML", **{"data.split_way": "rs",
                               "test.neg_samples": "0"})
    _params(jmodel, model, 15)
    dd = build_device_data(data)
    full = Evaluator(model, dd, cfg, device="cpu")
    fused = Evaluator(model, dd, cfg.with_overrides(
        **{"eval.fused_kernel": "True"}), device="cpu")
    assert (full.mode, fused.mode) == ("full", "full_fused")
    want, got = full.evaluate(), fused.evaluate()
    for k in cfg.topk:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(full.recommend_topk(),
                                  fused.recommend_topk())
    users = np.arange(data.user_nums)
    d_ids, d_vals = build_retrieval_fn(model, {}, dd, k=10, backend="dense",
                                       device="cpu")(users)
    f_ids, f_vals = build_retrieval_fn(model, {}, dd, k=10, backend="fused",
                                       device="cpu")(users)
    offset = (clip_rows_by_norm(model.P.detach()) ** 2).sum(dim=1)
    # The fused scores leave out each user's |u|^2 (serving.py).
    np.testing.assert_allclose(f_vals.numpy(),
                               (d_vals + offset[:, None]).numpy(),
                               rtol=1e-4, atol=1e-5)
    _same_ids(f_ids.numpy(), d_ids.numpy(), f_vals.numpy())
    for u in users:
        assert not set(f_ids[u].tolist()) & set(data.ui_train.get(int(u),
                                                                 ()))


# -- the trainer ------------------------------------------------------------

def _close_epoch(trainer_out, jax_out, names):
    (params, state, loss), (j_params, j_state, j_loss) = trainer_out, jax_out
    assert float(loss) == pytest.approx(float(j_loss), rel=EPOCH_LOSS_RTOL)
    assert state.count == int(j_state[0].count)
    for name in names:
        for got, want in ((params[name], j_params[name]),
                          (state.mu[name], j_state[0].mu[name]),
                          (state.nu[name], j_state[0].nu[name])):
            np.testing.assert_allclose(got.detach().numpy(), _np(want),
                                       rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                       err_msg=name)


def _scan_cfg(toy, name):
    return base_config(toy, recommender=name,
                       **{**TRAIN, **EXTRA[name],
                          "train.fused_kernel": "False"})


TIERS = [("CML", False), ("CML", True), ("LRML", False), ("LRML", True),
         ("TransCF", False)]


@pytest.mark.parametrize("name,fused", TIERS)
def test_one_epoch_matches_jax(toy_dataset, name, fused):
    """From the same params and Adam state (one JAX epoch in) and the same
    sampled rows: the port's scan tier against the JAX scan tier, and its
    fused tier (the plain version on the CPU) against the Pallas kernel in
    interpret mode."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(
        toy_dataset, name, **{"train.fused_kernel": str(fused)})
    j_scan = JTrainer(jmodel, jdata, _scan_cfg(toy_dataset, name))
    p0, o0 = j_scan.init_state()
    p0, o0, _ = j_scan.train_epoch(p0, o0)
    p0 = {k: np.array(v) for k, v in p0.items()}    # the next call donates
    key = jax.random.PRNGKey(11)
    build_xs, run_scan = j_scan._scan_parts[:2]
    epoch_batch, step_keys = build_xs(key, j_scan.arrays)
    jp0 = {k: jnp.asarray(v) for k, v in p0.items()}
    if fused:
        j_fused = JTrainer(jmodel, jdata, jcfg)
        sample, apply, correct = j_fused._fused_parts
        ids = sample(key, j_fused.arrays)
        p1, o1, raw = apply(jp0, o0, ids)
        want = (p1, o1, correct(raw))
        # The JAX fused sampler's ids are the scan tier's draw.
        w = _np(epoch_batch["w"])
        u_ids = ids[0][0] if name == "LRML" else ids[0]    # rows: planes
        np.testing.assert_array_equal(_np(u_ids)[w == 1],
                                      _np(epoch_batch["u"])[w == 1])
    else:
        p1, o1, losses = run_scan(jp0, o0, (epoch_batch, step_keys),
                                  j_scan.arrays, lambda batch: batch)
        want = (p1, o1, jnp.mean(losses))

    trainer = Trainer(model, data, cfg, device="cpu")
    assert trainer.fused == fused
    assert trainer.steps_per_epoch == j_scan.steps_per_epoch
    load_params(model, p0)
    state = adam_state_from_jax(o0[0].count,
                                {k: _np(v) for k, v in o0[0].mu.items()},
                                {k: _np(v) for k, v in o0[0].nu.items()},
                                "cpu", model=model)
    tensors = {k: _t(v) for k, v in epoch_batch.items()}
    got = trainer._run_epoch(dict(model.named_parameters()), state, tensors)
    _close_epoch(got, want, list(p0))


@pytest.mark.parametrize("name,fused", TIERS)
def test_three_epochs_on_the_jax_draws_match_jax(toy_dataset, name, fused):
    """Three epochs from JAX's initial parameters, each on the JAX
    sampler's draw, then eval: the port's parameters, loss and metrics
    follow the JAX trainer's epoch by epoch (TransCF's eval reads the
    trainer's aux)."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(
        toy_dataset, name, **{"train.fused_kernel": str(fused)})
    j_tr = JTrainer(jmodel, jdata, jcfg)
    build_xs = JTrainer(jmodel, jdata, _scan_cfg(toy_dataset, name)
                        )._scan_parts[0]
    params, state = j_tr.init_state()
    trainer = Trainer(model, data, cfg, device="cpu")
    assert trainer.fused == fused
    assert sorted(trainer.aux) == sorted(
        ["pos_u", "pos_i"] + (["inv_deg_i", "inv_deg_u"]
                              if name == "TransCF" else []))
    load_params(model, {k: _np(v) for k, v in params.items()})
    t_params = dict(model.named_parameters())
    t_state = trainer.optimizer.init(t_params)
    for epoch in range(3):
        key = jax.random.PRNGKey(100 + epoch)
        batch, _ = build_xs(key, j_tr.arrays)
        params, state, loss = j_tr._epoch_body(params, state, key,
                                               j_tr.arrays)
        tensors = {k: _t(v) for k, v in batch.items()}
        t_params, t_state, t_loss = trainer._run_epoch(t_params, t_state,
                                                       tensors)
        _close_epoch((t_params, t_state, t_loss), (params, state, loss),
                     list(params))
        want, got = j_tr.evaluate(params), trainer.evaluate()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=METRIC_ATOL)


def test_fused_tier_eligibility(toy_dataset):
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("test_torch_metric.eligibility")
    logger.addHandler(Keep())
    logger.setLevel(logging.INFO)
    on = {"train.fused_kernel": "True"}
    for name, extra, fused in (
            ("CML", {}, False), ("CML", on, True), ("LRML", on, True),
            ("TransCF", on, False), ("CML", {**on, "loss_func": "bpr"},
                                     False),
            ("CML", {**on, "optimizer": "SGD"}, False)):
        (_, _, _), (cfg, data, model) = _both_models(toy_dataset, name,
                                                     **extra)
        assert Trainer(model, data, cfg, device="cpu",
                       logger=logger).fused == fused, (name, extra)
    assert records == []
    # LRML with the bpr loss: the kernel has the hinge's backward only, so
    # the rows plan declines it to the scan tier with a log line.
    (_, _, _), (cfg, data, model) = _both_models(
        toy_dataset, "LRML", loss_func="bpr", **on)
    assert not Trainer(model, data, cfg, device="cpu", logger=logger).fused
    assert len(records) == 1 and "hinge" in records[0]


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_cli_trains_each_model(toy_dataset, tmp_path, capsys, name):
    """Each model through the CLI on its conf, cut to the toy, with its
    fused tier on where it has one."""
    props = tmp_path / "global.properties"
    props.write_text("\n".join([
        "[default]", "recommender=BPR", "model_type=ranking",
        f"data.root_dir={toy_dataset['root']}",
        f"data.dataset={toy_dataset['name']}",
        "data.file_name=ratings.csv", "data.sep=,", "data.format=UIRT",
        "data.split_way=loo", "test.neg_samples=10", "test.batch_size=16",
        "topk=[5,10]", f"log.dir={tmp_path / 'logs'}", "seed=7", ""]))
    logger = logging.getLogger(f"cleverrec_tpu_torch.{name}")
    for h in list(logger.handlers):                  # the CLI makes it afresh
        logger.removeHandler(h)
        h.close()
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    try:
        get_logger(str(tmp_path / "logs"), name)
        logger.addHandler(Keep())
        rc = cli.main(["--config", str(props), "--conf-dir",
                       os.path.join(REPO, "conf"), "--model", name,
                       "--device", "cpu", "--set", "epoches=3",
                       "--set", "batch_size=64", "--set", "embed_size=16",
                       "--set", "mem_size=6", "--set", "neg_ratio=3",
                       "--set", "lr=0.01", "--set", "stddev=0.1",
                       "--set", "train.fused_kernel=True"])
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    assert rc == 0
    out = capsys.readouterr().out
    assert f"Current model: {name}" in out and "best_epoch: " in out
    epochs = [r.train for r in records if hasattr(r, "train")]
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    assert epochs[-1]["losses"][-1] < epochs[0]["losses"][0]
    best = [r.best for r in records if hasattr(r, "best")]
    assert len(best) == 1 and sorted(best[0]["metrics"]) == [5, 10]
