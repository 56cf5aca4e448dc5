"""NCF training in the port (GMF, MLP, NeuMF) against the JAX package:
the sigmoid cross-entropy, the pointwise sampler's layout, invariants and
uniform negatives, each model's loss, grads and scores, the GMF and tower
epoch kernels' plain versions against the Pallas kernels in interpret
mode, one and three epochs of each trainer tier on JAX's own draws, GMF's
full-catalog eval, and the CLI."""

import logging
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from cleverrec_tpu import sampling as j_sampling
from cleverrec_tpu.common import sigmoid_xent_loss as j_sigmoid_xent_loss
from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.evalx import Evaluator as JEvaluator
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.ops.pallas_train import fused_gmf_epoch as j_fused_gmf_epoch
from cleverrec_tpu.ops.pallas_train import fused_mlp_epoch as j_fused_mlp_epoch
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import cli, sampling
from cleverrec_tpu_torch.common import sigmoid_xent_loss
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import train as T
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.utils.logging import get_logger
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("GMF", "MLP", "NeuMF")

# The plain versions against the Pallas kernels: f32 sums in another order
# (the scatters are one-hot products there, index_add_ here), as
# tests/test_fused_train.py holds the kernels to optax.
LOSS_RTOL = 1e-5
TABLE_RTOL, TABLE_ATOL = 2e-4, 2e-6
MOMENT_RTOL, MOMENT_ATOL = 2e-4, 2e-7
# One trainer epoch, port against JAX (tests/test_fused_train.py:95-106).
EPOCH_LOSS_RTOL = 1e-4
EPOCH_RTOL, EPOCH_ATOL = 1e-3, 1e-5
# Eval metrics after an epoch: means over the toy's test users of lists
# ranked from parameters equal to ~1e-6.
METRIC_ATOL = 2e-4

# stddev 0.1, as tests/test_fused_train.py:214-220 explains: at 0.01 the
# near-cancelling row grads leave ulp-scale residuals that Adam turns
# into visible drift between any two summation orders.  lr 0.01: at 0.05
# an Adam step flips a near-zero-gradient weight of the tower by up to
# 0.1, and within three epochs one such flip in one order and not the
# other moves MLP's tables by ~1e-2.
TRAIN = {"epoches": "2", "batch_size": "64", "embed_size": "16",
         "layers": "[32,16]", "lr": "0.01", "neg_ratio": "2",
         "is_pairwise": "False", "loss_func": "cross_entropy",
         "reg": "0.01", "reg1": "0.01", "reg2": "0.02", "stddev": "0.1"}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("weighted", [False, True])
def test_sigmoid_xent_loss_matches_jax(weighted):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=200) * 8).astype(np.float32)
    x[:3] = [0.0, 90.0, -90.0]                     # the stable form's edges
    y = (rng.random(200) < 0.3).astype(np.float32)
    w = (rng.random(200) < 0.8).astype(np.float32) if weighted else None
    want = j_sigmoid_xent_loss(jnp.asarray(y), jnp.asarray(x),
                               None if w is None else jnp.asarray(w))
    got = sigmoid_xent_loss(_t(y), _t(x), None if w is None else _t(w))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# -- the pointwise sampler ----------------------------------------------

def _pointwise_setup(toy, neg_ratio=3, b=64):
    cfg = Config(base_config(toy, **TRAIN).to_dict())
    dd = build_device_data(load_ranking_data(cfg))
    rows_total = dd.num_pairs * (1 + neg_ratio)
    steps = -(-rows_total // b)
    args = (dd.pos_u, dd.pos_i, dd.seen.lens, dd.item_nums, steps * b,
            neg_ratio)
    return dd, rows_total, steps, b, args


def test_pointwise_epoch_invariants(toy_dataset):
    dd, rows_total, steps, b, args = _pointwise_setup(toy_dataset)
    neg_ratio = args[-1]
    static_np = sampling.pointwise_epoch_static(*args)
    j_static = j_sampling.pointwise_epoch_static(*args)
    assert sorted(static_np) == sorted(set(j_static) - {"ord_w"})
    for k, v in static_np.items():
        np.testing.assert_array_equal(v, j_static[k])
    static = {k: torch.as_tensor(v) for k, v in static_np.items()}
    t = sampling.pointwise_epoch_tensors(
        torch.Generator().manual_seed(0), static,
        torch.as_tensor(dd.seen.rows), torch.as_tensor(dd.seen.lens),
        rows_total, steps, b)
    assert t["u"].shape == t["y"].shape == (steps, b)
    assert t["i"].dtype == torch.int32 and t["y"].dtype == torch.float32
    u, i, y, w = (t[k].reshape(-1).numpy() for k in "uiyw")
    real = w == 1
    assert set(np.unique(w)) <= {0.0, 1.0} and real.sum() == rows_total
    # The JAX sampler's epoch holds the same (u, y, w) rows, shuffled.
    seen = j_sampling.MemberTable(*(jnp.asarray(x) for x in dd.seen[:2]),
                                  None)
    jt = j_sampling.pointwise_epoch_tensors(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in
                                j_static.items()}, seen, dd.item_nums,
        steps, b)
    rows = lambda *cols: np.unique(np.stack(cols, 1), axis=0,  # noqa: E731
                                   return_counts=True)
    for got, want in zip(rows(u, y, w), rows(*(_np(jt[k]).reshape(-1)
                                               for k in "uyw"))):
        np.testing.assert_array_equal(got, want)
    # Each train pair is one positive row with its own item, and
    # neg_ratio negative rows of its user with items the user never saw.
    pos = real & (y == 1)
    got = np.unique(np.stack([u[pos], i[pos]], 1), axis=0, return_counts=True)
    want = np.unique(np.stack([dd.pos_u, dd.pos_i], 1), axis=0,
                     return_counts=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    neg = real & (y == 0)
    assert neg.sum() == dd.num_pairs * neg_ratio
    np.testing.assert_array_equal(
        np.bincount(u[neg], minlength=dd.user_nums),
        np.bincount(dd.pos_u, minlength=dd.user_nums) * neg_ratio)
    words = dd.seen.bits.view(np.uint32)[u[neg], i[neg] >> 5]
    assert not ((words >> (i[neg] & 31).astype(np.uint32)) & 1).any()
    assert ((i >= 0) & (i < dd.item_nums)).all()


def test_pointwise_negatives_are_uniform_over_the_complement():
    rng = np.random.default_rng(4)
    id_range, user = 300, 0
    sets = {0: list(range(40)) + [id_range - 1] + [77, 150]}
    sets.update({e: rng.choice(id_range, 50, replace=False).tolist()
                 for e in (1, 2)})
    table = sampling.build_member_table(sets, 3, id_range)
    n_pairs, neg_ratio = 6000, 9
    pos_i = np.asarray(sets[user], np.int32)[
        rng.integers(0, len(sets[user]), n_pairs)]
    rows_total = n_pairs * (1 + neg_ratio)
    static = {k: torch.as_tensor(v) for k, v in sampling.pointwise_epoch_static(
        np.full(n_pairs, user, np.int32), pos_i, table.lens, id_range,
        rows_total, neg_ratio).items()}
    t = sampling.pointwise_epoch_tensors(
        torch.Generator().manual_seed(6), static, torch.as_tensor(table.rows),
        torch.as_tensor(table.lens), rows_total, rows_total // 100, 100)
    i, y = t["i"].reshape(-1).numpy(), t["y"].reshape(-1).numpy()
    np.testing.assert_array_equal(np.sort(i[y == 1]), np.sort(pos_i))
    unseen = np.setdiff1d(np.arange(id_range), table.rows[user])
    neg = i[y == 0]
    assert neg.size == n_pairs * neg_ratio and np.isin(neg, unseen).all()
    counts = np.bincount(np.searchsorted(unseen, neg), minlength=unseen.size)
    assert scipy.stats.chisquare(counts).pvalue > 1e-3


# -- the models -----------------------------------------------------------

def _both_models(toy, name, **overrides):
    jcfg = base_config(toy, **{**TRAIN, "recommender": name, **overrides})
    cfg = Config(jcfg.to_dict())
    jdata, data = j_load_ranking_data(jcfg), load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return (jcfg, jdata, jmodel), (cfg, data, model)


def _batch(rng, data, n=50):
    return {"u": rng.integers(0, data.user_nums, n).astype(np.int32),
            "i": rng.integers(0, data.item_nums, n).astype(np.int32),
            "y": (rng.random(n) < 0.3).astype(np.float32),
            "w": (rng.random(n) < 0.8).astype(np.float32)}


@pytest.mark.parametrize("name", MODELS)
def test_model_loss_and_grads_match_jax(toy_dataset, name):
    (_, _, jmodel), (_, data, model) = _both_models(toy_dataset, name)
    params = jmodel.init(jax.random.PRNGKey(3))
    load_params(model, {k: _np(v) for k, v in params.items()})
    assert [n for n, _ in model.named_parameters()] == list(params)
    batch = _batch(np.random.default_rng(8), data)
    want, grads = jax.value_and_grad(jmodel.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, {})
    loss = model.loss({k: torch.as_tensor(v) for k, v in batch.items()}, {})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    for n, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), _np(grads[n]), rtol=1e-5,
                                   atol=1e-8, err_msg=n)


@pytest.mark.parametrize("name", MODELS)
def test_model_scores_match_jax(toy_dataset, name):
    (_, _, jmodel), (_, data, model) = _both_models(toy_dataset, name,
                                                    stddev="0.5")
    params = jmodel.init(jax.random.PRNGKey(4))
    load_params(model, {k: _np(v) for k, v in params.items()})
    rng = np.random.default_rng(9)
    u = rng.integers(0, data.user_nums, 40).astype(np.int32)
    i = rng.integers(0, data.item_nums, 40).astype(np.int32)
    with torch.no_grad():
        got = model.score_pairs(torch.as_tensor(u).long(),
                                torch.as_tensor(i).long(), {})
        np.testing.assert_allclose(
            got.numpy(), _np(jmodel.score_pairs(params, jnp.asarray(u),
                                                jnp.asarray(i), {})),
            rtol=1e-5, atol=1e-7)
        users = torch.as_tensor(u[:7]).long()
        want_all = _np(jmodel.score_all(params, jnp.asarray(u[:7]), {}))
        np.testing.assert_allclose(model.score_all(users, {}).numpy(),
                                   want_all, rtol=1e-5, atol=1e-7)
        if name == "GMF":
            uv, table, bias = model.dot_decomposition(users, {})
            juv, jtable, jbias = jmodel.dot_decomposition(
                params, jnp.asarray(u[:7]), {})
            assert bias is None and jbias is None
            np.testing.assert_allclose(uv.numpy(), _np(juv), rtol=1e-6)
            np.testing.assert_array_equal(table.numpy(), _np(jtable))
            np.testing.assert_allclose(torch.sigmoid(uv @ table.T).numpy(),
                                       want_all, rtol=1e-5, atol=1e-7)
        else:
            assert not hasattr(model, "dot_decomposition")


# -- the epoch kernels' plain versions against the Pallas kernels --------

def _ids(rng, u_n, i_n, steps, b, y_rate):
    """u, i, y, invalid [steps, b]; the JAX kernels' sign-encoded user
    stream uz and item stream, and the port's sentinel-mapped ids."""
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    u = rng.integers(0, u_n, (steps, b)).astype(np.int32)
    i = rng.integers(0, i_n, (steps, b)).astype(np.int32)
    y = (rng.random((steps, b)) < y_rate).astype(np.float32)
    invalid = rng.random((steps, b)) < 0.15
    uz = np.where(invalid, u_pad, (u + 1) * np.where(y > 0, 1, -1))
    i_s = np.where(invalid, i_pad - 1, i).astype(np.int32)
    u_s = np.where(invalid, u_pad - 1, u).astype(np.int32)
    return uz.astype(np.int32), i_s, u_s, y, invalid


def _moments(rng, shape, t0):
    """(m, v) zero at t0 = 0, else random (v positive)."""
    if t0 == 0:
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    return (rng.normal(size=shape).astype(np.float32) * 1e-2,
            np.abs(rng.normal(size=shape)).astype(np.float32) * 1e-4)


def _close_state(got, want, names):
    """Params (first third) to the table tolerance, moments to theirs."""
    k = len(names)
    for n, (g, w) in enumerate(zip(got, want)):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        rtol, atol = ((TABLE_RTOL, TABLE_ATOL) if n < k
                      else (MOMENT_RTOL, MOMENT_ATOL))
        np.testing.assert_allclose(g, _np(w), rtol=rtol, atol=atol,
                                   err_msg=f"{names[n % k]}, part {n // k}")


@pytest.mark.parametrize("t0", [0, 7])
def test_gmf_epoch_plain_version_matches_pallas(t0):
    rng = np.random.default_rng(1 + t0)
    u_n, i_n, d, steps, b = 29, 41, 16, 4, 64
    uz, i_s, u_s, y, invalid = _ids(rng, u_n, i_n, steps, b, 0.3)
    tables = [rng.normal(size=shape).astype(np.float32) * s
              for shape, s in (((u_n, d), 0.1), ((i_n, d), 0.1), ((d,), 0.5))]
    moments = [m for x in tables for m in _moments(rng, x.shape, t0)]
    lr, reg = 0.01, 0.02
    want = j_fused_gmf_epoch(*(jnp.asarray(x) for x in (*tables, *moments,
                                                        uz, i_s)),
                             jnp.asarray(t0, jnp.int32), lr=lr, reg=reg,
                             blk=8, interpret=True)
    state = [_t(x) for x in (*tables, *moments)]
    before = dict(T.launches)
    loss = T.fused_gmf_epoch(*state, _t(u_s), _t(i_s), _t(y), t0, lr=lr,
                             reg=reg)
    assert T.launches == before                  # CPU tensors: plain path
    assert float(loss) == pytest.approx(float(want[9]), rel=LOSS_RTOL)
    assert float(loss) - invalid.sum() * T.LOG2 > 0
    # JAX's order: p, q, h, mp, vp, mq, vq, mh, vh.
    got = [state[k] for k in (0, 1, 2, 3, 5, 7, 4, 6, 8)]
    want = [want[k] for k in (0, 1, 2, 3, 5, 7, 4, 6, 8)]
    _close_state(got, want, ("P", "Q", "h"))


def test_gmf_epoch_sentinel_slots_change_nothing_but_the_loss():
    rng = np.random.default_rng(2)
    u_n, i_n, d = 29, 41, 16
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    state0 = [rng.normal(size=s).astype(np.float32)
              for s in ((u_n, d), (i_n, d), (d,))] + [
        np.zeros(s, np.float32) for s in ((u_n, d),) * 2 + ((i_n, d),) * 2
        + ((d,),) * 2]
    state = [_t(x) for x in state0]
    ids = [torch.full((3, 10), pad - 1, dtype=torch.int32)
           for pad in (u_pad, i_pad)]
    y = torch.ones((3, 10))
    loss = T.fused_gmf_epoch(*state, *ids, y, 0, lr=0.01, reg=0.02)
    assert float(loss) == pytest.approx(30 * T.LOG2, rel=1e-6)
    for got, want in zip(state, state0):
        np.testing.assert_array_equal(got.numpy(), want)


def _mlp_models(name):
    values = {"recommender": name, "model_type": "ranking", "embed_size": "8",
              "layers": "[16,8]", "reg": "0.02", "reg1": "0.02",
              "reg2": "0.03", "init_method": "normal", "stddev": "0.1",
              "topk": "[5]"}
    from cleverrec_tpu.config import Config as JConfig
    jmodel = j_make_model(JConfig(values), JMeta(23, 31))
    model = make_model(Config(values), DataMeta(23, 31), device="cpu")
    return jmodel, model


@pytest.mark.parametrize("t0", [0, 7])
@pytest.mark.parametrize("name", ["MLP", "NeuMF"])
def test_mlp_epoch_plain_version_matches_pallas(name, t0):
    jmodel, model = _mlp_models(name)
    params = {k: _np(v) for k, v in jmodel.init(jax.random.PRNGKey(t0)).items()}
    load_params(model, params)
    jspec, spec = jmodel.fused_mlp_spec(), model.fused_mlp_spec()
    assert (spec["u"], spec["i"], spec["dense"]) == (jspec["u"], jspec["i"],
                                                     jspec["dense"])
    rng = np.random.default_rng(7 + t0)
    steps, b, lr = 3, 64, 0.01
    uz, i_s, u_s, y, invalid = _ids(rng, 23, 31, steps, b, 0.4)
    w = (~invalid).astype(np.float32)
    moments = {k: _moments(rng, v.shape, t0) for k, v in params.items()}

    def groups(t):
        return (np.concatenate([t[n] for n in spec["u"]], axis=1),
                np.concatenate([t[n] for n in spec["i"]], axis=1),
                [t[n] for n in spec["dense"]])

    mu = {k: m for k, (m, _) in moments.items()}
    nu = {k: v for k, (_, v) in moments.items()}
    state = [groups(t) for t in (params, mu, nu)]
    jx = lambda g: (jnp.asarray(g[0]), jnp.asarray(g[1]),  # noqa: E731
                    tuple(jnp.asarray(x) for x in g[2]))
    want = j_fused_mlp_epoch(*jx(state[0]), *jx(state[1]), *jx(state[2]),
                             jnp.asarray(uz), jnp.asarray(i_s),
                             jnp.asarray(t0, jnp.int32),
                             row_loss=jspec["row_loss"], lr=lr, blk=8,
                             interpret=True)
    tx = [(_t(g[0]), _t(g[1]), [_t(x) for x in g[2]]) for g in state]
    before = dict(T.launches)
    loss = T.fused_mlp_epoch(*tx[0], *tx[1], *tx[2], _t(u_s), _t(i_s), _t(y),
                             _t(w), t0, spec=spec, lr=lr)
    assert T.launches == before
    assert float(loss) == pytest.approx(float(want[9]), rel=LOSS_RTOL)
    flat = lambda g: [g[0], g[1], *g[2]]  # noqa: E731
    names = ("PU", "QI") + spec["dense"]
    got = [x for g in tx for x in flat(g)]
    exp = [x for k in range(3) for x in flat(want[3 * k:3 * k + 3])]
    _close_state(got, exp, names)


def test_mlp_epoch_rejects_bad_input():
    _, model = _mlp_models("NeuMF")
    spec = model.fused_mlp_spec()
    p = {n: x.detach() for n, x in model.named_parameters()}
    pu = torch.cat([p[n] for n in spec["u"]], 1)
    qi = torch.cat([p[n] for n in spec["i"]], 1)
    dense = [p[n] for n in spec["dense"]]
    z = lambda ts: [torch.zeros_like(x) for x in ts]  # noqa: E731
    ids = torch.zeros((2, 4), dtype=torch.int32)
    col = torch.ones((2, 4))
    ok = (pu, qi, dense, *z([pu, qi]), z(dense), *z([pu, qi]), z(dense))
    T.fused_mlp_epoch(*ok, ids, ids, col, col, 0, spec=spec, lr=0.1)
    with pytest.raises(ValueError, match="W_0"):       # W_0 transposed
        T.fused_mlp_epoch(pu, qi, [dense[0].T, *dense[1:]], *ok[3:], ids, ids,
                          col, col, 0, spec=spec, lr=0.1)
    with pytest.raises(ValueError, match=r"h \(3,\)"):
        T.fused_mlp_epoch(pu, qi, [*dense[:-1], dense[-1][:3]], *ok[3:], ids,
                          ids, col, col, 0, spec=spec, lr=0.1)
    with pytest.raises(TypeError):
        T.fused_mlp_epoch(*ok, ids.long(), ids, col, col, 0, spec=spec, lr=0.1)
    with pytest.raises(ValueError, match="one shape"):
        T.fused_mlp_epoch(*ok, ids, ids, col[:, :3], col, 0, spec=spec,
                          lr=0.1)
    # The kernel's own limits, checked before any launch.
    assert T.mlp_epoch_plan(64, [(128, 64), (64, 32), (32, 16)], 6144,
                            132)["rows"] == 48
    with pytest.raises(ValueError, match="layers"):
        T.mlp_epoch_plan(0, [(8, 8)] * 5)
    with pytest.raises(ValueError, match="shared memory"):
        T.mlp_epoch_plan(0, [(1024, 512)])


# The tower kernel's row tile: ceil(B / SMs) rounded up to 16 rows, one
# wave of blocks; where that outgrows shared memory, the largest multiple
# of 16 that fits.  NeuMF's conf tower (dg 64) and MLP's (dg 0) at the
# main path's 6,144 rows on an H100 SXM (132 SMs), the batch edges, other
# SM counts; B = 0 asks for the smallest tile (the trainer's check).
@pytest.mark.parametrize("dg,b,sms,rows,blocks", [
    (64, 6144, 132, 48, 128), (0, 6144, 132, 48, 128),
    (64, 6145, 132, 48, 129), (64, 1, 132, 16, 1), (64, 47, 132, 16, 3),
    (64, 6144, 108, 64, 96), (0, 6144, 16, 80, 77), (64, 6144, 1, 64, 96),
    (64, 0, 132, 16, 0)])
def test_mlp_epoch_plan_fills_one_wave(dg, b, sms, rows, blocks):
    shapes = [(128, 64), (64, 32), (32, 16)]
    lay = T.mlp_epoch_plan(dg, shapes, b, sms)
    assert (lay["rows"], lay["blocks"]) == (rows, blocks)
    assert lay["smem_bytes"] <= T.SMEM_LIMIT
    want = max(16, math.ceil(math.ceil(b / sms) / 16) * 16)
    if rows == want:
        assert blocks <= max(sms, 1)
    else:       # cut by shared memory: the next tile up does not fit
        assert T._mlp_layout(rows + 16, dg, shapes)["smem_bytes"] > T.SMEM_LIMIT
    # Every shared array starts on a 16-byte boundary; the row strides the
    # products read across threads hold an odd count of 16-byte pieces.
    offs = [*lay["off_w"], *lay["off_b"], lay["off_h"], *lay["off_x"],
            *(lay[k] for k in ("off_ug", "off_ig", "off_d0", "off_d1",
                               "off_sum", "off_row"))]
    assert all(o % 4 == 0 for o in offs)
    assert all(ld % 8 == 4 for ld in (*lay["ld_w"], *lay["ld_x"], lay["ld_d"]))
    # The dense gradient's slice: W_l, b_l, h in the order of spec["dense"].
    sizes = [i * o for i, o in shapes] + [o for _, o in shapes] + [dg + 16]
    assert lay["off_g"] == list(np.cumsum([0] + sizes))


# The tower kernel's table gradients: each step's batch rows sorted
# stably by id, and where each id's run starts; ids outside the table
# (the kernel reads them as zero rows) fall outside every run.
@pytest.mark.parametrize("steps,b,n", [(3, 64, 7), (2, 6144, 1682),
                                       (2, 0, 5), (0, 16, 5)])
def test_mlp_id_csr_lists_each_ids_rows_in_batch_order(steps, b, n):
    rng = np.random.default_rng(steps + b + n)
    ids = torch.as_tensor(rng.integers(-2, n + 2, (steps, b)).astype(np.int32))
    order, seg = T.mlp_id_csr(ids, n)
    assert order.dtype == seg.dtype == torch.int32
    assert tuple(order.shape) == (steps, b)
    assert tuple(seg.shape) == (steps, n + 1)
    for s in range(steps):
        for i in range(n):
            rows = order[s, seg[s, i]:seg[s, i + 1]].tolist()
            assert rows == np.flatnonzero(ids[s].numpy() == i).tolist()


# -- the trainer ----------------------------------------------------------

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
    return base_config(toy, **{**TRAIN, "recommender": name,
                               "train.fused_kernel": "False"})


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_one_epoch_matches_jax(toy_dataset, name, fused):
    """From the same params and Adam state (one JAX epoch in) and the same
    sampled (u, i, y, w): the port's scan tier against the JAX scan tier,
    and its fused tier (the plain version on the CPU) against the Pallas
    kernel in interpret mode."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(
        toy_dataset, name, **{"train.fused_kernel": str(fused)})
    j_scan = JTrainer(jmodel, jdata, _scan_cfg(toy_dataset, name))
    p0, o0 = j_scan.init_state()
    p0, o0, _ = j_scan.train_epoch(p0, o0)
    key = jax.random.PRNGKey(11)
    build_xs, run_scan = j_scan._scan_parts[:2]
    epoch_batch, step_keys = build_xs(key, j_scan.arrays)
    if fused:
        j_fused = JTrainer(jmodel, jdata, jcfg)
        sample, apply, correct = j_fused._fused_parts
        ids = sample(key, j_fused.arrays)
        p1, o1, raw = apply(p0, o0, ids)
        uz = ids[0]
        want = (p1, o1, correct(raw))
        # The JAX sampler's stream is the scan tier's draw, sign-encoded.
        u_sent = T.sentinel_dims(data.user_nums, data.item_nums)[0] - 1
        w = _np(epoch_batch["w"])
        np.testing.assert_array_equal(
            np.abs(_np(uz)) - 1, np.where(w == 0, u_sent,
                                          _np(epoch_batch["u"])))
        np.testing.assert_array_equal(_np(uz)[w == 1] > 0,
                                      _np(epoch_batch["y"])[w == 1] > 0)
    else:
        p1, o1, losses = run_scan(p0, o0, (epoch_batch, step_keys),
                                  j_scan.arrays, lambda batch: batch)
        want = (p1, o1, jnp.mean(losses))

    trainer = Trainer(model, data, cfg, device="cpu")
    assert trainer.fused == fused
    assert trainer.steps_per_epoch == j_scan.steps_per_epoch
    load_params(model, {k: _np(v) for k, v in p0.items()})
    state = adam_state_from_jax(o0[0].count,
                                {k: _np(v) for k, v in o0[0].mu.items()},
                                {k: _np(v) for k, v in o0[0].nu.items()},
                                "cpu", model=model)
    tensors = {k: _t(v) for k, v in epoch_batch.items()}
    got = trainer._run_epoch(dict(model.named_parameters()), state, tensors)
    _close_epoch(got, want, list(p0))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_three_epochs_on_the_jax_draws_match_jax(toy_dataset, name, fused):
    """Three epochs from JAX's initial parameters, each on the JAX
    sampler's draw, then eval: the port's parameters, loss and metrics
    follow the JAX trainer's epoch by epoch."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(
        toy_dataset, name, **{"train.fused_kernel": str(fused)})
    j_tr = JTrainer(jmodel, jdata, jcfg)
    build_xs = JTrainer(jmodel, jdata,
                        _scan_cfg(toy_dataset, name))._scan_parts[0]
    params, state = j_tr.init_state()
    trainer = Trainer(model, data, cfg, device="cpu")
    assert trainer.fused == fused
    load_params(model, {k: _np(v) for k, v in params.items()})
    t_params = dict(model.named_parameters())
    t_state = trainer.optimizer.init(t_params)
    for epoch in range(3):
        key = jax.random.PRNGKey(100 + epoch)
        params, state, loss = j_tr._epoch_body(params, state, key,
                                               j_tr.arrays)
        batch, _ = build_xs(key, j_tr.arrays)
        tensors = {k: _t(v) for k, v in batch.items()}
        t_params, t_state, t_loss = trainer._run_epoch(t_params, t_state,
                                                       tensors)
        _close_epoch((t_params, t_state, t_loss), (params, state, loss),
                     list(params))
        want, got = j_tr.evaluate(params), trainer.evaluate()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=METRIC_ATOL)


def test_neumf_scan_tier_leaves_the_warm_start_params(toy_dataset):
    """NeuMF's h_gmf and h_mlp are outside its loss: one scan epoch leaves
    them and their moments exactly as they were, in the port and in
    JAX."""
    (_, jdata, jmodel), (cfg, data, model) = _both_models(toy_dataset,
                                                          "NeuMF")
    j_tr = JTrainer(jmodel, jdata, _scan_cfg(toy_dataset, "NeuMF"))
    p0, o0 = j_tr.init_state()
    p0 = {k: np.array(v) for k, v in p0.items()}    # train_epoch donates
    p1, o1, _ = j_tr.train_epoch({k: jnp.asarray(v) for k, v in p0.items()},
                                 o0)
    trainer = Trainer(model, data, cfg, device="cpu")
    assert not trainer.fused
    params, _ = trainer.init_state()
    load_params(model, p0)
    state = trainer.optimizer.init(params)
    params, state, _ = trainer.train_epoch(params, state)
    assert state.count == trainer.steps_per_epoch
    for n in ("h_gmf", "h_mlp"):
        np.testing.assert_array_equal(_np(p1[n]), _np(p0[n]))
        np.testing.assert_array_equal(params[n].detach().numpy(), _np(p0[n]))
        for moment in (state.mu[n], state.nu[n], o1[0].mu[n], o1[0].nu[n]):
            assert not np.asarray(moment).any()
    assert not np.array_equal(params["h_neumf"].detach().numpy(),
                              _np(p0["h_neumf"]))


def test_fused_tier_eligibility(toy_dataset):
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("test_torch_ncf.eligibility")
    logger.addHandler(Keep())
    logger.setLevel(logging.INFO)
    on = {"train.fused_kernel": "True"}
    for name, extra, fused in (
            ("GMF", {}, False), ("GMF", on, True),
            ("GMF", {**on, "loss_func": "square"}, True),
            ("GMF", {**on, "optimizer": "SGD"}, False),
            ("MLP", on, True), ("NeuMF", on, True),
            ("MLP", {**on, "layers": "[1024,512]"}, False)):
        (_, _, _), (cfg, data, model) = _both_models(toy_dataset, name,
                                                     **extra)
        assert Trainer(model, data, cfg, device="cpu",
                       logger=logger).fused == fused, (name, extra)
    assert len(records) == 1 and "shared memory" in records[0]


def test_trainer_runs_every_model(toy_dataset):
    for name in MODELS:
        (_, _, _), (cfg, data, model) = _both_models(toy_dataset, name)
        for fused in ("False", "True"):
            tr = Trainer(model, data, cfg.with_overrides(
                **{"train.fused_kernel": fused}), device="cpu")
            params, state = tr.init_state()
            params, state, losses = tr.train_epochs(params, state, 3)
            assert losses[-1] < losses[0], (name, fused, losses)
            assert state.count == 3 * tr.steps_per_epoch
            assert sorted(tr.evaluate()) == cfg.topk


FULL = {"data.split_way": "rs", "test.neg_samples": "0",
        "data.split_by_time": "True", "stddev": "0.5"}


@pytest.mark.parametrize("mode,overrides", [
    ("candidate", {"stddev": "0.5"}),
    ("full", dict(FULL, **{"eval.fused_kernel": "False"})),
    ("full_fused", dict(FULL, **{"eval.fused_kernel": "True"}))])
def test_gmf_evaluator_matches_jax(toy_dataset, mode, overrides):
    """GMF through the Evaluator's three modes: candidate lists of sigmoid
    scores, the full catalog, and the masked dot-scoring path of slice 1
    on GMF's dot_decomposition (its plain version here)."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(
        toy_dataset, "GMF", **overrides)
    params = jmodel.init(jax.random.PRNGKey(5))
    load_params(model, {k: _np(v) for k, v in params.items()})
    jev = JEvaluator(jmodel, j_build_device_data(jdata), jcfg)
    ev = Evaluator(model, build_device_data(data), cfg, device="cpu")
    assert ev.mode == jev.mode == mode
    np.testing.assert_array_equal(ev.recommend_topk(),
                                  jev.recommend_topk(params, {}))
    want = jev.evaluate(params, {})
    for k, got in ev.evaluate().items():
        np.testing.assert_allclose(got, want[k], rtol=0, atol=1e-6)


# -- the CLI --------------------------------------------------------------

@pytest.mark.parametrize("fused", ["False", "True"])
def test_cli_trains_gmf(toy_dataset, tmp_path, capsys, fused):
    props = tmp_path / "global.properties"
    props.write_text("\n".join([
        "[default]", "recommender=BPR", "model_type=ranking",
        f"data.root_dir={toy_dataset['root']}",
        f"data.dataset={toy_dataset['name']}", "data.file_name=ratings.csv",
        "data.sep=,", "data.format=UIRT", "data.split_way=loo",
        "test.neg_samples=10", "test.batch_size=16", "topk=[5,10]",
        f"log.dir={tmp_path / 'logs'}", "seed=7", ""]))
    logger = logging.getLogger("cleverrec_tpu_torch.GMF")
    for h in list(logger.handlers):                  # the CLI makes it afresh
        logger.removeHandler(h)
        h.close()
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    try:
        get_logger(str(tmp_path / "logs"), "GMF")
        logger.addHandler(Keep())
        rc = cli.main(["--config", str(props), "--conf-dir",
                       os.path.join(REPO, "conf"), "--model", "GMF",
                       "--device", "cpu", "--set", "epoches=3",
                       "--set", "batch_size=64", "--set", "embed_size=16",
                       "--set", "lr=0.05", "--set", "stddev=0.1",
                       "--set", f"train.fused_kernel={fused}"])
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    assert rc == 0
    out = capsys.readouterr().out
    assert "Current model: GMF" in out and "best_epoch: " in out
    epochs = [r.train for r in records if hasattr(r, "train")]
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    assert epochs[-1]["losses"][-1] < epochs[0]["losses"][0]
    best = [r.best for r in records if hasattr(r, "best")]
    assert len(best) == 1 and sorted(best[0]["metrics"]) == [5, 10]
