"""Social-triple training in the port (SBPR, TBPR, CUNE_BPR) against the
JAX package: the loader's social fields, SPu, the tie partition and the
CUNE pipeline, the social samplers' layouts, invariants and negatives,
each model's loss, grads and scores, the rows epoch's plain version
against both Pallas rows kernels in interpret mode, one and three epochs
of each trainer tier on JAX's own draws, and the CLI."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from cleverrec_tpu import sampling as j_sampling
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.data import social as j_social
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.ops.pallas_train import fused_rows_epoch as j_rows_epoch
from cleverrec_tpu.ops.pallas_train import \
    fused_rows_epoch_stream as j_rows_epoch_stream
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import cli, sampling
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.data import social
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import train as T
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.utils.logging import get_logger
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("SBPR", "TBPR", "CUNE_BPR")

# The plain version against the Pallas kernels: f32 sums in another order
# (the scatters are one-hot products there, index_add_ here).
LOSS_RTOL = 1e-5
TABLE_RTOL, TABLE_ATOL = 2e-4, 2e-6
MOMENT_RTOL, MOMENT_ATOL = 2e-4, 2e-7
# One trainer epoch, port against JAX (tests/test_fused_train.py:95-106).
EPOCH_LOSS_RTOL = 1e-4
EPOCH_RTOL, EPOCH_ATOL = 1e-3, 1e-5
# Eval metrics after an epoch: means over the toy's test users of lists
# ranked from parameters equal to ~1e-6.
METRIC_ATOL = 2e-4

# lr 0.01 and stddev 0.1, as the NCF parity tests (tests/test_fused_train.py
# :214-220); CUNE's walks cut to the toy's 30 users.
TRAIN = {"epoches": "2", "batch_size": "64", "embed_size": "16",
         "lr": "0.01", "neg_ratio": "2", "is_pairwise": "True",
         "loss_func": "bpr", "reg": "0.05", "stddev": "0.1",
         "social_file": "trusts.csv", "strong_ratio": "0.5",
         "walk_count": "3", "walk_length": "6", "walk_dim": "8",
         "window_size": "2", "topk_f": "5"}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _both_data(toy, **overrides):
    jcfg = base_config(toy, **{**TRAIN, **overrides})
    cfg = Config(jcfg.to_dict())
    return (jcfg, j_load_ranking_data(jcfg)), (cfg, load_ranking_data(cfg))


def _both_models(toy, name, **overrides):
    (jcfg, jdata), (cfg, data) = _both_data(toy, recommender=name,
                                            **overrides)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return (jcfg, jdata, jmodel), (cfg, data, model)


@pytest.fixture
def fixed_sgns(monkeypatch):
    """One seeded embedding table in place of both packages' skip-gram
    fits (their initial draws differ), so that CUNE_BPR finds the same
    latent friends in both."""
    def fixed(walks, n_nodes, dim, window, rng, **kw):
        return np.random.default_rng(n_nodes).normal(
            size=(n_nodes, dim)).astype(np.float32)

    monkeypatch.setattr(social, "_sgns_embeddings", fixed)
    monkeypatch.setattr(j_social, "_sgns_embeddings", fixed)


# -- the loader and the host-side social sets -----------------------------

@pytest.mark.parametrize("cap", ["0", "2"])
def test_loader_social_fields_match_jax(toy_social_dataset, cap):
    (_, jdata), (_, data) = _both_data(toy_social_dataset,
                                       **{"social.max_friends": cap})
    assert data.user_friends == jdata.user_friends
    assert list(data.user_friends) == sorted(data.user_friends)
    np.testing.assert_array_equal(data.friends_padded, jdata.friends_padded)
    assert data.friends_padded.dtype == np.int32
    np.testing.assert_array_equal(
        build_device_data(data).friends_padded, jdata.friends_padded)
    assert data.ui_train == jdata.ui_train and data.ui_test == jdata.ui_test


def test_loader_drops_edges_of_filtered_users(tmp_path):
    """An edge with an endpoint the filters dropped is left out, and the
    others are reindexed with the user map."""
    ds = tmp_path / "soc"
    ds.mkdir()
    rows = ["u_id,i_id,rating,time"] + [
        f"{u},{i},5,{t}" for t, (u, i) in enumerate(
            [(10, 1), (10, 2), (10, 3), (20, 1), (20, 4), (20, 5), (30, 2),
             (30, 6), (40, 7)])]
    (ds / "ratings.csv").write_text("\n".join(rows) + "\n")
    (ds / "trusts.csv").write_text("u_id,v_id\n30,10\n10,40\n10,20\n99,10\n"
                                   "20,30\n10,30\n")
    toy = {"root": str(tmp_path), "name": "soc"}
    (_, jdata), (_, data) = _both_data(toy, **{"data.user_min": "2"})
    assert data.user_friends == jdata.user_friends == {0: [1, 2], 1: [2],
                                                      2: [0]}
    np.testing.assert_array_equal(data.friends_padded, jdata.friends_padded)


def test_spu_and_tie_partition_match_jax(toy_social_dataset):
    (_, jdata), (_, data) = _both_data(toy_social_dataset)
    spu, suk = social.build_spu(data.ui_train, data.user_friends)
    assert (spu, suk) == j_social.build_spu(jdata.ui_train,
                                            jdata.user_friends)
    assert spu and all(len(spu[u]) == len(suk[u]) for u in spu)
    for ratio in (0.5, 0.2):
        got = social.build_tie_partitioned_spu(data.ui_train,
                                               data.user_friends, ratio)
        assert got == j_social.build_tie_partitioned_spu(
            jdata.ui_train, jdata.user_friends, ratio)
        assert got[0] and got[1]
    for a, b in zip(social.flatten_friend_edges(data.user_friends),
                    j_social.flatten_friend_edges(jdata.user_friends)):
        np.testing.assert_array_equal(a, b)


def test_cunet_and_deep_walks_match_jax(toy_social_dataset):
    (_, jdata), (_, data) = _both_data(toy_social_dataset)
    shape = (data.user_nums, data.item_nums)
    w = social._cunet(data.ui_train, *shape)
    jw = j_social._cunet(jdata.ui_train, *shape)
    assert (w != jw).nnz == 0 and w.nnz > 0
    walks = social._deep_walks(w, 4, 7, np.random.default_rng(3))
    assert walks == j_social._deep_walks(jw, 4, 7, np.random.default_rng(3))
    assert len(walks) == 4 * np.count_nonzero(np.diff(w.indptr))


def test_cune_friends_match_jax(toy_social_dataset, monkeypatch):
    """Both pipelines on one fixed embedding table in place of their
    skip-gram fits: the same latent friends, in the same order, and the
    same SPu and suk."""
    (_, jdata), (_, data) = _both_data(toy_social_dataset)
    emb = np.random.default_rng(9).normal(size=(data.user_nums, 8)).astype(
        np.float32)
    seen = []

    def fixed(walks, n_nodes, dim, window, rng, **kw):
        seen.append((len(walks), n_nodes, dim, window))
        return emb

    monkeypatch.setattr(social, "_sgns_embeddings", fixed)
    monkeypatch.setattr(j_social, "_sgns_embeddings", fixed)
    args = (data.user_nums, data.item_nums, 3, 6, 8, 2, 5)
    got = social.build_cune_friends(data.ui_train, *args, seed=4)
    want = j_social.build_cune_friends(jdata.ui_train, *args, seed=4)
    assert seen[0] == seen[1]
    assert got == want
    friends = got[0]
    assert all(len(fs) == 5 and u not in fs for u, fs in friends.items())


def test_sgns_loss_falls(toy_social_dataset):
    (_, _), (_, data) = _both_data(toy_social_dataset)
    rng = np.random.default_rng(0)
    w = social._cunet(data.ui_train, data.user_nums, data.item_nums)
    walks = social._deep_walks(w, 20, 10, rng)
    emb, losses = social._sgns_fit(walks, data.user_nums, 8, 3, rng,
                                   epochs=5)
    assert emb.shape == (data.user_nums, 8) and torch.isfinite(emb).all()
    per_epoch = losses.reshape(5, -1).mean(dim=1)
    assert (per_epoch[1:] < per_epoch[:-1]).all(), per_epoch
    assert per_epoch[-1] < 0.8 * per_epoch[0]


# -- the samplers -----------------------------------------------------------

def test_csr_lists_match_jax():
    rng = np.random.default_rng(1)
    sets = {e: sorted(rng.choice(50, rng.integers(1, 9), replace=False)
                      .tolist()) for e in (0, 2, 3, 7)}
    aux = {e: rng.integers(1, 4, len(v)).tolist() for e, v in sets.items()}
    for a in (None, aux):
        got = sampling.build_csr_lists(sets, 9, aux=a)
        want = j_sampling.build_csr_lists(sets, 9, aux=a)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(
            sampling.csr_lens(got), [len(sets.get(e, ())) for e in range(9)])
    empty = sampling.build_csr_lists({}, 3)
    np.testing.assert_array_equal(empty["flat"], [0])
    np.testing.assert_array_equal(sampling.csr_lens(empty), [0, 0, 0])


def _tables(aux, name):
    """(union sets {u: set}, {plane: CSR dict}) of a model's aux."""
    rows, lens = aux["social_neg"].rows, aux["social_neg"].lens
    union = {u: set(rows[u, :lens[u]].tolist()) for u in range(len(lens))}
    lists = {"k": "spu_csr"} if name != "TBPR" else {"s": "ts_csr",
                                                     "t": "tw_csr"}
    return union, {k: aux[v] for k, v in lists.items()}


@pytest.mark.parametrize("name", MODELS)
def test_social_epoch_layout_and_invariants(toy_social_dataset, name,
                                            fixed_sgns):
    """The trainer's static layout equals the JAX trainer's; one epoch's
    draw holds the same (u, i, w) rows as the JAX sampler's, every
    negative lies outside the user's seen-union-social set, every k, s
    and t comes from its user's list (k with its suk), and the padding
    rows carry w = 0."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(
        toy_social_dataset, name)
    j_tr = JTrainer(jmodel, jdata, base_config(
        toy_social_dataset, **{**TRAIN, "recommender": name,
                               "train.fused_kernel": "False"}))
    tr = Trainer(model, data, cfg, device="cpu")
    key = {"TBPR": "tbpr_static"}.get(name, "sbpr_static")
    want = j_tr.arrays[key]
    assert sorted(tr._static) == sorted(set(want) - {"ord_w"})
    for k, v in tr._static.items():
        np.testing.assert_array_equal(v.numpy(), _np(want[k]), err_msg=k)
    assert tr.n_pairs == j_tr.n_pairs and tr.steps_per_epoch == \
        j_tr.steps_per_epoch
    np.testing.assert_array_equal(tr._neg_lens.numpy(),
                                  _np(j_tr.arrays["social_neg"].lens))
    tr.init_state()
    ep = {k: v.reshape(-1).numpy() for k, v in tr.sample_epoch().items()}
    jep = j_tr._scan_parts[0](jax.random.PRNGKey(0), j_tr.arrays)[0]
    assert sorted(ep) == sorted(jep)
    rows = lambda *c: np.unique(np.stack(c, 1), axis=0,  # noqa: E731
                                return_counts=True)
    for got, exp in zip(rows(*(ep[k] for k in "uiw")),
                        rows(*(_np(jep[k]).reshape(-1) for k in "uiw"))):
        np.testing.assert_array_equal(got, exp)
    real = ep["w"] == 1
    assert real.sum() == tr._epoch_rows and (ep["w"][~real] == 0).all()
    union, lists = _tables(tr.model_aux, name)
    for u, i, j in zip(ep["u"][real], ep["i"][real], ep["j"][real]):
        assert j not in union[u] and 0 <= j < data.item_nums
        assert i in data.ui_train[u]
    for plane, csr in lists.items():
        lens = sampling.csr_lens(csr)
        for r in np.flatnonzero(real):
            u, x = ep["u"][r], ep[plane][r]
            members = csr["flat"][csr["off"][u]:csr["off"][u] + lens[u]]
            hit = np.flatnonzero(members == x)
            assert hit.size == 1, (plane, u, x)
            if plane == "k":
                assert ep["suk"][r] == csr["suk"][csr["off"][u] + hit[0]]
                assert ep["suk"][r] >= 1


def test_social_negatives_are_uniform_over_the_complement():
    """One user, many rows: the negatives fill the complement of
    seen-union-SPu uniformly (chi-square), and k its SPu list."""
    rng = np.random.default_rng(4)
    id_range = 300
    seen = {0: list(range(40)) + [id_range - 1]}
    spu = {0: sorted(rng.choice(np.arange(40, 299), 60, replace=False)
                     .tolist())}
    union = {0: seen[0] + spu[0], 1: [3, 4]}
    table = sampling.build_member_table(union, 2, id_range)
    csr = sampling.build_csr_lists(spu, 2, aux={0: [2.0] * 60})
    n_pairs, neg_ratio = 4000, 10
    pos_i = rng.choice(seen[0], n_pairs).astype(np.int32)
    rows_total = n_pairs * neg_ratio
    static = {k: torch.as_tensor(v) for k, v in sampling.sbpr_epoch_static(
        np.zeros(n_pairs, np.int32), pos_i, table.lens,
        sampling.csr_lens(csr), csr["off"], id_range, rows_total,
        neg_ratio).items()}
    t = sampling.sbpr_epoch_tensors(
        torch.Generator().manual_seed(6), static, torch.as_tensor(table.rows),
        torch.as_tensor(table.lens), {k: torch.as_tensor(v) for k, v in
                                      csr.items()},
        rows_total, rows_total // 100, 100)
    j = t["j"].reshape(-1).numpy()
    free = np.setdiff1d(np.arange(id_range), union[0])
    assert np.isin(j, free).all()
    counts = np.bincount(np.searchsorted(free, j), minlength=free.size)
    assert scipy.stats.chisquare(counts).pvalue > 1e-3
    k = t["k"].reshape(-1).numpy()
    counts = np.bincount(np.searchsorted(spu[0], k), minlength=len(spu[0]))
    assert np.isin(k, spu[0]).all() and (t["suk"] == 2.0).all()
    assert scipy.stats.chisquare(counts).pvalue > 1e-3


# -- the models -------------------------------------------------------------

def _batch(rng, data, name, n=50):
    keys = ("i", "s", "t", "j") if name == "TBPR" else ("i", "k", "j")
    batch = {"u": rng.integers(0, data.user_nums, n).astype(np.int32),
             "w": (rng.random(n) < 0.8).astype(np.float32)}
    batch.update({k: rng.integers(0, data.item_nums, n).astype(np.int32)
                  for k in keys})
    if name != "TBPR":
        batch["suk"] = rng.integers(0, 4, n).astype(np.float32)
    return batch


def _jax_params(jmodel, seed):
    """JAX's initial params with a nonzero bias and s, as after training."""
    params = dict(jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["bias"] = jnp.asarray(rng.normal(
        size=params["bias"].shape).astype(np.float32) * 0.3)
    if "s" in params:
        params["s"] = jnp.asarray(np.float32(0.4))
    return params


@pytest.mark.parametrize("name", MODELS)
def test_model_loss_and_grads_match_jax(toy_social_dataset, name):
    (_, _, jmodel), (_, data, model) = _both_models(toy_social_dataset, name)
    params = _jax_params(jmodel, 3)
    load_params(model, {k: _np(v) for k, v in params.items()})
    assert [n for n, _ in model.named_parameters()] == list(params)
    batch = _batch(np.random.default_rng(8), data, name)
    want, grads = jax.value_and_grad(jmodel.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, {})
    loss = model.loss({k: torch.as_tensor(v) for k, v in batch.items()}, {})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    # atol 1e-7: P's grad sums up to four item rows of ~0.1 and their
    # regulariser terms, so its f32 rounding is ~1e-8 where they cancel.
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(grads[n]), rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    assert float(model.bias.grad[-1]) == 0.0           # the PAD slot


@pytest.mark.parametrize("name", MODELS)
def test_model_scores_match_jax(toy_social_dataset, name):
    (_, _, jmodel), (_, data, model) = _both_models(toy_social_dataset, name,
                                                    stddev="0.5")
    params = _jax_params(jmodel, 4)
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
        uv, table, bias = model.dot_decomposition(users, {})
        juv, jtable, jbias = jmodel.dot_decomposition(params,
                                                      jnp.asarray(u[:7]), {})
        assert bias is None and jbias is None
        np.testing.assert_array_equal(uv.numpy(), _np(juv))
        np.testing.assert_array_equal(table.numpy(), _np(jtable))


def test_social_models_need_their_data(toy_dataset):
    train = {k: v for k, v in TRAIN.items() if k != "social_file"}
    for name in ("SBPR", "TBPR"):
        cfg = Config(base_config(toy_dataset, **train,
                                 recommender=name).to_dict())
        data = load_ranking_data(cfg)
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                           device="cpu")
        with pytest.raises(ValueError, match="social_file"):
            Trainer(model, data, cfg, device="cpu")


def test_cune_s_round_trips(toy_social_dataset):
    """CUNE_BPR's 0-d s and its 0-d moments load from JAX and read back
    as they were."""
    (_, _, jmodel), (_, _, model) = _both_models(toy_social_dataset,
                                                 "CUNE_BPR")
    params = {k: _np(v) for k, v in _jax_params(jmodel, 5).items()}
    load_params(model, params)
    assert model.s.shape == () and float(model.s.detach()) == params["s"]
    mu = {k: np.full_like(v, 0.25) for k, v in params.items()}
    nu = {k: np.full_like(v, 0.5) for k, v in params.items()}
    state = adam_state_from_jax(np.int32(9), mu, nu, "cpu", model=model)
    assert state.count == 9 and state.mu["s"].shape == ()
    for k, v in params.items():
        np.testing.assert_array_equal(
            dict(model.named_parameters())[k].detach().numpy(), v)
        np.testing.assert_array_equal(state.nu[k].numpy(), nu[k])


# -- the rows epoch's plain version against the Pallas kernels --------------

def _rows_inputs(rng, name, u_n, i_n, d, steps, b, t0):
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    n_items = 4 if name == "TBPR" else 3
    invalid = rng.random((steps, b)) < 0.2
    planes = [np.where(invalid, u_pad - 1, rng.integers(0, u_n, (steps, b)))]
    planes += [np.where(invalid, i_pad - 1, rng.integers(0, i_n, (steps, b)))
               for _ in range(n_items)]
    floats = ([rng.integers(0, 5, (steps, b)).astype(np.float32)]
              if name == "SBPR" else [])
    shapes = [(u_n, d), (i_n, d + 1)] + ([()] if name == "CUNE_BPR" else [])
    params = [rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
    if name == "CUNE_BPR":
        params[2] = np.asarray(0.3, np.float32)
    moments = []
    for s in shapes:
        m = rng.normal(size=s).astype(np.float32) * 1e-2
        moments.append((m, np.abs(m) * 1e-2) if t0 else
                       (np.zeros(s, np.float32), np.zeros(s, np.float32)))
    return ([p.astype(np.int32) for p in planes], floats, params, moments,
            invalid)


@pytest.mark.parametrize("t0", [0, 7])
@pytest.mark.parametrize("name", MODELS)
def test_rows_epoch_plain_version_matches_pallas(toy_social_dataset, name,
                                                 t0):
    """The plain version on the port model's spec against JAX's
    fused_rows_epoch (2.6) and fused_rows_epoch_stream (2.7), in
    interpret mode, on the JAX model's spec: sentinel rows, SBPR's float
    column, CUNE_BPR's dense scalar, the item table [Q | bias] split
    into its two tensors on the port's side."""
    (_, _, jmodel), (_, _, model) = _both_models(toy_social_dataset, name,
                                                 embed_size="8")
    jspec, spec = jmodel.fused_rows_spec(), model.fused_rows_spec()
    assert spec["planes"] == jspec["planes"]
    assert spec["floats"] == jspec["floats"] and spec["dense"] == \
        jspec["dense"]
    rng = np.random.default_rng(11 + t0)
    u_n, i_n, d, steps, b, lr = 29, 41, 8, 3, 48, 0.02
    planes, floats, params, moments, invalid = _rows_inputs(
        rng, name, u_n, i_n, d, steps, b, t0)
    sides = tuple(sd for _, sd in spec["planes"])

    def jax_state(k):
        vals = [params[n] if k is None else moments[n][k]
                for n in range(len(params))]
        return (jnp.asarray(vals[0]), jnp.asarray(vals[1]),
                tuple(jnp.asarray(x) for x in vals[2:]))

    args = (*jax_state(None), *jax_state(0), *jax_state(1),
            tuple(jnp.asarray(p) for p in planes),
            tuple(jnp.asarray(f) for f in floats),
            jnp.asarray(t0, jnp.int32))
    kw = dict(sides=sides, row_loss=jspec["row_loss"], lr=lr, blk=16,
              interpret=True)
    resident = j_rows_epoch(*args, **kw)
    stream = j_rows_epoch_stream(*args, **kw, slab_u=128, slab_i=128)

    def port_state(k):
        vals = [params[n] if k is None else moments[n][k]
                for n in range(len(params))]
        item = _t(vals[1])
        return ((_t(vals[0]),), (item[:, :d].contiguous(),
                                 item[:, d].contiguous()),
                tuple(_t(x) for x in vals[2:]))

    state = [port_state(k) for k in (None, 0, 1)]
    before = dict(T.launches)
    loss = T.fused_rows_epoch(*state[0], *state[1], *state[2],
                              [_t(p) for p in planes],
                              [_t(f) for f in floats], t0, sides=sides,
                              spec=spec, lr=lr)
    assert T.launches == before                  # CPU tensors: plain path
    assert T.fused_rows_epoch_stream is T.fused_rows_epoch
    for want in (resident, stream):
        assert float(loss) == pytest.approx(float(want[9]), rel=LOSS_RTOL)
        for k, (pu, (q, bias), dense) in enumerate(state):
            rtol, atol = ((TABLE_RTOL, TABLE_ATOL) if k == 0
                          else (MOMENT_RTOL, MOMENT_ATOL))
            w_pu, w_qi, w_dense = want[3 * k:3 * k + 3]
            for label, got, exp in (("P", pu[0], w_pu),
                                    ("Q", q, _np(w_qi)[:, :d]),
                                    ("bias", bias, _np(w_qi)[:, d]),
                                    *(("s", g, e) for g, e in
                                      zip(dense, w_dense))):
                np.testing.assert_allclose(
                    got.numpy(), _np(exp), rtol=rtol, atol=atol,
                    err_msg=f"{label}, part {k}")


def test_rows_epoch_masked_rows_change_nothing(toy_social_dataset):
    """Steps of masked rows only (plane 0 at the sentinel): zero loss,
    and Adam with zero grads leaves fresh state as it was."""
    (_, _, _), (_, _, model) = _both_models(toy_social_dataset, "CUNE_BPR")
    spec = model.fused_rows_spec()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    params["bias"].normal_()
    before = {n: p.clone() for n, p in params.items()}
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    moments = [spec["pack"](zeros), spec["pack"](
        {n: torch.zeros_like(p) for n, p in params.items()})]
    u_pad, i_pad = T.sentinel_dims(model.meta.user_nums, model.meta.item_nums)
    planes = [torch.full((3, 10), pad - 1, dtype=torch.int32)
              for pad in (u_pad, i_pad, i_pad, i_pad)]
    loss = T.fused_rows_epoch(*spec["pack"](params), *moments[0],
                              *moments[1], planes, [], 0,
                              sides=("u", "i", "i", "i"), spec=spec, lr=0.1)
    assert float(loss) == 0.0
    for n, p in params.items():
        np.testing.assert_array_equal(p.numpy(), before[n].numpy())


def test_rows_epoch_plan_takes_only_the_chain(toy_social_dataset):
    (_, _, _), (_, _, model) = _both_models(toy_social_dataset, "SBPR")
    spec = model.fused_rows_spec()
    assert T.rows_epoch_plan(spec) == {"form": "chain", "items": 3,
                                       "float_link": 0, "dense_link": -1,
                                       "reg": 0.05, "rows": 16, "blocks": 0,
                                       "slice": 1}
    # Two rows a warp, 16 a block: a step's 6,144 rows in 384 blocks.
    assert T.rows_epoch_plan(spec, 6144, 132)["blocks"] == 384
    planes = spec["planes"]
    for bad, match in (
            ({"chain": None}, "chain"),
            ({"planes": planes[:2]}, "item planes"),
            ({"planes": planes + (("x", "i"),) * 2}, "item planes"),
            ({"planes": (("i", "i"),) + planes[1:]}, "item planes"),
            ({"floats": ()}, "float_link"),
            ({"chain": {**spec["chain"], "float_link": 2}}, "float_link"),
            ({"dense": ("s",)}, "dense_link"),
            ({"dense": ("s",), "chain": {**spec["chain"], "dense_link": 0}},
             "both")):
        with pytest.raises(ValueError, match=match):
            T.rows_epoch_plan({**spec, **bad})


@pytest.mark.parametrize("d,offset,vec", [
    (128, 0, True), (16, 0, True), (18, 0, False), (5, 0, False),
    (128, 1, False), (128, 4, True)])
def test_rows_vec_takes_aligned_rows_only(d, offset, vec):
    """The rows kernels read 16-byte rows only where d % 4 == 0 and every
    table is 16-byte aligned: a view that starts ``offset`` floats into
    its storage is unless offset % 4 == 0, whichever table it is."""
    table = torch.zeros(10 * d + offset)[offset:].view(10, d)
    other = torch.zeros(7, d)
    assert T.rows_vec((table, other)) is vec
    assert T.rows_vec((other, other, torch.zeros(d, 3), table)) is vec


def test_rows_epoch_rejects_bad_input(toy_social_dataset):
    (_, _, _), (_, _, model) = _both_models(toy_social_dataset, "SBPR")
    spec = model.fused_rows_spec()
    params = {n: p.detach() for n, p in model.named_parameters()}
    z = spec["pack"]({n: torch.zeros_like(p) for n, p in params.items()})
    ids = [torch.zeros((2, 4), dtype=torch.int32)] * 4
    col = [torch.ones((2, 4))]
    sides = ("u", "i", "i", "i")
    ok = (*spec["pack"](params), *z, *z)
    T.fused_rows_epoch(*ok, ids, col, 0, sides=sides, spec=spec, lr=0.1)
    with pytest.raises(TypeError):
        T.fused_rows_epoch(*ok, [ids[0].long()] + ids[1:], col, 0,
                           sides=sides, spec=spec, lr=0.1)
    with pytest.raises(ValueError, match="one shape"):
        T.fused_rows_epoch(*ok, ids, [col[0][:, :3]], 0, sides=sides,
                           spec=spec, lr=0.1)
    with pytest.raises(ValueError, match="sides"):
        T.fused_rows_epoch(*ok, ids, col, 0, sides=("i",) * 4, spec=spec,
                           lr=0.1)
    with pytest.raises(ValueError, match="moment"):
        T.fused_rows_epoch(*ok[:3], (z[0][0][:2],), *ok[4:], ids, col, 0,
                           sides=sides, spec=spec, lr=0.1)


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
    return base_config(toy, **{**TRAIN, "recommender": name,
                               "train.fused_kernel": "False"})


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_one_epoch_matches_jax(toy_social_dataset, fixed_sgns, name, fused):
    """From the same params and Adam state (one JAX epoch in) and the same
    sampled rows: the port's scan tier against the JAX scan tier, and its
    fused tier (the plain version on the CPU) against the Pallas rows
    kernel in interpret mode."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(
        toy_social_dataset, name, **{"train.fused_kernel": str(fused)})
    j_scan = JTrainer(jmodel, jdata, _scan_cfg(toy_social_dataset, name))
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
        # The JAX fused sampler's planes are the scan tier's draw.
        w = _np(epoch_batch["w"])
        np.testing.assert_array_equal(_np(ids[0][0])[w == 1],
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
    # The PAD slot and its moments pass through.
    for t, t0 in ((got[0]["bias"], p0["bias"]),
                  (got[1].mu["bias"], _np(o0[0].mu["bias"])),
                  (got[1].nu["bias"], _np(o0[0].nu["bias"]))):
        assert float(t[-1]) == float(t0[-1])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_three_epochs_on_the_jax_draws_match_jax(toy_social_dataset,
                                                 fixed_sgns, name, fused):
    """Three epochs from JAX's initial parameters, each on the JAX
    sampler's draw, then eval: the port's parameters, loss and metrics
    follow the JAX trainer's epoch by epoch."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(
        toy_social_dataset, name, **{"train.fused_kernel": str(fused)})
    j_tr = JTrainer(jmodel, jdata, jcfg)
    build_xs = JTrainer(jmodel, jdata, _scan_cfg(toy_social_dataset, name)
                        )._scan_parts[0]
    params, state = j_tr.init_state()
    trainer = Trainer(model, data, cfg, device="cpu")
    assert trainer.fused == fused
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


def test_fused_tier_eligibility(toy_social_dataset, monkeypatch):
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("test_torch_social.eligibility")
    logger.addHandler(Keep())
    logger.setLevel(logging.INFO)
    on = {"train.fused_kernel": "True"}
    for name, extra, fused in (
            ("SBPR", {}, False), ("SBPR", on, True), ("TBPR", on, True),
            ("CUNE_BPR", on, True), ("SBPR", {**on, "optimizer": "SGD"},
                                     False),
            ("SBPR", {**on, "train.fused_stream": "True"}, True)):
        (_, _, _), (cfg, data, model) = _both_models(toy_social_dataset,
                                                     name, **extra)
        assert Trainer(model, data, cfg, device="cpu",
                       logger=logger).fused == fused, (name, extra)
    assert len(records) == 1 and "same kernel" in records[0]
    # A row_loss outside the chain form: declined to the scan tier.
    (_, _, _), (cfg, data, model) = _both_models(toy_social_dataset, "SBPR",
                                                 **on)
    spec = model.fused_rows_spec()
    monkeypatch.setattr(model, "fused_rows_spec",
                        lambda: {**spec, "chain": None})
    assert not Trainer(model, data, cfg, device="cpu", logger=logger).fused
    assert len(records) == 2 and "chain" in records[1]


def test_trainer_runs_every_model(toy_social_dataset):
    for name in MODELS:
        (_, _, _), (cfg, data, model) = _both_models(toy_social_dataset, name,
                                                     lr="0.05")
        for fused in ("False", "True"):
            tr = Trainer(model, data, cfg.with_overrides(
                **{"train.fused_kernel": fused}), device="cpu")
            params, state = tr.init_state()
            params, state, losses = tr.train_epochs(params, state, 3)
            assert losses[-1] < losses[0], (name, fused, losses)
            assert state.count == 3 * tr.steps_per_epoch
            assert sorted(tr.evaluate()) == cfg.topk


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_cli_trains_each_model(toy_social_dataset, tmp_path, capsys, name):
    """Each model through the CLI on its conf, cut to the toy."""
    props = tmp_path / "global.properties"
    props.write_text("\n".join([
        "[default]", "recommender=BPR", "model_type=ranking",
        f"data.root_dir={toy_social_dataset['root']}",
        f"data.dataset={toy_social_dataset['name']}",
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
                       "--set", "neg_ratio=2", "--set", "lr=0.01",
                       "--set", "stddev=0.1", "--set", "walk_count=3",
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
