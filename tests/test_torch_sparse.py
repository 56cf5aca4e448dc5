"""The lazy row-Adam tier and the per-step samplers in the port against
the JAX package: ``ops/sparse_adam`` on the same inputs, the forced tier
for SBPR, CUNE_BPR and BPR against the dense numpy oracle of
``tests/test_sparse_rows.py`` (copied here), the tier's selection,
``member``, ``sample_not_in`` and the per-step batch builders' layouts,
invariants and distribution, and SBPR and TBPR with
``train.sbpr_epoch_tensors=False`` on JAX's per-step draws through both
tiers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from cleverrec_tpu import sampling as j_sampling
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.ops import sparse_adam as j_sparse
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import sampling
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import sparse_adam
from cleverrec_tpu_torch.ops import train as T
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config

B1, B2, EPS = 0.9, 0.999, 1e-8
# As tests/test_sparse_rows.py:22-35, with CUNE's walks cut to the toy.
TRAIN = {"epoches": "2", "batch_size": "32", "embed_size": "16",
         "lr": "0.05", "neg_ratio": "2", "is_pairwise": "True",
         "loss_func": "bpr", "reg": "0.05", "stddev": "0.1",
         "train.fused_kernel": "False", "train.sparse_rows_force": "True",
         "walk_count": "2", "walk_length": "4",
         "walk_dim": "8", "window_size": "2", "topk_f": "3",
         "strong_ratio": "0.5"}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _both(toy, name, **overrides):
    if name in ("SBPR", "TBPR"):
        overrides = {"social_file": "trusts.csv", **overrides}
    jcfg = base_config(toy, **{**TRAIN, "recommender": name, **overrides})
    cfg = Config(jcfg.to_dict())
    jdata, data = j_load_ranking_data(jcfg), load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return (jcfg, jdata, jmodel), (cfg, data, model)


# -- ops/sparse_adam --------------------------------------------------------

def test_dedup_rows_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, 40).astype(np.int32)
    g = rng.normal(size=(40, 5)).astype(np.float32)
    rep, gsum = sparse_adam.dedup_rows(torch.as_tensor(ids),
                                       torch.as_tensor(g), 9)
    j_rep, j_gsum = j_sparse.dedup_rows(jnp.asarray(ids), jnp.asarray(g), 9)
    np.testing.assert_array_equal(rep.numpy(), _np(j_rep))
    real = rep.numpy() < 9
    np.testing.assert_allclose(gsum.numpy()[real], _np(j_gsum)[real],
                               rtol=1e-6, atol=1e-6)
    assert sorted(rep.numpy()[real]) == sorted(set(ids))
    for r, s in zip(rep.numpy()[real], gsum.numpy()[real]):
        np.testing.assert_allclose(s, g[ids == r].sum(0), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("count", [0, 7])
def test_sparse_rows_adam_matches_jax(count):
    rng = np.random.default_rng(count)
    table, mu = (rng.normal(size=(12, 6)).astype(np.float32)
                 for _ in range(2))
    nu = rng.random((12, 6)).astype(np.float32)
    ids = np.array([3, 1, 3, 1, 1, 8, 0], np.int32)
    g = rng.normal(size=(7, 6)).astype(np.float32)
    want = j_sparse.sparse_rows_adam(jnp.asarray(table), jnp.asarray(mu),
                                     jnp.asarray(nu), jnp.asarray(ids),
                                     jnp.asarray(g), jnp.int32(count), 0.1)
    got = [torch.as_tensor(x.copy()) for x in (table, mu, nu)]
    sparse_adam.sparse_rows_adam(*got, torch.as_tensor(ids),
                                 torch.as_tensor(g), count, 0.1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-7)
    untouched = [r for r in range(12) if r not in ids]
    np.testing.assert_array_equal(got[0].numpy()[untouched],
                                  table[untouched])
    np.testing.assert_array_equal(got[1].numpy()[untouched], mu[untouched])
    p, m, v, gd = (np.float32(x) for x in (0.3, 0.1, 0.2, -0.7))
    want = j_sparse.dense_adam_leaf(*map(jnp.asarray, (p, m, v, gd)),
                                    jnp.int32(count), 0.1)
    got = [torch.tensor(x) for x in (p, m, v)]
    sparse_adam.dense_adam_leaf(*got, torch.tensor(gd), count, 0.1)
    for a, b in zip(got, want):
        assert float(a) == pytest.approx(float(b), rel=1e-6)


# -- the forced tier against the dense numpy oracle --------------------------

def _lazy_update(tbl, m, v, g_dense, touched, count, lr):
    """Dense-scatter lazy-Adam oracle: update only the touched rows."""
    t = count + 1
    m[touched] = B1 * m[touched] + (1 - B1) * g_dense[touched]
    v[touched] = B2 * v[touched] + (1 - B2) * g_dense[touched] ** 2
    mhat = m[touched] / (1 - B1 ** t)
    vhat = v[touched] / (1 - B2 ** t)
    tbl[touched] = tbl[touched] - lr * mhat / (np.sqrt(vhat) + EPS)


def _oracle_epoch(spec, steps, lr, batch_all, params):
    """Dense-scatter lazy-Adam replay of a whole epoch's batches from
    zero moments at count 0, with the JAX model's rows spec: returns
    (P, QI, D, mP, losses) after ``steps`` updates."""
    names = tuple(n for n, _ in spec["planes"])
    sides = tuple(sd for _, sd in spec["planes"])
    P, QI = (np.array(x) for x in spec["pack"](params)[:2])
    D = [np.array(d) for d in spec["pack"](params)[2]]
    mP, vP, mQI, vQI = (np.zeros_like(x) for x in (P, P, QI, QI))
    mD = [np.zeros_like(d) for d in D]
    vD = [np.zeros_like(d) for d in D]
    losses = []
    for t in range(steps):
        batch = {k: np.asarray(v[t]) for k, v in batch_all.items()}
        wv = jnp.asarray(batch["w"])[:, None]
        flts = tuple(jnp.asarray(batch[n], jnp.float32)[:, None]
                     for n in spec["floats"])
        ids = tuple(batch[n].astype(np.int32) for n in names)
        rows_g = tuple(jnp.asarray((P if sd == "u" else QI)[idx])
                       for idx, sd in zip(ids, sides))
        dn = tuple(jnp.asarray(d) for d in D)
        loss, (g_rows, g_dense) = jax.value_and_grad(
            lambda rg, d_: spec["row_loss"](rg, flts, d_, wv),
            argnums=(0, 1))(rows_g, dn)
        losses.append(float(loss))
        gP = np.zeros_like(P)
        gQI = np.zeros_like(QI)
        for idx, sd, g in zip(ids, sides, g_rows):
            np.add.at(gP if sd == "u" else gQI, idx, np.asarray(g))
        u_touch = np.unique(np.concatenate(
            [idx for idx, sd in zip(ids, sides) if sd == "u"]))
        i_touch = np.unique(np.concatenate(
            [idx for idx, sd in zip(ids, sides) if sd == "i"]))
        _lazy_update(P, mP, vP, gP, u_touch, t, lr)
        _lazy_update(QI, mQI, vQI, gQI, i_touch, t, lr)
        for k_ in range(len(D)):
            g_ = np.asarray(g_dense[k_])
            mD[k_] = B1 * mD[k_] + (1 - B1) * g_
            vD[k_] = B2 * vD[k_] + (1 - B2) * g_ ** 2
            D[k_] = D[k_] - lr * (mD[k_] / (1 - B1 ** (t + 1))) / (
                np.sqrt(vD[k_] / (1 - B2 ** (t + 1))) + EPS)
    return P, QI, D, mP, losses


@pytest.mark.parametrize("name", ["SBPR", "CUNE_BPR", "BPR"])
def test_forced_tier_matches_the_dense_oracle(toy_social_dataset,
                                              toy_dataset, name):
    """One epoch of the port's forced tier on the port's own draw,
    replayed by the oracle with the JAX model's rows spec from the same
    parameters (tests/test_sparse_rows.py:40-170)."""
    toy = toy_dataset if name == "BPR" else toy_social_dataset
    (_, _, jmodel), (cfg, data, model) = _both(toy, name)
    tr = Trainer(model, data, cfg, device="cpu")
    assert tr.sparse_rows and not tr.fused
    params, state = tr.init_state()
    j_params = {k: jnp.asarray(p.detach().numpy().copy())
                for k, p in params.items()}
    tensors = tr.sample_epoch()
    batch_all = {k: v.numpy() for k, v in tensors.items()}
    got_p, got_o, got_loss = tr._run_epoch(params, state, tensors)

    spec = jmodel.fused_rows_spec()
    P, QI, D, mP, losses = _oracle_epoch(spec, tr.steps_per_epoch,
                                         cfg.lr, batch_all, j_params)
    got = spec["pack"]({k: jnp.asarray(v.detach().numpy())
                        for k, v in got_p.items()})
    # f32 trajectory tolerance, as tests/test_sparse_rows.py:111-130: the
    # tier sums duplicate grads in another order than np.add.at, and
    # early Adam steps (tiny v_hat) amplify it.
    np.testing.assert_allclose(_np(got[0]), P, rtol=4e-3, atol=1e-5)
    np.testing.assert_allclose(_np(got[1]), QI, rtol=4e-3, atol=1e-5)
    for gd, d_ in zip(got[2], D):
        np.testing.assert_allclose(_np(gd), d_, rtol=4e-3, atol=1e-5)
    np.testing.assert_allclose(got_o.mu["P"].numpy(), mP, rtol=4e-3,
                               atol=1e-6)
    assert got_o.count == tr.steps_per_epoch
    assert float(got_loss) == pytest.approx(np.mean(losses), rel=1e-5)
    if name != "BPR":                        # the PAD slot passes through
        assert float(got_p["bias"].detach()[-1]) == 0.0


def test_forced_tier_trains_and_evaluates(toy_social_dataset):
    (_, _, _), (cfg, data, model) = _both(toy_social_dataset, "SBPR",
                                          epoches="4")
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = tr.init_state()
    params, state, losses = tr.train_epochs(params, state, 4)
    assert losses[-1] < losses[0]
    assert all(np.isfinite(np.asarray(v)).all()
               for v in tr.evaluate().values())


def test_tier_not_default_unless_forced(toy_social_dataset, toy_dataset):
    """Without the force the tier stays off (tests/test_sparse_rows.py:184);
    forced, it takes precedence over the fused tier."""
    off = {"train.sparse_rows_force": "False"}
    for toy, name, extra, want in (
            (toy_social_dataset, "SBPR", off, False),
            (toy_social_dataset, "SBPR", {**off, "train.sparse_rows": "True"},
             False),
            (toy_dataset, "BPR", off, False),
            (toy_social_dataset, "SBPR", {"train.fused_kernel": "True"}, True),
            (toy_social_dataset, "TBPR", {}, True)):
        (_, _, _), (cfg, data, model) = _both(toy, name, **extra)
        tr = Trainer(model, data, cfg, device="cpu")
        assert tr.sparse_rows == want, (name, extra)
        if want:
            assert not tr.fused


@pytest.mark.parametrize("social,name,extra", [
    (True, "SBPR", {"optimizer": "SGD"}),
    (True, "SBPR", {"optimizer": "Adagrad"}),
    (False, "BPR", {"optimizer": "Adagrad"}),
    (False, "GMF", {"is_pairwise": "False", "loss_func": "cross_entropy"})])
def test_force_on_what_the_tier_does_not_take_raises(
        toy_social_dataset, toy_dataset, social, name, extra):
    """The tier needs Adam and a rows spec: forced anywhere else it
    raises rather than train on another tier."""
    toy = toy_social_dataset if social else toy_dataset
    (_, _, _), (cfg, data, model) = _both(toy, name, **extra)
    with pytest.raises(ValueError, match=f"sparse_rows_force.*{name}"):
        Trainer(model, data, cfg, device="cpu")


# -- the per-step samplers --------------------------------------------------

def _tables(sets, n, id_range, bitmap=True):
    t = sampling.build_member_table(sets, n, id_range,
                                    bitmap_budget=(1 << 30) if bitmap else 0)
    j = j_sampling.build_member_table(
        sets, n, id_range, bitmap_budget=(1 << 30) if bitmap else 0,
        complement_budget=1 << 30)
    return sampling.table_to(t, "cpu"), jax.tree_util.tree_map(jnp.asarray, j)


@pytest.mark.parametrize("bitmap", [True, False])
def test_member_matches_jax(bitmap):
    rng = np.random.default_rng(0)
    sets = {u: rng.choice(300, size=rng.integers(1, 50),
                          replace=False).tolist() for u in range(40)}
    t, jt = _tables(sets, 40, 300, bitmap)
    assert (t.bits is not None) == bitmap
    e = rng.integers(0, 40, 500).astype(np.int32)
    q = rng.integers(0, 300, (500, 3)).astype(np.int32)
    got = sampling.member(t, torch.as_tensor(e), torch.as_tensor(q))
    np.testing.assert_array_equal(
        got.numpy(), _np(j_sampling.member(jt, jnp.asarray(e),
                                           jnp.asarray(q))))
    want = np.array([[x in sets[u] for x in row] for u, row in zip(e, q)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_not_in_matches_jax():
    """The exact draw maps a rank to JAX's complement entry of that rank;
    the rejection draw (a bitmap alone) avoids the set too; both cover
    the complement uniformly, as JAX's draws do."""
    sets = {0: [0, 1, 2, 3, 4], 1: list(range(15)), 2: [19]}
    t, jt = _tables(sets, 3, 50)
    comp = _np(jt.complement)
    for u, items in sets.items():
        n_un = 50 - len(items)
        got = sampling.unseen_by_rank(t.rows, t.lens,
                                      torch.full((n_un,), u),
                                      torch.arange(n_un))
        np.testing.assert_array_equal(got.numpy(), comp[u, :n_un])
    gen = torch.Generator().manual_seed(0)
    u = torch.zeros(20000, dtype=torch.int32)
    want = _np(j_sampling.sample_not_in(jax.random.PRNGKey(2), jt,
                                        jnp.zeros(20000, jnp.int32), 50,
                                        (20000,)))
    for table in (t, t._replace(rows=None)):
        j = sampling.sample_not_in(gen, table, u, 50, (20000,)).numpy()
        assert set(j) == set(want) == set(range(5, 50))
        assert scipy.stats.chisquare(np.bincount(j)[5:]).pvalue > 1e-3
    negs = sampling.sample_not_in(gen, t, torch.tensor([0, 1, 2, 1]), 50,
                                  (4, 6)).numpy()
    assert negs.shape == (4, 6)
    for row, uu in zip(negs, (0, 1, 2, 1)):
        assert not set(row) & set(sets[uu])


def test_pairwise_pointwise_cml_batches(toy_dataset):
    """As tests/test_sampling.py:102-154."""
    gen = torch.Generator().manual_seed(3)
    pos_u, pos_i = torch.tensor([0, 0, 1]), torch.tensor([2, 3, 4])
    t, _ = _tables({0: [2, 3], 1: [4]}, 2, 10)
    b = sampling.pairwise_batch(gen, torch.arange(6), torch.ones(6), pos_u,
                                pos_i, t, 10, 2)
    got = sorted(zip(b["u"].tolist(), b["i"].tolist()))
    assert got == [(0, 2), (0, 2), (0, 3), (0, 3), (1, 4), (1, 4)]
    for uu, jj in zip(b["u"].tolist(), b["j"].tolist()):
        assert jj not in ([2, 3] if uu == 0 else [4])
    t, _ = _tables({0: [5], 1: [6]}, 2, 10)
    b = sampling.pointwise_batch(gen, torch.arange(8), torch.ones(8),
                                 torch.tensor([0, 1]), torch.tensor([5, 6]),
                                 t, 10, 3)
    assert float(b["y"].sum()) == 2
    for uu, ii, yy in zip(b["u"].tolist(), b["i"].tolist(), b["y"].tolist()):
        assert (ii == (5 if uu == 0 else 6)) == (yy == 1.0)
    t, _ = _tables({0: [5], 1: [6]}, 2, 12)
    b = sampling.cml_batch(gen, torch.arange(2), torch.ones(2),
                           torch.tensor([0, 1]), torch.tensor([5, 6]), t, 12,
                           4)
    assert b["negs"].shape == (2, 4)
    assert 5 not in b["negs"][0].tolist() and 6 not in b["negs"][1].tolist()


def _lists(csr, n):
    """{user: list} of a ``build_csr_lists`` dict."""
    lens = sampling.csr_lens(csr)
    return {u: csr["flat"][csr["off"][u]:csr["off"][u] + lens[u]].tolist()
            for u in range(n) if lens[u]}


def _social(toy, name):
    (_, _, _), (cfg, data, model) = _both(toy, name)
    tr = Trainer(model, data, cfg.with_overrides(
        **{"train.sbpr_epoch_tensors": "False"}), device="cpu")
    return data, tr


def _check_negatives(j, u, excluded, item_nums, exact):
    """No negative in its user's excluded set when the draw is exact; by
    rejection, no more misses than density^(TRIES + EXTRA_ROUNDS) a slot
    predicts (the toy's sets fill most of its 40 items).  The rest are
    uniform over the user's free items (the most frequent user's)."""
    bad = np.array([jj in excluded[uu] for uu, jj in zip(u, j)])
    if exact:
        assert not bad.any()
    else:
        dens = np.array([len(excluded[uu]) / item_nums for uu in u])
        rounds = sampling.TRIES + sampling.EXTRA_ROUNDS
        assert bad.sum() <= 3 * np.sum(dens ** rounds) + 3
    uu = np.bincount(u).argmax()
    free = sorted(set(range(item_nums)) - excluded[uu])
    mine = j[(u == uu) & ~bad]
    counts = np.bincount(np.searchsorted(free, mine), minlength=len(free))
    assert scipy.stats.chisquare(counts).pvalue > 1e-4


@pytest.mark.parametrize("social_neg", [True, False])
def test_sbpr_batch_invariants(toy_social_dataset, social_neg):
    """k in SPu(u) with its suk, j outside seen(u) and SPu(u), exactly
    through the union table or by rejection against both sets; j
    uniform over the rest."""
    data, tr = _social(toy_social_dataset, "SBPR")
    csr = tr.model_aux["spu_csr"]
    spu, suk, off = csr["flat"], csr["suk"], csr["off"]
    lens = sampling.csr_lens(csr)
    seen, spu_t = (sampling.table_to(sampling.build_member_table(
        sets, data.user_nums, data.item_nums), "cpu") for sets in (
            data.ui_train, _lists(csr, data.user_nums)))
    rows = torch.arange(tr.n_pairs * 2).repeat(40)
    b = sampling.sbpr_batch(
        torch.Generator().manual_seed(1), rows, torch.ones(len(rows)),
        tr.aux["pos_u"], tr.aux["pos_i"], seen, data.item_nums, 2, spu_t,
        {k: torch.as_tensor(v) for k, v in tr.model_aux["spu_csr"].items()},
        social_neg=tr._tables["social_neg"] if social_neg else None)
    u, k, j = (b[x].numpy() for x in ("u", "k", "j"))
    excluded = {}
    for uu in np.unique(u):
        mine = spu[off[uu]:off[uu] + lens[uu]].tolist()
        sel = u == uu
        assert set(k[sel]) <= set(mine)
        np.testing.assert_array_equal(
            b["suk"].numpy()[sel], [suk[off[uu] + mine.index(x)]
                                    for x in k[sel]])
        excluded[uu] = set(mine) | set(data.ui_train[uu])
    _check_negatives(j, u, excluded, data.item_nums, social_neg)


@pytest.mark.parametrize("social_neg", [True, False])
def test_tbpr_batch_invariants(toy_social_dataset, social_neg):
    """s from the strong ties' list, t from the weak ties', j outside the
    seen, strong and weak sets (exactly, or by rejection)."""
    data, tr = _social(toy_social_dataset, "TBPR")
    aux = tr.model_aux
    strong, weak = (_lists(aux[n], data.user_nums) for n in (
        "ts_csr", "tw_csr"))
    tabs = [sampling.table_to(sampling.build_member_table(
        sets, data.user_nums, data.item_nums), "cpu")
        for sets in (strong, weak)]
    csr = {n: {k: torch.as_tensor(v) for k, v in aux[n].items()}
           for n in ("ts_csr", "tw_csr")}
    rows = torch.arange(tr.n_pairs * 2).repeat(40)
    b = sampling.tbpr_batch(
        torch.Generator().manual_seed(2), rows, torch.ones(len(rows)),
        tr.aux["pos_u"], tr.aux["pos_i"],
        sampling.table_to(tr.dd.seen, "cpu"), data.item_nums, 2,
        *tabs, csr["ts_csr"], csr["tw_csr"],
        social_neg=tr._tables["social_neg"] if social_neg else None)
    u, s, t, j = (b[x].numpy() for x in ("u", "s", "t", "j"))
    for uu, ss, tt in zip(u, s, t):
        assert ss in strong[uu] and tt in weak[uu]
    excluded = {uu: set(strong[uu]) | set(weak[uu]) | set(data.ui_train[uu])
                for uu in np.unique(u)}
    _check_negatives(j, u, excluded, data.item_nums, social_neg)


def test_samn_batch(toy_social_dataset):
    data = load_ranking_data(Config(base_config(
        toy_social_dataset, social_file="trusts.csv").to_dict()))
    fp = torch.as_tensor(data.friends_padded)
    t = sampling.table_to(sampling.build_member_table(
        data.ui_train, data.user_nums, data.item_nums), "cpu")
    pos_u = torch.as_tensor([u for u, v in data.ui_train.items() for _ in v])
    pos_i = torch.as_tensor([i for v in data.ui_train.values() for i in v])
    b = sampling.samn_batch(torch.Generator().manual_seed(4),
                            torch.arange(len(pos_u)), torch.ones(len(pos_u)),
                            pos_u, pos_i, t, data.item_nums, 1, fp)
    np.testing.assert_array_equal(b["friends"].numpy(),
                                  data.friends_padded[b["u"].numpy()])
    np.testing.assert_array_equal(b["u"].numpy(), pos_u.numpy())
    assert not any(j in data.ui_train[u] for u, j in zip(
        b["u"].tolist(), b["j"].tolist()))


def _jax_per_step_draws(j_tr, key):
    """JAX's per-step batches of one epoch, materialised: the scan tier's
    step keys and permutation, each step's ``_build_batch``
    (cleverrec_tpu/train/trainer.py:1524-1572)."""
    build_xs = j_tr._scan_parts[0]
    (perm, valid), step_keys = build_xs(key, j_tr.arrays)
    steps = [j_tr._build_batch(jax.random.split(k)[0], r, v, j_tr.arrays)
             for k, r, v in zip(step_keys, perm, valid)]
    return {k: np.stack([_np(s[k]) for s in steps]) for k in steps[0]}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["SBPR", "TBPR"])
def test_per_step_epoch_on_jax_draws_matches_jax(toy_social_dataset, name,
                                                 fused):
    """``train.sbpr_epoch_tensors=False``: from JAX's state one epoch in,
    one epoch on the JAX scan tier's per-step draw through the port's
    scan tier and its fused tier (the rows kernel's plain version here)
    follows the JAX scan tier."""
    opts = {"train.sbpr_epoch_tensors": "False",
            "train.sparse_rows_force": "False", "lr": "0.01",
            "batch_size": "64"}
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(toy_social_dataset,
                                                      name, **opts)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    assert "sbpr_static" not in j_tr.arrays
    tr = Trainer(model, data, cfg.with_overrides(
        **{"train.fused_kernel": str(fused)}), device="cpu")
    assert tr.fused == fused and tr._per_step
    assert tr.steps_per_epoch == j_tr.steps_per_epoch
    params, state = j_tr.init_state()
    params, state, _ = j_tr.train_epoch(params, state)
    p0 = {k: np.array(v) for k, v in params.items()}
    key = jax.random.PRNGKey(7)
    batch = _jax_per_step_draws(j_tr, key)
    want_p, want_s, want_loss = j_tr._epoch_body(
        {k: jnp.asarray(v) for k, v in p0.items()}, state, key, j_tr.arrays)
    load_params(model, p0)
    t_state = adam_state_from_jax(
        state[0].count, {k: _np(v) for k, v in state[0].mu.items()},
        {k: _np(v) for k, v in state[0].nu.items()}, "cpu", model=model)
    got_p, got_s, loss = tr._run_epoch(dict(model.named_parameters()),
                                       t_state,
                                       {k: _t(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-4)
    assert got_s.count == int(want_s[0].count)
    for k in p0:
        for got, want in ((got_p[k], want_p[k]), (got_s.mu[k],
                                                   want_s[0].mu[k])):
            np.testing.assert_allclose(got.detach().numpy(), _np(want),
                                       rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["SBPR", "TBPR", "CUNE_BPR"])
def test_per_step_samplers_train_both_tiers(toy_social_dataset, name):
    """The per-step draw trains on both tiers, the fused one (the plain
    rows epoch here) giving the scan tier's numbers on the same draw; no
    static epoch layout is built."""
    opts = {"train.sbpr_epoch_tensors": "False",
            "train.sparse_rows_force": "False"}
    (_, _, _), (cfg, data, model) = _both(toy_social_dataset, name, **opts)
    trainers = {f: Trainer(model, data, cfg.with_overrides(
        **{"train.fused_kernel": str(f)}), device="cpu") for f in (0, 1)}
    assert [t.fused for t in trainers.values()] == [False, True]
    assert trainers[0]._static == {}
    results = {}
    for f, tr in trainers.items():
        params, state = tr.init_state()
        draws = [tr.sample_epoch() for _ in range(3)]
        tr.init_state()
        losses = [float(tr._run_epoch(params, state, d)[2]) for d in draws]
        assert losses[-1] < losses[0]
        results[f] = (losses, {k: p.detach().clone()
                               for k, p in params.items()})
        assert sorted(tr.evaluate()) == cfg.topk
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-4)
    for k, p in results[0][1].items():
        np.testing.assert_allclose(p.numpy(), results[1][1][k].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    assert T.launches["rows_epoch"] == 0
