"""Popularity negatives (``neg_sampling=popularity``) in the port against
the JAX package: the popularity CDF, the draw's distribution over unseen
items, its seen hits against JAX's, every sampler and tier that takes
it, and the protocols that refuse it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from cleverrec_tpu import sampling as j_sampling
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import sampling
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.trainer import popularity_cdf
from tests.conftest import base_config

POP = {"neg_sampling": "popularity"}
# The chi-square test of a draw against the popularity mass rejects at
# this p: a correct sampler fails it one run in a thousand, and the draws
# are seeded, so a pass is a pass every run.
CHI2_P = 1e-3
# Seen hits, port against JAX, at the same density: the port's rate at
# most JAX's plus this many binomial standard deviations.
HIT_SIGMAS = 5.0
# The toy confs of each family (tests/test_torch_{ncf,metric,samn,
# itemsim,graph}.py) with popularity negatives.
MODELS = {
    "BPR": {},
    "GMF": {"is_pairwise": "False", "loss_func": "cross_entropy"},
    "CML": {"margin": "0.5", "reg": "1.0", "neg_ratio": "3",
            "is_pairwise": "False", "loss_func": "hinge"},
    "NAIS": {"atten_size": "8", "beta": "0.5", "optimizer": "Adagrad",
             "is_pairwise": "False", "loss_func": "cross_entropy",
             "batch_size": "256", "stddev": "0.1"},
    "SAMN": {"mem_size": "4", "atten_size": "6", "reg1": "0.01",
             "reg2": "0.03", "lr": "0.05", "neg_ratio": "1",
             "optimizer": "Adagrad", "social_file": "trusts.csv"},
    "RML_DGATs": {"atten_size": "8", "train_batches": "3",
                  "loss_func": "hinge", "margin": "0.5", "gamma": "0.1",
                  "reg1": "0.1", "reg2": "0.01", "att_type": "2",
                  "mlp_type": "0", "max_i": "5", "max_s": "3",
                  "social_file": "trusts.csv"},
    "SBPR": {"social_file": "trusts.csv"},
    "TBPR": {"social_file": "trusts.csv"},
}


def _np(x):
    return np.asarray(x)


def _setup(toy, name, **overrides):
    jcfg = base_config(toy, **{"recommender": name, **MODELS[name], **POP,
                               **overrides})
    cfg = Config(jcfg.to_dict())
    return jcfg, cfg, load_ranking_data(cfg)


def _model(cfg, data):
    return make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                      device="cpu")


def _zipf_cdf(n_items, seed=0):
    """A skewed popularity CDF over ``n_items`` (every item at least 1)."""
    deg = np.floor(400.0 / np.arange(1, n_items + 1) ** 0.8) + 1
    deg = np.random.default_rng(seed).permutation(deg)
    return deg, (np.cumsum(deg) / deg.sum()).astype(np.float32)


def test_pop_cdf_matches_jax(toy_dataset):
    """float64 degrees, their cumsum over the total, then float32: equal to
    the JAX trainer's array, element for element; the trainer holds it."""
    jcfg, cfg, data = _setup(toy_dataset, "BPR")
    jdata = j_load_ranking_data(jcfg)
    j_tr = JTrainer(j_make_model(jcfg, JMeta(jdata.user_nums,
                                             jdata.item_nums)), jdata, jcfg)
    want = _np(j_tr.arrays["pop_cdf"])
    got = popularity_cdf(build_device_data(data), cfg, "pairwise")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    tr = Trainer(_model(cfg, data), data, cfg, device="cpu")
    np.testing.assert_array_equal(tr._pop_cdf.numpy(), want)
    assert popularity_cdf(build_device_data(data), cfg.with_overrides(
        neg_sampling="uniform"), "sbpr") is None


def test_draw_follows_the_popularity_mass():
    """One user's 200,000 draws over 60 items, 12 of them seen (the most
    popular among them): the counts of the unseen items against the
    popularity mass renormalised over them, chi-square at ``CHI2_P``;
    no seen item is drawn; JAX's draw passes the same test."""
    n_items, n = 60, 200_000
    deg, cdf = _zipf_cdf(n_items)
    seen = sorted(np.argsort(-deg)[:6].tolist()
                  + np.argsort(-deg)[20:26].tolist())
    unseen = np.setdiff1d(np.arange(n_items), seen)
    expect = deg[unseen] / deg[unseen].sum() * n
    table = sampling.table_to(
        sampling.build_member_table({0: seen}, 1, n_items), "cpu")
    e = torch.zeros(n, dtype=torch.int64)
    got = sampling.sample_not_in_popular(
        torch.Generator().manual_seed(0), table, e, torch.as_tensor(cdf),
        (n,))
    assert got.dtype == torch.int32 and got.shape == (n,)
    counts = np.bincount(got.numpy(), minlength=n_items)
    assert counts[seen].sum() == 0
    assert stats.chisquare(counts[unseen], expect).pvalue > CHI2_P
    j_table = j_sampling.build_member_table({0: seen}, 1, n_items)
    j_got = _np(j_sampling.sample_not_in_popular(
        jax.random.PRNGKey(0), j_table, jnp.zeros(n, jnp.int32),
        jnp.asarray(cdf), (n,)))
    j_counts = np.bincount(j_got, minlength=n_items)
    assert stats.chisquare(j_counts[unseen], expect).pvalue > CHI2_P
    # [B, K] draws (the CML protocol's) follow the same mass.
    got2 = sampling.sample_not_in_popular(
        torch.Generator().manual_seed(1), table, e[:n // 4],
        torch.as_tensor(cdf), (n // 4, 4))
    counts2 = np.bincount(got2.numpy().ravel(), minlength=n_items)
    assert counts2[seen].sum() == 0
    assert stats.chisquare(counts2[unseen], expect).pvalue > CHI2_P


@pytest.mark.parametrize("case", ["toy", "heavy"])
def test_seen_hits_no_more_than_jax(toy_dataset, case):
    """Seen hits at the same density in both packages: the toy's seen
    table and CDF, every user 2,000 times; and a heavy user whose seen
    items hold 0.9 of the mass, where 34 seen draws in a row happen about
    3% of the time.  The port's hit rate is at most JAX's plus
    ``HIT_SIGMAS`` binomial standard deviations."""
    if case == "toy":
        jcfg, cfg, data = _setup(toy_dataset, "BPR")
        dd = build_device_data(data)
        sets = {u: list(data.ui_train[u]) for u in data.ui_train}
        n_items, n_users = data.item_nums, data.user_nums
        cdf = popularity_cdf(dd, cfg, "pairwise")
        e = np.repeat(np.arange(n_users), 2000)
    else:
        n_items, n_users = 100, 1
        deg = np.ones(n_items)
        deg[:10] = 9.0 * (n_items - 10) / 10         # 0.9 of the mass
        cdf = (np.cumsum(deg) / deg.sum()).astype(np.float32)
        sets = {0: list(range(10))}
        e = np.zeros(40_000, np.int64)
    table = sampling.table_to(
        sampling.build_member_table(sets, n_users, n_items), "cpu")
    got = sampling.sample_not_in_popular(
        torch.Generator().manual_seed(0), table, torch.as_tensor(e),
        torch.as_tensor(cdf), e.shape)
    hits = int(sampling.member(table, torch.as_tensor(e), got).sum())
    j_table = j_sampling.build_member_table(sets, n_users, n_items)
    j_got = j_sampling.sample_not_in_popular(
        jax.random.PRNGKey(0), j_table, jnp.asarray(e, jnp.int32),
        jnp.asarray(cdf), e.shape)
    j_hits = int(_np(j_sampling.member(j_table, jnp.asarray(e, jnp.int32),
                                       j_got)).sum())
    rate = j_hits / len(e)
    band = HIT_SIGMAS * np.sqrt(max(rate, 1.0 / len(e)) / len(e))
    assert hits / len(e) <= rate + band, (hits, j_hits)
    if case == "heavy":
        assert 0.01 < rate < 0.06 and hits > 0


def _popular_share(items, cdf):
    """The share of ``items`` among the most popular fifth of the catalog,
    and that fifth's share of the catalog's popularity mass."""
    deg = np.diff(np.concatenate([[0.0], cdf.astype(np.float64)]))
    top = np.argsort(-deg)[: max(len(deg) // 5, 1)]
    return np.isin(items, top).mean(), deg[top].sum()


def test_per_step_and_epoch_samplers_take_pop_cdf(toy_dataset):
    """pairwise_batch, pointwise_batch, cml_batch and the three epoch
    tensors with a skewed pop_cdf: negatives unseen, and the catalog's
    most popular fifth drawn about in proportion to its mass, well above
    its uniform share (the toy's own popularity is too flat to tell)."""
    _, cfg, data = _setup(toy_dataset, "BPR")
    dd = build_device_data(data)
    cdf = _zipf_cdf(dd.item_nums)[1]
    pop = torch.as_tensor(cdf)
    seen = sampling.table_to(dd.seen, "cpu")
    pos_u, pos_i = torch.as_tensor(dd.pos_u), torch.as_tensor(dd.pos_i)
    gen = torch.Generator().manual_seed(0)
    rows, valid = sampling.epoch_permutation(gen, len(pos_u) * 3,
                                             len(pos_u) * 3)
    negs = []
    out = sampling.pairwise_batch(gen, rows, valid, pos_u, pos_i, seen,
                                  dd.item_nums, 3, pop)
    negs.append((out["u"], out["j"]))
    out = sampling.pointwise_batch(gen, rows, valid, pos_u, pos_i, seen,
                                   dd.item_nums, 2, pop)
    neg = out["y"] == 0
    negs.append((out["u"][neg], out["i"][neg]))
    out = sampling.cml_batch(gen, rows, valid, pos_u, pos_i, seen,
                             dd.item_nums, 3, pop)
    assert out["negs"].shape == (len(rows), 3)
    negs.append((out["u"].repeat_interleave(3), out["negs"].reshape(-1)))
    padded = 64 * 40
    for fn, static_fn, k in (
            (sampling.pairwise_epoch_tensors, sampling.pairwise_epoch_static,
             2),
            (sampling.pointwise_epoch_tensors,
             sampling.pointwise_epoch_static, 2),
            (sampling.cml_epoch_tensors, sampling.pairwise_epoch_static, 1)):
        static = {key: torch.as_tensor(v) for key, v in static_fn(
            dd.pos_u, dd.pos_i, dd.seen.lens, dd.item_nums, padded,
            k).items()}
        kw = {"neg_ratio": 3} if fn is sampling.cml_epoch_tensors else {}
        t = fn(gen, static, seen.rows, seen.lens,
               len(dd.pos_u) * (k + (fn is sampling.pointwise_epoch_tensors)),
               40, 64, pop_cdf=pop, bits=seen.bits, **kw)
        real = t["w"] > 0
        if "negs" in t:
            negs.append((t["u"][real].repeat_interleave(3),
                         t["negs"][real].reshape(-1)))
        elif "j" in t:
            negs.append((t["u"][real], t["j"][real]))
        else:
            is_neg = real & (t["y"] == 0)
            negs.append((t["u"][is_neg], t["i"][is_neg]))
    for u, j in negs:
        assert not sampling.member(seen, u, j).any()
        share, mass = _popular_share(j.numpy(), cdf)
        assert share > 0.2 + 0.5 * (mass - 0.2), (share, mass)


def _tier(tr):
    return ("dual" if tr.model.sampler == "dual"
            else "grouped" if tr._grid is not None
            else "bucketed" if tr._buckets is not None
            else "lazy" if tr.sparse_rows else "fused" if tr.fused
            else "scan")


@pytest.mark.parametrize("name,over,tier", [
    ("BPR", {}, "scan"),
    ("BPR", {"train.fused_kernel": "True"}, "fused"),
    ("BPR", {"train.sparse_rows_force": "True"}, "lazy"),
    ("GMF", {"train.fused_kernel": "True"}, "fused"),
    ("GMF", {}, "scan"),
    ("CML", {"train.fused_kernel": "True"}, "fused"),
    ("CML", {}, "scan"),
    ("NAIS", {}, "bucketed"),
    ("NAIS", {"train.bucketed_histories": "False"}, "scan"),
    ("SAMN", {}, "grouped"),
    ("RML_DGATs", {}, "dual"),
])
def test_every_tier_trains_with_popularity(toy_social_dataset, name, over,
                                           tier):
    """Each protocol on each tier trains two epochs on popularity
    negatives: finite losses, and the epoch's negatives unseen."""
    _, cfg, data = _setup(toy_social_dataset, name, **over)
    tr = Trainer(_model(cfg, data), data, cfg, device="cpu")
    assert _tier(tr) == tier and tr._pop_cdf is not None
    params, state = tr.init_state()
    params, state, losses = tr.train_epochs(params, state, 2)
    assert np.all(np.isfinite(losses)), losses
    draw = tr.sample_epoch()
    table = tr._seen_table()
    if "buckets" in draw:
        pairs = [(b["dev"]["g_user"][:, None].expand_as(d["gt"]), d["gt"],
                  (b["dev"]["g_y"] == 0) & (b["dev"]["g_w"] > 0))
                 for b, d in zip(tr._buckets, draw["buckets"])
                 if b["grid"] is not None]
    elif "perm" in draw:
        pairs = [(tr._pg["pg_user"][:, None].expand_as(draw["j"]),
                  draw["j"], tr._pg["pg_w"] > 0)]
    elif "negs" in draw:
        pairs = [(draw["u"][..., None].expand_as(draw["negs"]), draw["negs"],
                  (draw["w"] > 0)[..., None].expand_as(draw["negs"]))]
    elif "j" in draw:
        pairs = [(draw["u"], draw["j"], draw["w"] > 0)]
    else:
        pairs = [(draw["u"], draw["i"], (draw["y"] == 0) & (draw["w"] > 0))]
    for u, j, sel in pairs:
        assert sel.any()
        assert not sampling.member(table, u[sel], j[sel]).any()


@pytest.mark.parametrize("name", ["SBPR", "TBPR", "samn"])
def test_social_protocols_refuse_popularity(toy_social_dataset, monkeypatch,
                                            name):
    """The sbpr, tbpr and samn protocols raise JAX's ValueError: their
    negatives avoid the social items too."""
    model_name = "BPR" if name == "samn" else name
    jcfg, cfg, data = _setup(toy_social_dataset, model_name)
    model = _model(cfg, data)
    jdata = j_load_ranking_data(jcfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    if name == "samn":
        monkeypatch.setattr(model, "sampler", "samn")
        monkeypatch.setattr(jmodel, "sampler", "samn")
    with pytest.raises(ValueError, match="not supported for the"):
        JTrainer(jmodel, jdata, jcfg)
    with pytest.raises(ValueError, match="not supported for the"):
        Trainer(model, data, cfg, device="cpu")


def test_unknown_neg_sampling_raises(toy_dataset):
    _, cfg, data = _setup(toy_dataset, "BPR", neg_sampling="hard")
    with pytest.raises(ValueError, match="neg_sampling=hard"):
        Trainer(_model(cfg, data), data, cfg, device="cpu")
