"""The port's rankers and top-k against the JAX package: rank_fused on
both branches (narrow: dot_scores, wide: dot_gmax + rescue), rank_dense,
and grouped_topk, with constructed ties pinning the lowest-index rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu import ranking as jranking
from cleverrec_tpu.config import Config as JConfig
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.models.bpr import BPR as JBPR
from cleverrec_tpu.ops.topk import grouped_topk as j_grouped_topk
from cleverrec_tpu.ops.topk import merge_topk as j_merge_topk
from cleverrec_tpu_torch import ranking
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops.topk import grouped_topk, merge_topk
from cleverrec_tpu_torch.weights import load_params

# Scores are f32 dots of width 16: XLA and torch sum them in another
# order.  Relative and absolute, as the tied scores reach the hundreds.
TOL = 1e-5
B, D = 12, 16
# Identical item rows score equal for every user: (low, high) id pairs in
# one 32-item group and across groups, scaled to rank first.
TIES = {1000: [(3, 17, 100.0), (40, 900, 90.0)],
        9000: [(3, 17, 100.0), (40, 8000, 90.0)]}


def _setup(n_items):
    rng = np.random.default_rng(n_items)
    P = rng.normal(size=(40, D)).astype(np.float32)
    P[:, 0] = np.abs(P[:, 0]) + 1.0                 # ties rank on top
    Q = rng.normal(size=(n_items, D)).astype(np.float32)
    tie_ids = set()
    for lo, hi, scale in TIES[n_items]:
        Q[lo] = Q[hi] = scale * np.eye(D, dtype=np.float32)[0]
        tie_ids |= {lo, hi}
    users = np.arange(B, dtype=np.int32)
    seen = []
    for _ in range(B):
        s = rng.choice(n_items, size=60, replace=False)
        seen.append(np.sort(np.asarray([x for x in s if x not in tie_ids])))
    width = max(len(s) for s in seen)
    rows = np.full((B, width), n_items, np.int32)
    bits = np.zeros((B, -(-n_items // 32)), np.uint32)
    for r, s in enumerate(seen):
        rows[r, :len(s)] = s
        np.bitwise_or.at(bits[r], s >> 5, np.uint32(1) << (s & 31))
    values = {"recommender": "BPR", "embed_size": str(D), "reg": "0.01"}
    jmodel = JBPR(JConfig(values), JMeta(40, n_items))
    params = {"P": jnp.asarray(P), "Q": jnp.asarray(Q)}
    tmodel = make_model(Config(values), DataMeta(40, n_items), device="cpu")
    load_params(tmodel, {"P": P, "Q": Q})
    return jmodel, params, tmodel, users, rows, bits


def _ids(v, items):
    return np.where(np.isfinite(v), items, -1)


def assert_same_ranking(got, want):
    """Values within TOL; ids equal except where the value is tied (within
    TOL) with another value of the row or with the k-th."""
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_allclose(gv, wv, rtol=TOL, atol=TOL)
    gi, wi = _ids(gv, gi), _ids(wv, wi)
    for r, j in zip(*np.nonzero(gi != wi)):
        near = np.abs(np.delete(gv[r], j) - gv[r, j]) <= TOL
        assert near.any() or abs(gv[r, j] - gv[r, -1]) <= TOL, (r, j)


def _np(pair):
    v, i = pair
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("k", [10, 20])
@pytest.mark.parametrize("n_items", [1000, 9000])
def test_rank_fused_and_dense_match_jax(n_items, k):
    jmodel, params, tmodel, users, rows, bits = _setup(n_items)
    u_j, u_t = jnp.asarray(users), torch.as_tensor(users).long()
    want_dense = _np(jranking.rank_dense(jmodel, params, {}, u_j,
                                         jnp.asarray(rows), k))
    want_fused = _np(jranking.rank_fused(jmodel, params, {}, u_j,
                                         jnp.asarray(bits), k,
                                         interpret=True))
    got_dense = _np(ranking.rank_dense(tmodel, {}, u_t,
                                       torch.as_tensor(rows).long(), k))
    bits_t = torch.as_tensor(bits.view(np.int32))
    got_fused = _np(ranking.rank_fused(tmodel, {}, u_t, bits_t, k))
    got_pre = _np(ranking.rank_fused(
        tmodel, {}, u_t, bits_t, k, pre=ranking.fused_precompute(tmodel, {})))
    np.testing.assert_array_equal(got_pre[1], got_fused[1])
    for got in (got_dense, got_fused):
        assert_same_ranking(got, want_dense)
        assert_same_ranking(got, want_fused)
    # The port breaks ties by the lowest id on both branches, exactly as
    # the JAX dense path (lax.top_k) does.
    np.testing.assert_array_equal(got_fused[1], got_dense[1])
    np.testing.assert_array_equal(got_dense[1], want_dense[1])
    (lo1, hi1, _), (lo2, hi2, _) = TIES[n_items]
    np.testing.assert_array_equal(got_fused[1][:, :4],
                                  np.tile([lo1, hi1, lo2, hi2], (B, 1)))


def test_rank_fused_narrow_pads_k_past_catalog():
    """k above the catalog: the JAX path ranks padded (masked) columns,
    which come back as -inf."""
    jmodel, params, tmodel, users, rows, bits = _setup(1000)
    bits = bits[:, :1]            # 32-item catalog
    want = _np(jranking.rank_fused(
        JBPR(jmodel.cfg, JMeta(40, 32)), {"P": params["P"],
                                          "Q": params["Q"][:32]},
        {}, jnp.asarray(users), jnp.asarray(bits), 40, interpret=True))
    small = make_model(Config(dict(jmodel.cfg.to_dict())), DataMeta(40, 32),
                       device="cpu")
    load_params(small, {"P": np.asarray(params["P"]),
                        "Q": np.asarray(params["Q"][:32])})
    got = _np(ranking.rank_fused(small, {}, torch.as_tensor(users).long(),
                                 torch.as_tensor(bits.view(np.int32)), 40))
    assert got[0].shape == (B, 40)
    assert_same_ranking(got, want)
    assert np.isinf(got[0][:, -8:]).all()


@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("n", [1000, 20000])
def test_grouped_topk_matches_jax(n, k):
    rng = np.random.default_rng(n + k)
    scores = rng.normal(size=(6, n)).astype(np.float32)
    scores[:, rng.choice(n, n // 10, replace=False)] = -np.inf
    scores[:, [7, 300, n - 1]] = 9.0                 # a three-way tie
    scores[1, 128:256] = 4.0                         # a tied group
    v, i = _np(grouped_topk(torch.as_tensor(scores), k))
    want_v, want_i = _np(j_grouped_topk(jnp.asarray(scores), k))
    np.testing.assert_array_equal(v, want_v)         # pure selection
    assert_same_ranking((v, i), (want_v, want_i))
    # Lowest-index rule: exactly the (value desc, index asc) order.
    order = np.lexsort((np.broadcast_to(np.arange(n), scores.shape),
                        -scores), axis=1)[:, :k]
    np.testing.assert_array_equal(i, order)
    np.testing.assert_array_equal(
        i, np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1]))


def test_merge_topk_matches_jax():
    """Candidate blocks merged by value, ties to the lowest position."""
    rng = np.random.default_rng(5)
    values = rng.normal(size=(5, 64)).astype(np.float32)
    values[:, [2, 9, 40]] = 7.0                      # a three-way tie
    values[3, 10:20] = -np.inf
    ids = rng.permutation(5 * 64).reshape(5, 64).astype(np.int64)
    v, i = _np(merge_topk(torch.as_tensor(values), torch.as_tensor(ids), 8))
    want_v, want_i = _np(j_merge_topk(jnp.asarray(values),
                                      jnp.asarray(ids), 8))
    np.testing.assert_array_equal(v, want_v)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(i[:, :3], ids[:, [2, 9, 40]])
