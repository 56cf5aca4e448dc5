"""Time-aware models: RecentPopular, TItemCF, TUserCF, SessionGraph
(Basic/TimeBasedModel.py).

- RecentPopular (:55-101): item score = sum over its interactions of
  1 / (1 + alpha * (t0 - t)) — time-decayed popularity.
- TItemCF (:105-188): item-item co-occurrence similarity with optional
  interaction-time-gap decay 1/(1 + alpha*|t_ui - t_uj|); scoring decays
  by recency 1/(1 + beta*(t0 - t_ui)).  (The reference commented both
  decays out of its final run; alpha=beta=0 reproduces that exactly.)
- TUserCF (:193-267): user-user similarity decayed by co-rating time gap;
  scoring decays neighbors' interactions by recency.
- SessionGraph (:271-293): the reference's SGM is an empty stub
  (``path_fusion_u: pass``); here it is a working time-extended bipartite
  personalized-rank: nodes = users, items, and (user, time-bin) session
  nodes; recommendation = truncated power-iteration personalized rank.

Dense accumulators are used for the pairwise time-gap sums (exact, not
factorizable); guarded by a size cap with a decay-free sparse fallback.

(A numpy/scipy copy of cleverrec_tpu/classic/temporal.py.)
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from cleverrec_tpu_torch.classic.base import InteractionData, topn_from_scores

_DENSE_CAP = 6000  # max entity count for dense pairwise accumulation


class _TimedData:
    """(u, i, t) triples grouped per user, normalized to [0, 1] ages."""

    def __init__(self, triples, data: InteractionData):
        t = np.asarray(list(triples), dtype=np.float64)
        self.u = t[:, 0].astype(np.int64)
        self.i = t[:, 1].astype(np.int64)
        self.t = t[:, 2]
        self.t0 = self.t.max() if len(self.t) else 0.0
        self.data = data


class RecentPopular:
    def __init__(self, alpha: float = 1.0, time_scale: float = 86400.0):
        self.alpha = alpha
        self.time_scale = time_scale

    def fit_timed(self, td: _TimedData):
        self.data = td.data
        age = (td.t0 - td.t) / self.time_scale
        w = 1.0 / (1.0 + self.alpha * age)
        pop = np.zeros(td.data.item_nums)
        np.add.at(pop, td.i, w)
        self.pop = pop
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        scores = np.broadcast_to(self.pop, (len(users), len(self.pop)))
        return topn_from_scores(scores.copy(), self.data.seen_mask(users), n)


def _decayed_cooccurrence(entity_a, entity_b, times, n_a, n_b, alpha,
                          time_scale):
    """sim[a1, a2] = sum over shared b of 1/(1 + alpha*|t1 - t2|),
    accumulated densely per shared entity b."""
    sim = np.zeros((n_a, n_a))
    order = np.argsort(entity_b, kind="stable")
    eb, ea, tt = entity_b[order], entity_a[order], times[order]
    bounds = np.flatnonzero(np.diff(eb)) + 1
    for seg in np.split(np.arange(len(eb)), bounds):
        if len(seg) < 2:
            continue
        aa = ea[seg]
        ts = tt[seg] / time_scale
        w = 1.0 / (1.0 + alpha * np.abs(ts[:, None] - ts[None, :]))
        np.add.at(sim, (aa[:, None], aa[None, :]), w)
    np.fill_diagonal(sim, 0.0)
    return sim


class TimeItemCF:
    def __init__(self, k: int = 10, alpha: float = 1.0, beta: float = 1.0,
                 time_scale: float = 86400.0):
        self.k = k
        self.alpha = alpha
        self.beta = beta
        self.time_scale = time_scale

    def fit_timed(self, td: _TimedData):
        self.data = td.data
        n_i = td.data.item_nums
        if n_i > _DENSE_CAP:
            c = (td.data.train.T @ td.data.train).toarray()
            np.fill_diagonal(c, 0.0)
            sim = c
        else:
            sim = _decayed_cooccurrence(td.i, td.u, td.t, n_i,
                                        td.data.user_nums, self.alpha,
                                        self.time_scale)
        deg = np.maximum(td.data.item_degrees, 1e-9)
        sim = sim / np.sqrt(deg[:, None] * deg[None, :])
        # Keep top-k per row.
        if sim.shape[0] > self.k:
            kth = np.partition(sim, -self.k, axis=1)[:, -self.k][:, None]
            sim[sim < kth] = 0.0
        self.sim = sim
        # Recency-weighted user-item matrix for scoring.
        age = (td.t0 - td.t) / self.time_scale
        w = 1.0 / (1.0 + self.beta * age)
        self.r_w = sp.csr_matrix((w, (td.u, td.i)),
                                 shape=(td.data.user_nums, n_i))
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        scores = np.asarray(self.r_w[users] @ self.sim)
        return topn_from_scores(scores, self.data.seen_mask(users), n)


class TimeUserCF:
    def __init__(self, k: int = 80, alpha: float = 1.0, beta: float = 1.0,
                 time_scale: float = 86400.0):
        self.k = k
        self.alpha = alpha
        self.beta = beta
        self.time_scale = time_scale

    def fit_timed(self, td: _TimedData):
        self.data = td.data
        n_u = td.data.user_nums
        if n_u > _DENSE_CAP:
            c = (td.data.train @ td.data.train.T).toarray()
            np.fill_diagonal(c, 0.0)
            sim = c
        else:
            sim = _decayed_cooccurrence(td.u, td.i, td.t, n_u,
                                        td.data.item_nums, self.alpha,
                                        self.time_scale)
        deg = np.maximum(np.asarray(td.data.train.sum(axis=1)).ravel(), 1e-9)
        sim = sim / np.sqrt(deg[:, None] * deg[None, :])
        if sim.shape[0] > self.k:
            kth = np.partition(sim, -self.k, axis=1)[:, -self.k][:, None]
            sim[sim < kth] = 0.0
        self.sim = sim
        age = (td.t0 - td.t) / self.time_scale
        w = 1.0 / (1.0 + self.beta * age)
        self.r_w = sp.csr_matrix((w, (td.u, td.i)),
                                 shape=(n_u, td.data.item_nums))
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        # ndarray @ csr computes the same [B, I] block without ever
        # densifying the full user-item matrix.
        scores = np.asarray(self.sim[users] @ self.r_w)
        return topn_from_scores(scores, self.data.seen_mask(users), n)


class SessionGraph:
    """Working replacement for the reference's empty SGM stub: a
    time-binned session-node bipartite graph ranked by truncated
    personalized power iteration."""

    def __init__(self, alpha: float = 0.8, iters: int = 10, n_bins: int = 8):
        self.alpha = alpha
        self.iters = iters
        self.n_bins = n_bins

    def fit_timed(self, td: _TimedData):
        self.data = td.data
        u_n, i_n = td.data.user_nums, td.data.item_nums
        bins = np.clip(((td.t - td.t.min())
                        / max(np.ptp(td.t), 1.0) * self.n_bins).astype(int),
                       0, self.n_bins - 1)
        session = td.u * self.n_bins + bins + u_n + i_n
        n_nodes = u_n + i_n + u_n * self.n_bins
        rows = np.concatenate([td.u, td.i + u_n, session, td.i + u_n])
        cols = np.concatenate([td.i + u_n, td.u, td.i + u_n, session])
        g = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                          shape=(n_nodes, n_nodes))
        deg = np.asarray(g.sum(axis=1)).ravel()
        self.m_t = (sp.diags(1.0 / np.maximum(deg, 1.0)) @ g).T.tocsr()
        self.n_nodes = n_nodes
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        u_n = self.data.user_nums
        e = np.zeros((self.n_nodes, len(users)))
        e[np.asarray(users, dtype=np.int64), np.arange(len(users))] = 1.0
        rank = e.copy()
        for _ in range(self.iters):
            rank = self.alpha * (self.m_t @ rank) + (1 - self.alpha) * e
        scores = rank[u_n: u_n + self.data.item_nums].T
        return topn_from_scores(np.asarray(scores),
                                self.data.seen_mask(users), n)
