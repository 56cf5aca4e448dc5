"""Neighborhood CF: UserCF, ItemCF, ContentKNN.

Vectorized sparse-matrix forms of the reference's dict-of-dict loops:

- UserCF (Basic/UserCF.py:44-84): co-rating counts C = A W A^T (W = I for
  cosine/jaccard, diag(1/log(1+item degree)) for 'iif'), normalized to a
  similarity, top-K similar users per user, score(u, i) = sum of s(u, v)
  over neighbors v who rated i.
- ItemCF (Basic/ItemCF.py:43-100): C = A^T W A (W = I or 'iuf' =
  diag(1/log(1+user degree))), "Harry Potter" popularity penalty
  s(i, j) = c / (deg_i^(1-alpha) * deg_j^alpha), optional row max-norm;
  score(u, j) = sum over u's items i of s(i, j).  Two neighbor-selection
  variants, both from the reference: ``rank_time_topk=True`` reproduces
  its primary path (Basic/ItemCF.py:80-87 "方式1": per user, walk each
  seen item's neighbors in descending similarity, skipping the user's
  seen items, until K unseen neighbors are collected — inherently
  per-user, so host-loop scored); the DEFAULT ``rank_time_topk=False``
  is its documented fixed top-K alternative (Basic/ItemCF.py:88-93
  "方式2"), user-independent and fully vectorized.
- ContentKNN (Basic/ContentKNN.py): item-item cosine over a content
  (genre/keyword) feature matrix instead of co-occurrence.

(A numpy/scipy copy of cleverrec_tpu/classic/neighborhood.py.)
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from cleverrec_tpu_torch.classic.base import InteractionData, topn_from_scores


def _topk_sparsify(s: sp.csr_matrix, k: int) -> sp.csr_matrix:
    """Keep the top-k entries of each row of a similarity matrix."""
    s = s.tocsr()
    data, indices, indptr = [], [], [0]
    for r in range(s.shape[0]):
        lo, hi = s.indptr[r], s.indptr[r + 1]
        row_d = s.data[lo:hi]
        row_i = s.indices[lo:hi]
        if len(row_d) > k:
            sel = np.argpartition(-row_d, k - 1)[:k]
            row_d, row_i = row_d[sel], row_i[sel]
        data.append(row_d)
        indices.append(row_i)
        indptr.append(indptr[-1] + len(row_d))
    return sp.csr_matrix(
        (np.concatenate(data) if data else np.zeros(0),
         np.concatenate(indices) if indices else np.zeros(0, np.int64),
         np.asarray(indptr)),
        shape=s.shape)


class UserCF:
    VALID_SIMS = ("cosine", "iif", "jacard")

    def __init__(self, k: int = 80, sim_type: str = "cosine"):
        if sim_type not in self.VALID_SIMS:
            raise ValueError(f"unknown sim_type {sim_type!r}; "
                             f"valid: {self.VALID_SIMS}")
        self.k = k
        self.sim_type = sim_type

    def fit(self, data: InteractionData):
        self.data = data
        a = data.train
        deg_u = np.asarray(a.sum(axis=1)).ravel()
        deg_i = np.asarray(a.sum(axis=0)).ravel()
        if self.sim_type == "iif":
            w = sp.diags(1.0 / np.log1p(np.maximum(deg_i, 1e-9) + 0.0))
            c = (a @ w @ a.T).tocsr()
        else:
            c = (a @ a.T).tocsr()
        c.setdiag(0)
        c.eliminate_zeros()
        c = c.tocoo()
        du = np.maximum(deg_u, 1e-9)
        if self.sim_type == "jacard":
            denom = du[c.row] + du[c.col] - c.data
        else:  # cosine / iif
            denom = np.sqrt(du[c.row] * du[c.col])
        sim = sp.csr_matrix((c.data / denom, (c.row, c.col)), shape=c.shape)
        self.sim_k = _topk_sparsify(sim, self.k)
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        scores = (self.sim_k[users] @ self.data.train).toarray()
        return topn_from_scores(scores, self.data.seen_mask(users), n)


class ItemCF:
    VALID_SIMS = ("cosine", "iuf")

    def __init__(self, k: int = 10, sim_type: str = "cosine",
                 alpha: float = 0.5, normalize: bool = False,
                 rank_time_topk: bool = False):
        if sim_type not in self.VALID_SIMS:
            raise ValueError(f"unknown sim_type {sim_type!r}; "
                             f"valid: {self.VALID_SIMS}")
        self.k = k
        self.sim_type = sim_type
        self.alpha = alpha
        self.normalize = normalize
        self.rank_time_topk = rank_time_topk

    def fit(self, data: InteractionData):
        self.data = data
        a = data.train
        deg_u = np.asarray(a.sum(axis=1)).ravel()
        deg_i = np.asarray(a.sum(axis=0)).ravel()
        if self.sim_type == "iuf":
            w = sp.diags(1.0 / np.log1p(np.maximum(deg_u, 1e-9) + 0.0))
            c = (a.T @ w @ a).tocsr()
        else:
            c = (a.T @ a).tocsr()
        c.setdiag(0)
        c.eliminate_zeros()
        c = c.tocoo()
        di = np.maximum(deg_i, 1e-9)
        denom = (np.power(di[c.row], 1.0 - self.alpha)
                 * np.power(di[c.col], self.alpha))
        sim = sp.csr_matrix((c.data / denom, (c.row, c.col)), shape=c.shape)
        if self.normalize:
            row_max = sim.max(axis=1).toarray().ravel()
            inv = sp.diags(1.0 / np.maximum(row_max, 1e-12))
            sim = (inv @ sim).tocsr()
        if self.rank_time_topk:
            # Reference primary path needs each item's FULL neighbor list
            # sorted by similarity descending (k unseen neighbors are
            # re-selected per user at rank time, Basic/ItemCF.py:80-87).
            self._nbr_ids, self._nbr_vals = [], []
            for r in range(sim.shape[0]):
                lo, hi = sim.indptr[r], sim.indptr[r + 1]
                order = np.argsort(-sim.data[lo:hi], kind="stable")
                self._nbr_ids.append(sim.indices[lo:hi][order])
                self._nbr_vals.append(sim.data[lo:hi][order])
            self.sim_k = None
        else:
            self.sim_k = _topk_sparsify(sim, self.k)
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        users = np.asarray(users)
        seen_mask = self.data.seen_mask(users)
        if not self.rank_time_topk:
            scores = (self.data.train[users] @ self.sim_k).toarray()
            return topn_from_scores(scores, seen_mask, n)
        # Rank-time re-selection: per (user, seen item i), accumulate the
        # first k unseen neighbors of i (descending similarity).
        train = self.data.train.tocsr()
        scores = np.zeros((len(users), train.shape[1]))
        for r, u in enumerate(users):
            seen_u = seen_mask[r]
            for i in train[u].indices:
                ids, vals = self._nbr_ids[i], self._nbr_vals[i]
                unseen = ~seen_u[ids]
                # First k unseen positions in sorted order.
                keep = unseen & (np.cumsum(unseen) <= self.k)
                np.add.at(scores[r], ids[keep], vals[keep])
        return topn_from_scores(scores, seen_mask, n)


class ContentKNN(ItemCF):
    """Item-item cosine over content features (genres/keywords)."""

    def __init__(self, item_features: np.ndarray | sp.spmatrix, k: int = 20):
        super().__init__(k=k)
        self.item_features = sp.csr_matrix(item_features)

    def fit(self, data: InteractionData):
        self.data = data
        f = self.item_features
        norms = np.sqrt(np.asarray(f.multiply(f).sum(axis=1)).ravel())
        inv = sp.diags(1.0 / np.maximum(norms, 1e-12))
        fn = (inv @ f).tocsr()
        sim = (fn @ fn.T).tocsr()
        sim.setdiag(0)
        sim.eliminate_zeros()
        self.sim_k = _topk_sparsify(sim, self.k)
        return self
