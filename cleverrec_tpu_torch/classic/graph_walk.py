"""PersonalRank: personalized PageRank on the user-item bipartite graph
(Basic/PersonRank.py:35-120).

Closed form: rank = (1-alpha) (I - alpha M^T)^{-1} e_root over the
(U+I)-node graph with row-normalized transition matrix M.  The reference
inverts the sparse matrix (:92-100); we LU-factorize once and solve per
batch of test users — same result, no dense inverse.

(A numpy/scipy copy of cleverrec_tpu/classic/graph_walk.py.)
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from cleverrec_tpu_torch.classic.base import InteractionData, topn_from_scores


class PersonalRank:
    def __init__(self, alpha: float = 0.8):
        self.alpha = alpha

    def fit(self, data: InteractionData):
        self.data = data
        u, i = data.user_nums, data.item_nums
        a = data.train.tocoo()
        rows = np.concatenate([a.row, a.col + u])
        cols = np.concatenate([a.col + u, a.row])
        g = sp.csr_matrix((np.ones(len(rows), np.float64), (rows, cols)),
                          shape=(u + i, u + i))
        deg = np.asarray(g.sum(axis=1)).ravel()
        inv = sp.diags(1.0 / np.maximum(deg, 1.0))
        m = inv @ g                                     # row-normalized
        self._solver = spla.factorized(
            (sp.eye(u + i) - self.alpha * m.T).tocsc())
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        # One factorized solve for the whole batch (matrix RHS) — a
        # per-user loop ran thousands of separate triangular solves.
        u_n = self.data.user_nums
        nodes = u_n + self.data.item_nums
        E = np.zeros((nodes, len(users)))
        E[np.asarray(users, dtype=np.int64),
          np.arange(len(users))] = 1.0
        rank = (1.0 - self.alpha) * self._solver(E)
        scores = rank[u_n:].T
        return topn_from_scores(scores, self.data.seen_mask(users), n)
