"""Tag-based recommenders: SimpleTagBased / TFIDF / TFIDF++
(Basic/TagBasedModel.py:100-117).

score(u, item) = sum over tags t of  w(u,t) * w(t,item) * penalty, with
- SimpleTagBased: penalty = 1
- TFIDF:          penalty = 1 / log(1 + |users of t|)
- TFIDF++:        penalty = 1 / (log(1 + |users of t|) * log(1 + |users of item|))

Vectorized as diag-scaled sparse matmuls over the user-tag and tag-item
count matrices.

(A numpy/scipy copy of cleverrec_tpu/classic/tags.py.)
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from cleverrec_tpu_torch.classic.base import InteractionData, topn_from_scores


class TagBasedModel:
    def __init__(self, variant: str = "SimpleTagBased"):
        assert variant in ("SimpleTagBased", "TFIDF", "TFIDF++")
        self.variant = variant

    def fit_tags(self, triples, user_nums: int, item_nums: int,
                 tag_nums: int, data: InteractionData):
        """triples: iterable of (user, item, tag) int tuples."""
        t = np.asarray(list(triples), dtype=np.int64)
        self.data = data
        ut = sp.csr_matrix((np.ones(len(t)), (t[:, 0], t[:, 2])),
                           shape=(user_nums, tag_nums))
        ti = sp.csr_matrix((np.ones(len(t)), (t[:, 2], t[:, 1])),
                           shape=(tag_nums, item_nums))
        tag_users = np.asarray((ut > 0).sum(axis=0)).ravel()
        item_users = self.data.item_degrees
        if self.variant == "SimpleTagBased":
            self._scores_mat = (ut @ ti).tocsr()
        else:
            # Degrees clamp to >= 1: log1p of a ~0 degree would turn the
            # popularity PENALTY into a ~1e9 boost for zero-train-degree
            # entities.
            tag_pen = sp.diags(1.0 / np.log1p(np.maximum(tag_users, 1.0)))
            m = (ut @ tag_pen @ ti).tocsr()
            if self.variant == "TFIDF++":
                item_pen = sp.diags(
                    1.0 / np.log1p(np.maximum(item_users, 1.0)))
                m = (m @ item_pen).tocsr()
            self._scores_mat = m
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        scores = self._scores_mat[users].toarray()
        return topn_from_scores(scores, self.data.seen_mask(users), n)
