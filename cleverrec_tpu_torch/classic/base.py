"""Shared data structures + the Basic scripts' metric family.

Metrics (e.g. model/ranking/Basic/UserCF.py:95-123):
- precision  = hits / (N * |test users|)
- recall     = hits / sum of |real items| over test users
- coverage   = |distinct recommended items| / item_nums
- popularity = mean over recommended slots of log(1 + train degree)
Seen (train) items are always excluded from recommendations.

(A numpy/scipy copy of cleverrec_tpu/classic/base.py.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class InteractionData:
    """Train matrix + test dict for the classic models."""

    user_nums: int
    item_nums: int
    train: sp.csr_matrix                 # [U, I] binary
    user_items_test: dict[int, list[int]]

    @classmethod
    def from_pairs(cls, train_pairs, test_pairs, user_nums, item_nums):
        tp = np.asarray(train_pairs, dtype=np.int64)
        m = sp.csr_matrix(
            (np.ones(len(tp), np.float32), (tp[:, 0], tp[:, 1])),
            shape=(user_nums, item_nums))
        m.data[:] = 1.0  # collapse duplicates
        test: dict[int, list[int]] = {}
        for u, i in np.asarray(test_pairs, dtype=np.int64):
            test.setdefault(int(u), []).append(int(i))
        return cls(user_nums, item_nums, m, test)

    @classmethod
    def random_split(cls, pairs, user_nums, item_nums, test_size=0.125,
                     rng=None):
        rng = rng or np.random.default_rng(0)
        pairs = np.asarray(pairs, dtype=np.int64)
        perm = rng.permutation(len(pairs))
        n_test = int(round(test_size * len(pairs)))
        return cls.from_pairs(pairs[perm[n_test:]], pairs[perm[:n_test]],
                              user_nums, item_nums)

    @property
    def item_degrees(self) -> np.ndarray:
        return np.asarray(self.train.sum(axis=0)).ravel()

    def seen_mask(self, users) -> np.ndarray:
        return self.train[users].toarray() > 0


def topn_from_scores(scores: np.ndarray, seen: np.ndarray, n: int) -> np.ndarray:
    """Rank ``scores`` [B, I] excluding seen items; returns item ids [B, n],
    -1 for slots where fewer than n unseen items exist (callers skip
    negative ids)."""
    s = np.where(seen, -np.inf, scores)
    top = np.argpartition(-s, kth=min(n, s.shape[1] - 1), axis=1)[:, :n]
    row_scores = np.take_along_axis(s, top, axis=1)
    order = np.argsort(-row_scores, axis=1, kind="stable")
    top = np.take_along_axis(top, order, axis=1)
    row_scores = np.take_along_axis(row_scores, order, axis=1)
    return np.where(np.isfinite(row_scores), top, -1)


def evaluate_topn(model, data: InteractionData, n: int = 10,
                  batch: int = 2048) -> dict[str, float]:
    """Drive ``model.recommend(users, n)`` over all test users and compute
    the Basic metric family."""
    users = np.fromiter(data.user_items_test.keys(), dtype=np.int64)
    degrees = data.item_degrees
    hits = real = 0
    popularity = 0.0
    all_rec: set[int] = set()
    for s in range(0, len(users), batch):
        cur = users[s: s + batch]
        rec = model.recommend(cur, n)                      # [B, n]
        for row, u in zip(rec, cur):
            truth = set(data.user_items_test[int(u)])
            row = row[row >= 0]
            hits += len(truth & set(int(i) for i in row))
            real += len(truth)
            popularity += float(np.log1p(degrees[row]).sum())
            all_rec.update(int(i) for i in row)
    rec_slots = n * len(users)
    return {
        "precision": hits / rec_slots,
        "recall": hits / max(real, 1),
        "coverage": len(all_rec) / data.item_nums,
        "popularity": popularity / rec_slots,
    }
