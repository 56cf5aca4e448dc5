"""Non-personalized baselines: Random, MostPopular
(Basic/NonPersonalizedModel.py:35-96) — the sanity floor for every other
model's metrics.

(A numpy/scipy copy of cleverrec_tpu/classic/nonpersonalized.py.)
"""

from __future__ import annotations

import numpy as np

from cleverrec_tpu_torch.classic.base import InteractionData, topn_from_scores


class MostPopular:
    """Recommend each user the most popular items they haven't seen."""

    def fit(self, data: InteractionData):
        self.data = data
        self.pop = data.item_degrees.astype(np.float64)
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        scores = np.broadcast_to(self.pop, (len(users), len(self.pop)))
        return topn_from_scores(scores.copy(), self.data.seen_mask(users), n)


class RandomModel:
    """Uniformly random unseen TRAIN items (the reference samples from the
    set of items that appear in train, Basic/NonPersonalizedModel.py:40-44)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def fit(self, data: InteractionData):
        self.data = data
        self.train_items = np.flatnonzero(data.item_degrees > 0)
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        scores = self.rng.random((len(users), self.data.item_nums))
        scores[:, self.data.item_degrees == 0] = -np.inf
        return topn_from_scores(scores, self.data.seen_mask(users), n)
