"""Classic rating prediction: user/item kNN and SVD-family MF.

- RatingUserCF / RatingItemCF (model/rating/Basic/UserCF.py:51-99,
  ItemCF.py): similarity over co-ratings (cosine / adjusted-cosine /
  Pearson), prediction = similarity-weighted mean of the top-K neighbors'
  ratings, falling back to the user's mean when no neighbor rated the
  item.  Vectorized: dense similarity via mean-centered rating matmuls.
- FunkSVD: r_hat = <p_u, q_i>; BiasSVD: r_hat = mu + b_u + b_i +
  <p_u, q_i>; both minibatch SGD on ``device``.  NOTE: the reference's
  ``BiasSVD.py``/``FunkSVD.py`` files actually contain a copy of its
  rating UserCF script (no SVD code at all); these are the models their
  names promise.

As ``cleverrec_tpu/classic/rating_knn.py``: the kNN models are its numpy
code, copied; the SVD models train with PyTorch, ``epoch`` taking the
parameters, the optimizer state and the epoch's permutation explicitly,
``fit`` drawing everything from one ``torch.Generator`` seeded from
``seed``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from cleverrec_tpu_torch.classic.train import to_numpy, train_steps
from cleverrec_tpu_torch.common import make_optimizer, resolve_device


def _ratings_matrix(triples, user_nums, item_nums):
    t = np.asarray(list(triples), dtype=np.float64)
    u = t[:, 0].astype(np.int64)
    i = t[:, 1].astype(np.int64)
    r = t[:, 2]
    m = sp.csr_matrix((r, (u, i)), shape=(user_nums, item_nums))
    mask = sp.csr_matrix((np.ones(len(u)), (u, i)),
                         shape=(user_nums, item_nums))
    return m, mask


class _KnnBase:
    def __init__(self, k: int = 10, sim_type: str = "cosine"):
        self.k = k
        self.sim_type = sim_type

    def _similarity(self, r: np.ndarray, mask: np.ndarray,
                    center: np.ndarray | None) -> np.ndarray:
        """Rows = entities; cosine over observed co-ratings, optionally
        mean-centered (adjusted-cosine / pcc pick the centering axis)."""
        x = r.copy()
        if center is not None:
            x = np.where(mask > 0, x - center, 0.0)
        num = x @ x.T
        d = np.sqrt(np.maximum(np.sum(np.square(x), axis=1), 1e-12))
        sim = num / (d[:, None] * d[None, :])
        np.fill_diagonal(sim, 0.0)
        return sim

    @staticmethod
    def _topk_mask(sim: np.ndarray, k: int) -> np.ndarray:
        if sim.shape[1] <= k:
            return sim
        kth = np.partition(sim, -k, axis=1)[:, -k][:, None]
        out = sim.copy()
        out[out < kth] = 0.0
        return out


class RatingUserCF(_KnnBase):
    def fit(self, triples, user_nums: int, item_nums: int):
        m, mask = _ratings_matrix(triples, user_nums, item_nums)
        r = m.toarray()
        msk = mask.toarray()
        cnt_u = np.maximum(msk.sum(axis=1), 1.0)
        cnt_i = np.maximum(msk.sum(axis=0), 1.0)
        self.u_avg = r.sum(axis=1) / cnt_u
        i_avg = r.sum(axis=0) / cnt_i
        center = (i_avg[None, :] if self.sim_type == "adjust_cosine"
                  else self.u_avg[:, None] if self.sim_type == "pcc"
                  else None)
        sim = self._similarity(r, msk, center)
        self.sim_k = self._topk_mask(sim, self.k)
        self.r = r
        self.mask = msk
        return self

    def predict(self, users, items) -> np.ndarray:
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        s = self.sim_k[users]                              # [B, U]
        rated = self.mask[:, items].T                      # [B, U]
        w = s * rated
        num = np.sum(w * self.r[:, items].T, axis=1)
        den = np.sum(w, axis=1)
        fallback = self.u_avg[users]
        return np.where(den > 0, num / np.maximum(den, 1e-12), fallback)


class RatingItemCF(_KnnBase):
    def fit(self, triples, user_nums: int, item_nums: int):
        m, mask = _ratings_matrix(triples, user_nums, item_nums)
        r = m.toarray().T                                  # items x users
        msk = mask.toarray().T
        cnt_i = np.maximum(msk.sum(axis=1), 1.0)
        cnt_u = np.maximum(msk.sum(axis=0), 1.0)
        self.i_avg = r.sum(axis=1) / cnt_i
        u_avg = r.sum(axis=0) / cnt_u
        center = (u_avg[None, :] if self.sim_type == "adjust_cosine"
                  else self.i_avg[:, None] if self.sim_type == "pcc"
                  else None)
        sim = self._similarity(r, msk, center)
        self.sim_k = self._topk_mask(sim, self.k)
        self.r = r
        self.mask = msk
        return self

    def predict(self, users, items) -> np.ndarray:
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        s = self.sim_k[items]                              # [B, I]
        rated = self.mask[:, users].T                      # [B, I]
        w = s * rated
        num = np.sum(w * self.r[:, users].T, axis=1)
        den = np.sum(w, axis=1)
        fallback = self.i_avg[items]
        return np.where(den > 0, num / np.maximum(den, 1e-12), fallback)


class _SvdBase:
    use_bias = False

    def __init__(self, factors: int = 32, lr: float = 0.01,
                 reg: float = 0.02, epochs: int = 20, batch: int = 4096,
                 seed: int = 0, device="cuda"):
        self.f = factors
        self.lr = lr
        self.reg = reg
        self.epochs = epochs
        self.batch = batch
        self.seed = seed
        self.device = device

    def prepare(self, triples, user_nums: int, item_nums: int) -> None:
        """The ratings as tensors on ``device``, ``mu``, and ``padded``:
        the permuted slots an epoch (pad slots repeat the last rating at
        weight 0)."""
        t = np.asarray(list(triples), dtype=np.float64)
        self.dev = resolve_device(self.device)
        self.u = torch.as_tensor(t[:, 0].astype(np.int64), device=self.dev)
        self.i = torch.as_tensor(t[:, 1].astype(np.int64), device=self.dev)
        self.r = torch.as_tensor(t[:, 2].astype(np.float32), device=self.dev)
        self.mu = float(t[:, 2].mean()) if len(t) else 0.0
        self.n = len(t)
        self.user_nums, self.item_nums = user_nums, item_nums
        self.padded = max(-(-self.n // self.batch), 1) * self.batch
        self.opt = make_optimizer("SGD", self.lr)

    def init_params(self, gen: torch.Generator) -> dict:
        # Bias-free FunkSVD must carry the rating scale in P.Q itself;
        # start at <p, q> ~= mu so SGD refines rather than bootstraps.
        # (BiasSVD carries the scale in mu + biases instead.)
        base = (0.0 if self.use_bias
                else float(np.sqrt(max(self.mu, 0.0) / self.f)))
        params = {}
        for name, rows in (("P", self.user_nums), ("Q", self.item_nums)):
            params[name] = base + 0.1 * torch.randn(
                (rows, self.f), generator=gen, device=self.dev)
        if self.use_bias:
            params["bu"] = torch.zeros(self.user_nums, device=self.dev)
            params["bi"] = torch.zeros(self.item_nums, device=self.dev)
        return {k: v.requires_grad_() for k, v in params.items()}

    def _pred(self, p, uu, ii):
        out = torch.sum(p["P"][uu] * p["Q"][ii], dim=1)
        if self.use_bias:
            out = out + self.mu + p["bu"][uu] + p["bi"][ii]
        return out

    def _loss(self, p, rows, w):
        uu, ii = self.u[rows], self.i[rows]
        e = (self.r[rows] - self._pred(p, uu, ii)) * w
        l2 = (torch.sum(torch.square(p["P"][uu] * w[:, None]))
              + torch.sum(torch.square(p["Q"][ii] * w[:, None])))
        if self.use_bias:
            l2 = l2 + (torch.sum(torch.square(p["bu"][uu] * w))
                       + torch.sum(torch.square(p["bi"][ii] * w)))
        denom = torch.clamp(torch.sum(w), min=1.0)
        return (torch.sum(torch.square(e)) + self.reg * l2) / denom

    def epoch(self, params, opt_state, perm) -> torch.Tensor:
        """One epoch over the slot permutation ``perm`` [padded]; the mean
        loss."""
        w = (perm < self.n).float().view(-1, self.batch)
        rows = torch.clamp(perm, max=self.n - 1).view(-1, self.batch)
        return train_steps(self._loss, params, self.opt, opt_state,
                           zip(rows, w))

    def fit(self, triples, user_nums: int, item_nums: int):
        self.prepare(triples, user_nums, item_nums)
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        params = self.init_params(gen)
        opt_state = self.opt.init(params)
        for _ in range(self.epochs):
            self.epoch(params, opt_state, torch.randperm(
                self.padded, generator=gen, device=self.dev))
        self.params = to_numpy(params)
        return self

    def predict(self, users, items) -> np.ndarray:
        p = self.params
        out = np.sum(p["P"][users] * p["Q"][items], axis=1)
        if self.use_bias:
            out = out + self.mu + p["bu"][users] + p["bi"][items]
        return out


class FunkSVD(_SvdBase):
    use_bias = False


class BiasSVD(_SvdBase):
    use_bias = True
