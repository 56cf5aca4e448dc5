"""LFM: pointwise matrix factorization with popularity-biased negatives
(Basic/LFM.py:55-125), as ``cleverrec_tpu/classic/mf.py``.

The reference is per-sample Python SGD with multiprocessing sampling; here
one training iteration is an epoch of minibatch steps on ``device``:
popularity-weighted negative draws (rejecting seen items), squared-error
loss on P/Q with L2, Adam.  ``epoch`` takes the parameters, the optimizer
state and the epoch's draws explicitly; ``fit`` draws them from one
``torch.Generator`` seeded from ``seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from cleverrec_tpu_torch.classic.base import InteractionData, topn_from_scores
from cleverrec_tpu_torch.classic.train import to_numpy, train_steps
from cleverrec_tpu_torch.common import cdiv, make_optimizer, resolve_device
from cleverrec_tpu_torch.sampling import build_member_table, member, table_to

# Popularity-biased candidates drawn a slot; the first unseen one is taken.
CANDIDATES = 16


class LFM:
    def __init__(self, factors: int = 64, lr: float = 0.01,
                 reg: float = 1e-5, neg_ratio: int = 3, iters: int = 30,
                 batch: int = 8192, seed: int = 0, device="cuda"):
        self.f = factors
        self.lr = lr
        self.reg = reg
        self.neg_ratio = neg_ratio
        self.iters = iters
        self.batch = batch
        self.seed = seed
        self.device = device

    def prepare(self, data: InteractionData) -> None:
        """The epoch's fixed tensors on ``device``: the train pairs, the
        seen table, the popularity CDF; ``padded``, the slots an epoch."""
        self.data = data
        self.dev = resolve_device(self.device)
        coo = data.train.tocoo()
        self.pos_u = torch.as_tensor(coo.row.astype(np.int64), device=self.dev)
        self.pos_i = torch.as_tensor(coo.col.astype(np.int64), device=self.dev)
        self.seen = table_to(build_member_table(
            {u: data.train[u].indices.tolist() for u in range(data.user_nums)},
            data.user_nums, data.item_nums), self.dev)
        # Popularity-proportional negative sampling via the degree CDF
        # (the reference passes popularity weights to np.random.choice,
        # Basic/LFM.py:66).
        deg = data.item_degrees.astype(np.float64)
        self.cdf = torch.as_tensor(
            (np.cumsum(deg) / max(deg.sum(), 1.0)).astype(np.float32),
            device=self.dev)
        self.rows_total = len(coo.row) * (1 + self.neg_ratio)
        self.padded = cdiv(self.rows_total, self.batch) * self.batch
        # Adam converges far faster than the reference's per-sample SGD
        # for the same objective; the model itself is unchanged.
        self.opt = make_optimizer("Adam", self.lr)

    def init_params(self, gen: torch.Generator) -> dict:
        # Scaled uniform init: <p, q> starts ~0.25 (labels are 0/1).
        scale = 1.0 / np.sqrt(self.f)
        d = self.data
        return {"P": (scale * torch.rand((d.user_nums, self.f), generator=gen,
                                         device=self.dev)).requires_grad_(),
                "Q": (scale * torch.rand((d.item_nums, self.f), generator=gen,
                                         device=self.dev)).requires_grad_()}

    def draws(self, gen: torch.Generator):
        """An epoch's draws: the slot permutation [padded] and the
        candidates' uniforms [padded, CANDIDATES]."""
        perm = torch.randperm(self.padded, generator=gen, device=self.dev)
        uni = torch.rand((self.padded, CANDIDATES), generator=gen,
                         device=self.dev)
        return perm, uni

    def _loss(self, p, u, i, y, w):
        pu, qi = p["P"][u], p["Q"][i]
        pred = torch.sum(pu * qi, dim=1)
        denom = torch.clamp(torch.sum(w), min=1.0)
        main = torch.sum(torch.square(y - pred) * w) / denom
        wc = w[:, None]
        return main + self.reg * (torch.sum(torch.square(pu * wc))
                                  + torch.sum(torch.square(qi * wc))) / denom

    def epoch(self, params, opt_state, perm, uni) -> torch.Tensor:
        """One epoch on the draws ``perm`` and ``uni``; the mean loss."""
        grp = 1 + self.neg_ratio
        valid = (perm < self.rows_total).float()
        r = torch.clamp(perm, max=self.rows_total - 1)
        p_idx = r // grp
        is_pos = (r % grp) == 0
        u_all = self.pos_u[p_idx]
        # Popularity-biased candidates: invert the CDF on the uniforms
        # (the left search, as jnp.searchsorted), reject seen items.
        cand = torch.searchsorted(self.cdf, uni.reshape(-1)).reshape(uni.shape)
        cand = torch.clamp(cand, max=self.data.item_nums - 1)
        bad = member(self.seen, u_all, cand)
        first = torch.argmax((~bad).int(), dim=-1)
        j_all = torch.gather(cand, 1, first[:, None])[:, 0]
        i_all = torch.where(is_pos, self.pos_i[p_idx], j_all)
        y_all = is_pos.float()
        # A heavy user can reject ALL the draws; argmax of an all-False
        # row is 0, which would train a SEEN item toward label 0 — such
        # rows get weight 0 instead.
        all_bad = torch.all(bad, dim=-1) & ~is_pos
        w_all = torch.where(all_bad, 0.0, 1.0) * valid
        xs = zip(*(a.view(-1, self.batch) for a in (u_all, i_all, y_all,
                                                     w_all)))
        return train_steps(self._loss, params, self.opt, opt_state, xs)

    def fit(self, data: InteractionData):
        self.prepare(data)
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        params = self.init_params(gen)
        opt_state = self.opt.init(params)
        for _ in range(self.iters):
            self.epoch(params, opt_state, *self.draws(gen))
        fitted = to_numpy(params)
        self.P, self.Q = fitted["P"], fitted["Q"]
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        scores = self.P[users] @ self.Q.T
        return topn_from_scores(scores, self.data.seen_mask(users), n)
