"""SVD++ and TrustSVD rating predictors, and SlopeOne / SLIM.

All four are advertised by the reference with empty files
(model/rating/{SVD++,TrustSVD,SlopeOne,SLIM}.py are 0 bytes — SURVEY.md
section 2.2); these implement the published algorithms:

- SVD++ (Koren, KDD'08): r_hat = mu + b_u + b_i +
  q_i . (p_u + |N(u)|^-1/2 sum_{j in N(u)} y_j); minibatch SGD with the
  implicit-feedback sum recomputed from the CURRENT y table per step
  (``index_add_`` over the rating pairs).
- TrustSVD (Guo et al., AAAI'15): SVD++ plus trust terms — the truster's
  representation also aggregates trustee embeddings
  |T(u)|^-1/2 sum_{v in T(u)} w_v, and a trust-prediction loss
  t_hat_uv = w_v . p_u is trained jointly.
- SlopeOne (Lemire & Maclachlan'05): closed-form item-pair average
  deviations, weighted by co-rating counts.
- SLIM (Ning & Karypis, ICDM'11): sparse item-item linear model
  min ||A - A W||^2 + l2/2 ||W||^2 + l1 ||W||_1, W >= 0, diag(W) = 0 —
  solved by projected proximal gradient descent (dense W; guarded by
  catalog size).

As ``cleverrec_tpu/classic/rating_mf.py``: SVD++, TrustSVD and SLIM run
with PyTorch on ``device`` (an ``epoch`` of SVD++ and TrustSVD takes the
parameters, the optimizer state and the epoch's permutation explicitly,
``fit`` drawing everything from one ``torch.Generator`` seeded from
``seed``); SlopeOne is its numpy code, copied.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from cleverrec_tpu_torch.classic.base import InteractionData, topn_from_scores
from cleverrec_tpu_torch.classic.train import to_numpy, train_steps
from cleverrec_tpu_torch.common import make_optimizer, resolve_device


def _inv_sqrt_counts(ids, n, dev):
    cnt = np.zeros(n)
    np.add.at(cnt, ids, 1.0)
    return torch.as_tensor((1.0 / np.sqrt(np.maximum(cnt, 1.0))).astype(
        np.float32), device=dev)


class _ImplicitMFBase:
    """Shared SVD++/TrustSVD machinery."""

    use_trust = False

    def __init__(self, factors: int = 32, lr: float = 0.005,
                 reg: float = 0.02, reg_t: float = 0.05, epochs: int = 20,
                 batch: int = 4096, seed: int = 0, device="cuda"):
        self.f = factors
        self.lr = lr
        self.reg = reg
        self.reg_t = reg_t
        self.epochs = epochs
        self.batch = batch
        self.seed = seed
        self.device = device

    def prepare(self, triples, user_nums: int, item_nums: int,
                trust_pairs=None) -> None:
        """The ratings (and trust edges) as tensors on ``device``, their
        normalisers, ``mu``, and ``padded``: the permuted slots an epoch
        (pad slots repeat the last rating at weight 0)."""
        t = np.asarray(list(triples), dtype=np.float64)
        self.dev = dev = resolve_device(self.device)
        u_np = t[:, 0].astype(np.int64)
        self.u = torch.as_tensor(u_np, device=dev)
        self.i = torch.as_tensor(t[:, 1].astype(np.int64), device=dev)
        self.r = torch.as_tensor(t[:, 2].astype(np.float32), device=dev)
        self.mu = float(t[:, 2].mean()) if len(t) else 0.0
        self.user_nums, self.item_nums = user_nums, item_nums
        self.inv_sqrt_n = _inv_sqrt_counts(u_np, user_nums, dev)
        if self.use_trust:
            tp = np.asarray(list(trust_pairs or []), dtype=np.int64)
            # Empty trust graph: keep a shape-stable placeholder edge but
            # ZERO its loss weight (a trained fake (0,0) edge pushed user
            # 0's embeddings toward w_0 . p_0 = 1 every step).
            self.t_weight = 1.0 if len(tp) else 0.0
            if len(tp) == 0:
                tp = np.zeros((1, 2), np.int64)
            self.tu = torch.as_tensor(tp[:, 0], device=dev)
            self.tv = torch.as_tensor(tp[:, 1], device=dev)
            self.inv_sqrt_t = _inv_sqrt_counts(tp[:, 0], user_nums, dev)
        self.n = len(t)
        self.padded = max(-(-self.n // self.batch), 1) * self.batch
        self.opt = make_optimizer("Adam", self.lr)

    def init_params(self, gen: torch.Generator) -> dict:
        def normal(rows):
            return 0.05 * torch.randn((rows, self.f), generator=gen,
                                      device=self.dev)
        params = {
            "P": normal(self.user_nums),
            "Q": normal(self.item_nums),
            "Y": torch.zeros((self.item_nums, self.f), device=self.dev),
            "bu": torch.zeros(self.user_nums, device=self.dev),
            "bi": torch.zeros(self.item_nums, device=self.dev),
        }
        if self.use_trust:
            params["W"] = normal(self.user_nums)
        return {k: v.requires_grad_() for k, v in params.items()}

    def user_repr(self, p):
        """Every user's representation from the CURRENT tables: P plus the
        normalised sum of Y over the user's rated items (and, TrustSVD,
        of W over its trustees)."""
        z = torch.zeros_like(p["P"]).index_add_(0, self.u, p["Y"][self.i])
        rep = p["P"] + z * self.inv_sqrt_n[:, None]
        if self.use_trust:
            tz = torch.zeros_like(p["P"]).index_add_(0, self.tu,
                                                     p["W"][self.tv])
            rep = rep + tz * self.inv_sqrt_t[:, None]
        return rep

    def _loss(self, p, rows, w):
        rep = self.user_repr(p)
        uu, ii, rr = self.u[rows], self.i[rows], self.r[rows]
        pred = (self.mu + p["bu"][uu] + p["bi"][ii]
                + torch.sum(rep[uu] * p["Q"][ii], dim=1))
        denom = torch.clamp(torch.sum(w), min=1.0)
        main = torch.sum(torch.square(rr - pred) * w) / denom
        wc = w[:, None]
        l2 = (torch.sum(torch.square(p["P"][uu] * wc))
              + torch.sum(torch.square(p["Q"][ii] * wc))
              + torch.sum(torch.square(p["Y"][ii] * wc))
              + torch.sum(torch.square(p["bu"][uu] * w))
              + torch.sum(torch.square(p["bi"][ii] * w))) / denom
        total = main + self.reg * l2
        if self.use_trust:
            t_pred = torch.sum(p["W"][self.tv] * p["P"][self.tu], dim=1)
            total = total + self.reg_t * self.t_weight * (
                torch.mean(torch.square(1.0 - t_pred))
                + torch.mean(torch.square(p["W"][self.tv])))
        return total

    def epoch(self, params, opt_state, perm) -> torch.Tensor:
        """One epoch over the slot permutation ``perm`` [padded]; the mean
        loss."""
        w = (perm < self.n).float().view(-1, self.batch)
        rows = torch.clamp(perm, max=self.n - 1).view(-1, self.batch)
        return train_steps(self._loss, params, self.opt, opt_state,
                           zip(rows, w))

    def fit(self, triples, user_nums: int, item_nums: int,
            trust_pairs=None):
        self.prepare(triples, user_nums, item_nums, trust_pairs)
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        params = self.init_params(gen)
        opt_state = self.opt.init(params)
        for _ in range(self.epochs):
            self.epoch(params, opt_state, torch.randperm(
                self.padded, generator=gen, device=self.dev))
        self.params = to_numpy(params)
        # Final user representations (fixed for prediction).
        with torch.no_grad():
            self._rep = self.user_repr(params).cpu().numpy()
        return self

    def predict(self, users, items) -> np.ndarray:
        p = self.params
        return (self.mu + p["bu"][users] + p["bi"][items]
                + np.sum(self._rep[users] * p["Q"][items], axis=1))


class SVDpp(_ImplicitMFBase):
    use_trust = False


class TrustSVD(_ImplicitMFBase):
    use_trust = True


class SlopeOne:
    """Weighted SlopeOne: dev[i,j] = mean(r_ui - r_uj) over co-raters."""

    def fit(self, triples, user_nums: int, item_nums: int):
        t = np.asarray(list(triples), dtype=np.float64)
        u = t[:, 0].astype(np.int64)
        i = t[:, 1].astype(np.int64)
        r = t[:, 2]
        m = sp.csr_matrix((r, (u, i)), shape=(user_nums, item_nums))
        mask = sp.csr_matrix((np.ones(len(u)), (u, i)),
                             shape=(user_nums, item_nums))
        rd = m.toarray()
        md = mask.toarray()
        # counts[i, j] = co-raters; diffs[i, j] = sum of (r_ui - r_uj).
        counts = md.T @ md
        diffs = rd.T @ md - md.T @ rd
        with np.errstate(divide="ignore", invalid="ignore"):
            self.dev = np.where(counts > 0, diffs / np.maximum(counts, 1), 0.0)
        self.counts = counts
        self.r = rd
        self.mask = md
        self.u_avg = rd.sum(axis=1) / np.maximum(md.sum(axis=1), 1.0)
        return self

    def predict(self, users, items) -> np.ndarray:
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        out = np.empty(len(users))
        for k, (uu, ii) in enumerate(zip(users, items)):
            rated = self.mask[uu] > 0
            c = self.counts[ii][rated]
            keep = c > 0
            if keep.any():
                d = self.dev[ii][rated][keep]
                rj = self.r[uu][rated][keep]
                out[k] = np.sum((d + rj) * c[keep]) / np.sum(c[keep])
            else:
                out[k] = self.u_avg[uu]
        return out


class SLIM:
    """Sparse linear item model via projected proximal gradient on
    ``device``."""

    def __init__(self, l1: float = 0.0001, l2: float = 0.001,
                 iters: int = 400, lr: float = 0.01, max_items: int = 20000,
                 device="cuda"):
        self.l1 = l1
        self.l2 = l2
        self.iters = iters
        self.lr = lr
        self.max_items = max_items
        self.device = device

    @torch.no_grad()
    def fit(self, data: InteractionData):
        self.data = data
        if data.item_nums > self.max_items:
            raise ValueError("SLIM dense solver capped at "
                             f"{self.max_items} items")
        dev = resolve_device(self.device)
        # float32 products, as the JAX package's (TF32 stays off, torch's
        # default for matmul).
        a = torch.as_tensor(data.train.toarray(), device=dev)
        l1, l2, lr = self.l1, self.l2, self.lr
        eye = torch.eye(data.item_nums, dtype=torch.bool, device=dev)
        gram = a.T @ a                                   # [I, I]
        w = torch.zeros_like(gram)
        for _ in range(self.iters):
            grad = gram @ w - gram + l2 * w
            w = w - lr * grad
            w = torch.sign(w) * torch.clamp(torch.abs(w) - lr * l1, min=0.0)
            w = torch.clamp(w, min=0.0)                  # nonnegativity
            w = w.masked_fill(eye, 0.0)                  # zero diagonal
        self.w = w.cpu().numpy()
        return self

    def recommend(self, users, n: int) -> np.ndarray:
        scores = np.asarray(self.data.train[users].toarray() @ self.w)
        return topn_from_scores(scores, self.data.seen_mask(users), n)
