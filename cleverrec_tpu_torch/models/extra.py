"""WMF, DMF, SML and EATNN (as ``cleverrec_tpu/models/extra.py``): the
models the reference advertises with empty files, as the JAX package
implements them on the sampled batch protocols.

- WMF (Hu et al., ICDM'08): the squared loss with the confidence
  1 + alpha * y of each pointwise row (built in: ``loss_func`` is not
  read), L2 on the batch's rows; inner-product scores.
- DMF (Xue et al., IJCAI'17): two ReLU towers over P and Q, the cosine
  of their outputs floored at ``cosine_floor``, and the normalised
  cross-entropy.  The norms are sqrt(sum x^2 + 1e-12): a plain norm's
  gradient is NaN at a tower row that is exactly 0 (all its ReLUs dead).
  It has no matmul form, so its full-catalog scores are the base
  class's chunked candidate scores.
- SML: ``cml_like``; CML's hinge on the user side and an item-side hinge
  d(i, j), each with a learned margin (``m_u`` [U], ``m_i`` [I], from
  0.5) clipped into [0, ``margin_cap``] in the loss and, in place, after
  each step (``postprocess``), and a bonus for large margins.
- EATNN (Chen et al., SIGIR'19): a shared and two domain user tables
  fused by a per-user sigmoid gate; a pairwise loss in the item domain
  and, weighted by ``social_weight``, the squared distance of friend
  pairs in the social domain over a batch of edges drawn each step from
  the trainer's ``dropout_gen`` (without one, a fixed hash of the user
  id picks the edge); a data rank's chunk of a split batch keeps its
  rows of the whole batch's draw.

Every clip and floor that carries a gradient is ``torch.maximum`` and
``torch.minimum`` against tensors: at a tie they split the gradient
between their two sides as ``jnp.maximum`` and ``jnp.clip`` do, where
``torch.clamp`` passes all of it (and SML's margins sit at their cap).
"""

from __future__ import annotations

import torch
from torch import nn

from cleverrec_tpu_torch.common import init_param, l2_loss, pairwise_loss
from cleverrec_tpu_torch.data.social import flatten_friend_edges
from cleverrec_tpu_torch.models.base import Aux, RecModel
from cleverrec_tpu_torch.models.modules import gather_rows, sq_dist

# The keyless edge pick of EATNN: (u * HASH_MUL) mod 2^32 mod n_f.
HASH_MUL = 2654435761


def _clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi) with its gradient at the bounds."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _floor(x, lo: float):
    """jnp.maximum(x, lo) with its gradient at the tie."""
    return torch.maximum(x, x.new_full((), lo))


class _Tables(RecModel):
    """Models whose parameters are drawn from the initializer in their
    registration order, and whose loss is a row sum alone."""

    loss_parts = RecModel.rows_only_parts

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            p.copy_(init_param(generator, self.initializer, p.shape))


class WMF(_Tables):
    name = "WMF"
    sampler = "pointwise"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg")
        self.embed_size = d = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self.alpha = cfg.float("alpha", 10.0)
        self.P = nn.Parameter(torch.zeros(meta.user_nums, d))
        self.Q = nn.Parameter(torch.zeros(meta.item_nums, d))

    def loss(self, batch, aux: Aux):
        w, y = batch["w"], batch["y"]
        ue = gather_rows(self.P, batch["u"])
        ie = gather_rows(self.Q, batch["i"])
        pred = (ue * ie).sum(dim=1)
        conf = 1.0 + self.alpha * y
        main = torch.sum(conf * torch.square(y - pred) * w)
        wc = w[:, None]
        return main + self.reg * (l2_loss(ue * wc) + l2_loss(ie * wc))

    def score_pairs(self, u, i, aux: Aux):
        return (self.P[u] * self.Q[i]).sum(dim=1)

    def score_all(self, u, aux: Aux):
        return self.P[u] @ self.Q.T

    def dot_decomposition(self, u, aux: Aux):
        return self.P[u], self.Q, None


class DMF(_Tables):
    name = "DMF"
    sampler = "pointwise"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg")
        self.embed_size = cfg.int("embed_size")
        self.layers = cfg.int_list("layers", [self.embed_size,
                                              self.embed_size])
        self.reg = cfg.float("reg")
        self.mu = cfg.float("cosine_floor", 1e-6)
        self.P = nn.Parameter(torch.zeros(meta.user_nums, self.layers[0]))
        self.Q = nn.Parameter(torch.zeros(meta.item_nums, self.layers[0]))
        for lid in range(1, len(self.layers)):
            shape = (self.layers[lid - 1], self.layers[lid])
            for side in ("u", "i"):
                self.register_parameter(f"W{side}_{lid}",
                                        nn.Parameter(torch.zeros(shape)))
                self.register_parameter(
                    f"b{side}_{lid}",
                    nn.Parameter(torch.zeros(self.layers[lid])))

    def _towers(self, ue, ie):
        for lid in range(1, len(self.layers)):
            ue = torch.relu(ue @ getattr(self, f"Wu_{lid}")
                            + getattr(self, f"bu_{lid}"))
            ie = torch.relu(ie @ getattr(self, f"Wi_{lid}")
                            + getattr(self, f"bi_{lid}"))
        return ue, ie

    def _cosine(self, ue, ie):
        num = (ue * ie).sum(dim=-1)
        den = (torch.sqrt(torch.sum(ue * ue, dim=-1) + 1e-12)
               * torch.sqrt(torch.sum(ie * ie, dim=-1) + 1e-12))
        return _floor(num / _floor(den, 1e-8), self.mu)

    def loss(self, batch, aux: Aux):
        w, y = batch["w"], batch["y"]
        pu = gather_rows(self.P, batch["u"])
        qi = gather_rows(self.Q, batch["i"])
        score = self._cosine(*self._towers(pu, qi))
        capped = torch.minimum(score, score.new_full((), 1 - 1e-7))
        per = -(y * torch.log(score) + (1 - y) * torch.log1p(-capped))
        wc = w[:, None]
        return (torch.sum(per * w)
                + self.reg * (l2_loss(pu * wc) + l2_loss(qi * wc)))

    def score_pairs(self, u, i, aux: Aux):
        return self._cosine(*self._towers(self.P[u], self.Q[i]))


class SML(_Tables):
    name = "SML"
    sampler = "pairwise"
    cml_like = True

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg")
        self.embed_size = d = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self.gamma = cfg.float("gamma", 1.0)
        self.margin_cap = cfg.float("margin_cap", 1.0)
        self.lam = cfg.float("margin_reg", 0.01)
        self.P = nn.Parameter(torch.zeros(meta.user_nums, d))
        self.Q = nn.Parameter(torch.zeros(meta.item_nums, d))
        self.m_u = nn.Parameter(torch.zeros(meta.user_nums))
        self.m_i = nn.Parameter(torch.zeros(meta.item_nums))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in (self.P, self.Q):
            p.copy_(init_param(generator, self.initializer, p.shape))
        self.m_u.fill_(0.5)
        self.m_i.fill_(0.5)

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        ue = gather_rows(self.P, batch["u"])
        ie = gather_rows(self.Q, batch["i"])
        je = gather_rows(self.Q, batch["j"])
        d_ui, d_uj, d_ij = sq_dist(ue, ie), sq_dist(ue, je), sq_dist(ie, je)
        m_u = _clip(gather_rows(self.m_u, batch["u"]), 0.0, self.margin_cap)
        m_i = _clip(gather_rows(self.m_i, batch["i"]), 0.0, self.margin_cap)
        user_side = torch.sum(_floor(d_ui + m_u - d_uj, 0.0) * w)
        item_side = torch.sum(_floor(d_ui + m_i - d_ij, 0.0) * w)
        # The bonus for large margins (a negative regulariser).
        bonus = -self.lam * (torch.sum(m_u * w) + torch.sum(m_i * w))
        wc = w[:, None]
        reg = l2_loss(ue * wc) + l2_loss(ie * wc) + l2_loss(je * wc)
        return user_side + self.gamma * item_side + bonus + self.reg * reg

    @torch.no_grad()
    def postprocess(self) -> None:
        self.m_u.clamp_(0.0, self.margin_cap)
        self.m_i.clamp_(0.0, self.margin_cap)

    def score_pairs(self, u, i, aux: Aux):
        return sq_dist(self.P[u], self.Q[i])

    def score_all(self, u, aux: Aux):
        ue, q = self.P[u], self.Q
        return (torch.sum(torch.square(ue), dim=1, keepdim=True)
                - 2.0 * (ue @ q.T) + torch.sum(torch.square(q), dim=1)[None])

    def dot_decomposition(self, u, aux: Aux):
        """|u - q|^2 less the per-user |u|^2, as (-2u).q + |q|^2 (CML's
        form, metric.py); the rankers negate both parts."""
        return -2.0 * self.P[u], self.Q, torch.sum(torch.square(self.Q), dim=1)


class EATNN(_Tables):
    name = "EATNN"
    sampler = "pairwise"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg")
        self.embed_size = d = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self.social_weight = cfg.float("social_weight", 0.5)
        for name, rows in (("P_shared", meta.user_nums),
                           ("P_item", meta.user_nums),
                           ("P_social", meta.user_nums),
                           ("Q", meta.item_nums)):
            self.register_parameter(name, nn.Parameter(torch.zeros(rows, d)))
        self.att_w = nn.Parameter(torch.zeros(d, d))
        self.att_h = nn.Parameter(torch.zeros(d))

    def build_aux(self, dd, data) -> dict:
        if data.user_friends is None:
            raise ValueError("EATNN requires social_file")
        sf_u, sf_v = flatten_friend_edges(data.user_friends)
        if sf_u.size == 0:
            raise ValueError("EATNN: social_file has no friend edges")
        return {"sf_u_e": sf_u, "sf_v_e": sf_v}

    def _user_vec(self, u, domain: str):
        shared = gather_rows(self.P_shared, u)
        spec = gather_rows(getattr(self, f"P_{domain}"), u)
        # How much of the shared row flows into this domain, per user.
        gate = torch.sigmoid(torch.tanh(shared @ self.att_w) @ self.att_h)
        return shared * gate[:, None] + spec

    @staticmethod
    def edge_draw(u, n_f: int, generator=None, chunk=None):
        """The friend edge of each row: uniform from ``generator`` (one
        fresh batch a step), or, without one, the fixed hash of the JAX
        package's keyless call in int64 arithmetic.  ``chunk`` (lo, hi,
        n): u holds rows lo:hi of a batch of n (a data rank's share of a
        split step), and the draw is the whole batch's, cut to them."""
        if generator is not None:
            lo, hi, n = chunk or (0, u.shape[0], u.shape[0])
            return torch.randint(0, n_f, (n,) + tuple(u.shape[1:]),
                                 generator=generator, device=u.device)[lo:hi]
        return ((u.long() * HASH_MUL) & 0xFFFFFFFF) % max(n_f, 1)

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        uv = self._user_vec(batch["u"], "item")
        qi = gather_rows(self.Q, batch["i"])
        qj = gather_rows(self.Q, batch["j"])
        s_i, s_j = (uv * qi).sum(dim=1), (uv * qj).sum(dim=1)
        main = pairwise_loss(self.loss_func, s_i - s_j, weight=w)
        idx = self.edge_draw(batch["u"], aux["sf_u_e"].shape[0],
                             batch.get("dropout_gen"), batch.get("chunk"))
        su = self._user_vec(aux["sf_u_e"][idx], "social")
        sv = self._user_vec(aux["sf_v_e"][idx], "social")
        social = torch.sum(torch.square(su - sv) * w[:, None])
        wc = w[:, None]
        reg = l2_loss(uv * wc) + l2_loss(qi * wc) + l2_loss(qj * wc)
        return main + self.social_weight * social + self.reg * reg

    def score_pairs(self, u, i, aux: Aux):
        return (self._user_vec(u, "item") * self.Q[i]).sum(dim=1)

    def score_candidates(self, u, cand, aux: Aux):
        return torch.einsum("bd,bcd->bc", self._user_vec(u, "item"),
                            self.Q[cand])

    def score_all(self, u, aux: Aux):
        return self._user_vec(u, "item") @ self.Q.T

    def dot_decomposition(self, u, aux: Aux):
        return self._user_vec(u, "item"), self.Q, None
