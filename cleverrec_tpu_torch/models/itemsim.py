"""Item-similarity models: FISM, NAIS and NAIS_single (as
``cleverrec_tpu/models/itemsim.py``).

- FISM (model/ranking/FISM.py:38-72): the user vector is
  (1/|I_u|) * sum_{j in I_u} P[j], scaled again by |I_u|^(-alpha) (the
  reference composes both factors), recomputed from the current P at
  every step as a segment sum over the whole pair list; the history
  keeps the target item.  score = <Q[i], user> + b[i].  Loss: pairwise
  (or pointwise) + reg * (l2(P) + l2(Q)) / batch_size + reg_bias * l2(b)
  over the FULL tables.  Tables have item_nums + 1 rows (the last a
  sentinel); b ~ U(-0.1, 0.1) whatever the init method.
- NAIS (model/ranking/NAIS_single.py:40-101): attention over the user's
  padded seen history (``aux["seen_rows"]``, pad id ``item_nums``, a
  real sentinel row of every table), weight h^T ReLU(joint W + b) with
  joint = q_i * p_h (``prod``) or [p_h, q_i] (``concat``), the smoothed
  softmax of ``masked_history_attention``.  ``loss`` is the flat
  pointwise loss, ``loss_grouped`` the same rows as (user, target-chunk)
  groups with the history gathered once a group (the trainer's
  bucketed-history tier); NAIS_single is the same model.  ``concat``
  splits W into its history and target halves, so the [.., H, 2d] joint
  is never built.  NAIS warm-starts from a FISM checkpoint
  (``fism_pretrain``: P, Q and b into P, Q and bias).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cleverrec_tpu_torch.common import (init_param, l2_loss, pairwise_loss,
                                        sigmoid_xent_loss)
from cleverrec_tpu_torch.models.base import Aux, RecModel
from cleverrec_tpu_torch.models.modules import (gather_rows,
                                                masked_history_attention,
                                                relu_mlp_logits,
                                                segment_mean_embeddings)
from cleverrec_tpu_torch.train.checkpoint import graft_nais, load_params


def _uniform_bias(generator, n):
    return torch.empty(n).uniform_(-0.1, 0.1, generator=generator)


class FISM(RecModel):
    name = "FISM"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg", "reg_bias", "alpha")
        self.embed_size = d = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self.reg_bias = cfg.float("reg_bias")
        self.alpha = cfg.float("alpha")
        self.pairwise = cfg.is_pairwise
        self.sampler = "pairwise" if self.pairwise else "pointwise"
        self.batch_size = cfg.batch_size
        n_items = meta.item_nums + 1                     # sentinel pad row
        self.P = nn.Parameter(torch.zeros(n_items, d))
        self.Q = nn.Parameter(torch.zeros(n_items, d))
        self.b = nn.Parameter(torch.zeros(n_items))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in (self.P, self.Q):
            p.copy_(init_param(generator, self.initializer, p.shape))
        self.b.copy_(_uniform_bias(generator, self.b.shape[0]))

    def build_aux(self, dd, data) -> dict:
        cnt = np.zeros(self.meta.user_nums, np.float32)
        np.add.at(cnt, dd.pos_u, 1.0)
        return {"u_deg": cnt}

    def _user_repr(self, aux: Aux, u):
        """coeff[u] * mean_{j in I_u} P[j] for the users u, from the current
        P: one segment sum over the whole pair list."""
        deg = torch.clamp(aux["u_deg"], min=1.0)
        scale = deg ** -self.alpha / deg
        agg = segment_mean_embeddings(aux["pos_u"], aux["pos_i"], self.P,
                                      self.meta.user_nums, scale)
        return agg[u.long()]

    loss = RecModel.summed_parts

    def loss_parts(self, batch, aux: Aux):
        """(the pairwise or pointwise loss over the batch's rows, the L2 of
        the whole tables: a table term, over the configured batch size
        whatever rows a rank holds)."""
        w = batch["w"]
        ur = self._user_repr(aux, batch["u"])
        s_i = (gather_rows(self.Q, batch["i"]) * ur).sum(dim=1) + gather_rows(
            self.b, batch["i"])
        reg_emb = (self.reg * (l2_loss(self.P) + l2_loss(self.Q))
                   / self.batch_size + self.reg_bias * l2_loss(self.b))
        if self.pairwise:
            s_j = (gather_rows(self.Q, batch["j"]) * ur).sum(
                dim=1) + gather_rows(self.b, batch["j"])
            return pairwise_loss(self.loss_func, s_i - s_j, weight=w), reg_emb
        return sigmoid_xent_loss(batch["y"], s_i, weight=w), reg_emb

    def score_pairs(self, u, i, aux: Aux):
        ur = self._user_repr(aux, u)
        return (self.Q[i] * ur).sum(dim=1) + self.b[i]

    def score_all(self, u, aux: Aux):
        ur = self._user_repr(aux, u)
        n = self.meta.item_nums
        return ur @ self.Q[:n].T + self.b[None, :n]


class NAIS(RecModel):
    name = "NAIS"
    sampler = "pointwise"
    # Attention cost scales with the history width: the trainer's
    # bucketed-history tier trains it (Trainer._build_buckets).
    history_bucketing = True
    pretrain_keys = ("fism_pretrain",)
    # Targets per (user, chunk) group in the grouped training layout.
    TARGET_CHUNK = 32
    # [B, chunk, H, d] peak in score_all: keep the chunk small.
    SCORE_ALL_CHUNK = 16
    # Candidates scored at once by score_candidates.
    CANDIDATE_CHUNK = 8
    # The flat loss's L2 reads the batch's rows alone.
    loss_parts = RecModel.rows_only_parts

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "atten_size", "reg", "beta")
        self.embed_size = d = cfg.int("embed_size")
        self.atten_size = a = cfg.int("atten_size")
        self.reg = cfg.float("reg")
        self.beta = cfg.float("beta")
        self.atten_type = cfg.str("atten_type", "prod")
        n_items = meta.item_nums + 1                     # sentinel pad row
        w_in = 2 * d if self.atten_type == "concat" else d
        self.P = nn.Parameter(torch.zeros(n_items, d))
        self.Q = nn.Parameter(torch.zeros(n_items, d))
        self.bias = nn.Parameter(torch.zeros(n_items))
        self.W = nn.Parameter(torch.zeros(w_in, a))
        self.b = nn.Parameter(torch.zeros(a))
        self.h = nn.Parameter(torch.zeros(a))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in (self.P, self.Q, self.W):
            p.copy_(init_param(generator, self.initializer, p.shape))
        for p in (self.bias, self.b, self.h):
            p.copy_(_uniform_bias(generator, p.shape[0]))

    def build_aux(self, dd, data) -> dict:
        """The users' sorted seen rows [U, h_max], padded with item_nums:
        the histories the attention reads."""
        return {"seen_rows": dd.seen.rows}

    def warm_start(self, params: dict, cfg) -> dict:
        """``params`` grafted from the FISM checkpoint ``fism_pretrain``
        names."""
        return graft_nais(params, load_params(cfg.str("fism_pretrain")))

    def _logits(self, pe, qi):
        """Attention logits [..., H] of history rows pe [..., H, d] against
        targets qi [..., d] (leading axes broadcast)."""
        q = qi[..., None, :]
        if self.atten_type == "concat":
            d = pe.shape[-1]
            return torch.relu(pe @ self.W[:d] + q @ self.W[d:]
                              + self.b) @ self.h
        return relu_mlp_logits(pe * q, self.W, self.b, self.h)

    def _history(self, aux: Aux, u):
        """(history ids [B, H], validity [B, H], P rows [B, H, d])."""
        hist = aux["seen_rows"][u.long()]
        return hist, hist < self.meta.item_nums, gather_rows(self.P, hist)

    def _scores(self, aux: Aux, u, i):
        _, mask, pe = self._history(aux, u)
        qi = gather_rows(self.Q, i)
        ue = masked_history_attention(pe, mask, self._logits(pe, qi),
                                      self.beta)
        return (ue * qi).sum(dim=1) + gather_rows(self.bias, i), ue, qi

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        s, ue, qi = self._scores(aux, batch["u"], batch["i"])
        wc = w[:, None]
        ib = gather_rows(self.bias, batch["i"])
        return (sigmoid_xent_loss(batch["y"], s, weight=w)
                + self.reg * (l2_loss(ue * wc) + l2_loss(qi * wc)
                              + l2_loss(ib * w)))

    def _grouped_scores(self, pe, mask, tgt):
        """Scores [G, T] of targets tgt [G, T] against each group's
        history (pe [G, H, d], mask [G, H]), with the attended vectors
        [G, T, d] and the target rows [G, T, d]."""
        qi = gather_rows(self.Q, tgt)
        att = masked_history_attention(
            pe, mask, self._logits(pe[:, None], qi), self.beta)
        return (att * qi).sum(dim=-1) + gather_rows(self.bias, tgt), att, qi

    def loss_grouped(self, batch, aux: Aux):
        """User-grouped pointwise loss: ``gu`` [G] users, ``gt``, ``gy``
        and ``gw`` [G, T] targets, labels and weights.  Each (group,
        target) cell is one flat pointwise row (the same terms as
        ``loss``); the history is gathered once a group."""
        _, mask, pe = self._history(aux, batch["gu"])
        s, att, qi = self._grouped_scores(pe, mask, batch["gt"])
        w = batch["gw"]
        wc = w[..., None]
        ib = gather_rows(self.bias, batch["gt"])
        return (sigmoid_xent_loss(batch["gy"], s, weight=w)
                + self.reg * (l2_loss(att * wc) + l2_loss(qi * wc)
                              + l2_loss(ib * w)))

    def score_pairs(self, u, i, aux: Aux):
        return self._scores(aux, u, i)[0]

    def score_candidates(self, u, cand, aux: Aux):
        """The history gathered once for the batch, the candidates scored
        ``CANDIDATE_CHUNK`` at a time (the [B, C, H, d] joint tensor is
        the memory hazard)."""
        _, mask, pe = self._history(aux, u)
        return torch.cat([self._grouped_scores(pe, mask, c)[0]
                          for c in cand.split(self.CANDIDATE_CHUNK, dim=1)],
                         dim=1)


class NAISSingle(NAIS):
    """The reference's working per-user NAIS variant: the same model."""

    name = "NAIS_single"
