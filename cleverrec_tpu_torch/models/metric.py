"""Metric-learning models: CML, LRML and TransCF (as
``cleverrec_tpu/models/metric.py``).

All three are ``cml_like``: the score is a squared distance, LOWER is
better, and the rankers negate it (RankingRecommender.py:222-225).

- CML (model/ranking/CML.py:40-78): K negatives per pair, a hinge on
  the nearest one, the WARP weight log(rank + 1) with
  rank = mean(imposters) * item_nums / neg_ratio (the reference's
  formula as written, :50-53; ``item_nums`` the real catalog size; no
  gradient flows through it), and a covariance regulariser over
  concat(Q, P) with the diagonal left out (:63-70).  The reference's
  "unit clipping" never feeds back into training (it clips the gathered
  tensors after the optimizer op is built, :72-78), so there is no
  ``postprocess``; its only effect is that the full-catalog scorer and
  ``dot_decomposition`` use row-clipped user embeddings (:85-87), while
  ``score_pairs`` does not.
- LRML (model/ranking/LRML.py:42-75): memory attention
  r = softmax((p * q) K) M, d = |p + r - q|^2, a pairwise loss with
  margin, L2 on the gathered rows.
- TransCF (model/ranking/TransCF.py:41-88): neighbourhood means by
  row-normalised incidence aggregation, recomputed from the current
  tables at every step; relation r = u_nbr * i_nbr, d = |p + r - q|^2;
  pairwise loss plus neighbourhood and distance regularisers.  Its
  full-catalog scorer uses row-clipped user embeddings, its pair scorer
  does not (TransCF.py:79-85).

Parameters keep the JAX names and shapes: ``P`` [U, d], ``Q`` [I, d];
LRML also ``K`` [d, mem] and ``M`` [mem, d].

CML trains through the ``cml_hinge`` epoch kernel (ops/train.py
``fused_cml_epoch``) with Adam and the hinge loss.  LRML trains through
the rows epoch (``fused_rows_epoch``): its ``fused_rows_spec`` carries
``lrml``, the form whose backward the CUDA kernel has by hand (margin,
reg, memory width; hinge only).  TransCF has no fused tier.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cleverrec_tpu_torch.common import (clip_rows_by_norm, init_param,
                                        l2_loss, pairwise_loss)
from cleverrec_tpu_torch.models.base import Aux, RecModel
from cleverrec_tpu_torch.models.modules import (segment_mean_embeddings,
                                                sq_dist)


class _MetricBase(RecModel):
    """The user and item tables the three share."""

    cml_like = True
    loss_parts = RecModel.rows_only_parts

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "margin")
        self.embed_size = d = cfg.int("embed_size")
        self.margin = cfg.float("margin")
        self.P = nn.Parameter(torch.zeros(meta.user_nums, d))
        self.Q = nn.Parameter(torch.zeros(meta.item_nums, d))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            p.copy_(init_param(generator, self.initializer, p.shape))


class CML(_MetricBase):
    name = "CML"
    sampler = "cml"
    fused_protocol = "cml_hinge"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("reg")
        self.reg = cfg.float("reg")
        self.neg_ratio = cfg.neg_ratio

    loss = RecModel.summed_parts

    def loss_parts(self, batch, aux: Aux):
        """(the WARP-weighted hinge over the batch's rows, the covariance
        regulariser over the whole tables: a table term)."""
        w = batch["w"]
        ue = self.P[batch["u"]]
        ie = self.Q[batch["i"]]
        ne = self.Q[batch["negs"]]                          # [B, K, d]
        d_ui = sq_dist(ue, ie)
        d_un = sq_dist(ue[:, None, :], ne)                 # [B, K]
        # amin spreads the gradient over exact ties, as jnp.min does.
        per_pair = torch.clamp(d_ui + self.margin - d_un.amin(dim=1), min=0.0)
        imposters = (d_ui[:, None] + self.margin - d_un) > 0
        rank = (imposters.to(torch.float32).mean(dim=1)
                * self.meta.item_nums / self.neg_ratio)
        per_pair = per_pair * torch.log(rank + 1.0) * w
        # The covariance regulariser over the full concatenated tables.
        x = torch.cat([self.Q, self.P], dim=0)
        xc = x - x.mean(dim=0)
        cov = (xc.T @ xc) / x.shape[0]
        cov_loss = self.reg * (cov.sum() - torch.diagonal(cov).sum())
        return per_pair.sum(), cov_loss

    def score_pairs(self, u, i, aux: Aux):
        return sq_dist(self.P[u], self.Q[i])

    def score_all(self, u, aux: Aux):
        # Row-clipped user embeddings against the raw item table
        # (CML.py:72-87), in the expanded form |u|^2 - 2 u.q + |q|^2.
        ue = clip_rows_by_norm(self.P[u])
        q = self.Q
        return (torch.sum(torch.square(ue), dim=1, keepdim=True)
                - 2.0 * (ue @ q.T) + torch.sum(torch.square(q), dim=1)[None])

    def dot_decomposition(self, u, aux: Aux):
        """The distance as a dot plus an item bias, up to the per-user
        |u|^2 that does not change a ranking: |u - q|^2 - |u|^2 =
        (-2u).q + |q|^2.  The rankers negate both parts."""
        ue = clip_rows_by_norm(self.P[u])
        return -2.0 * ue, self.Q, torch.sum(torch.square(self.Q), dim=1)


class LRML(_MetricBase):
    name = "LRML"
    sampler = "pairwise"
    fused_protocol = "rows"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("reg", "mem_size")
        self.mem_size = mem = cfg.int("mem_size")
        self.reg = cfg.float("reg")
        self.K = nn.Parameter(torch.zeros(self.embed_size, mem))
        self.M = nn.Parameter(torch.zeros(mem, self.embed_size))

    @staticmethod
    def _dist(ue, xe, K, M):
        atten = torch.softmax((ue * xe) @ K, dim=-1)
        return torch.sum(torch.square(ue + atten @ M - xe), dim=-1)

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        ue = self.P[batch["u"]]
        ie = self.Q[batch["i"]]
        je = self.Q[batch["j"]]
        diff = (self._dist(ue, ie, self.K, self.M)
                - self._dist(ue, je, self.K, self.M))
        main = pairwise_loss(self.loss_func, diff, margin=self.margin,
                             weight=w)
        wc = w[:, None]
        return main + self.reg * (l2_loss(ue * wc) + l2_loss(ie * wc)
                                  + l2_loss(je * wc))

    def score_pairs(self, u, i, aux: Aux):
        return self._dist(self.P[u], self.Q[i], self.K, self.M)

    def fused_rows_spec(self) -> dict:
        """The rows epoch's view: planes (u, i, j), no float columns, K
        and M as dense params, ``row_loss`` the loss over the gathered
        rows (w as a [B, 1] column), and ``lrml``, the form the CUDA
        kernel's hand-written backward takes."""
        reg, margin, loss_func = self.reg, self.margin, self.loss_func

        def pack(t):
            return ((t["P"].detach(),), (t["Q"].detach(),),
                    (t["K"].detach(), t["M"].detach()))

        def row_loss(rows, floats, dense, w):
            ue, ie, je = rows
            K, M = dense
            diff = (self._dist(ue, ie, K, M) - self._dist(ue, je, K, M))
            main = pairwise_loss(loss_func, diff[:, None], margin=margin,
                                 weight=w)
            return main + reg * (l2_loss(ue * w) + l2_loss(ie * w)
                                 + l2_loss(je * w))

        return {"planes": (("u", "u"), ("i", "i"), ("j", "i")),
                "floats": (), "dense": ("K", "M"), "pack": pack,
                "row_loss": row_loss,
                "lrml": {"margin": margin, "reg": reg, "loss": loss_func,
                         "d": self.embed_size, "mem": self.mem_size}}


class TransCF(_MetricBase):
    name = "TransCF"
    sampler = "pairwise"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("reg1", "reg2")
        self.reg1 = cfg.float("reg1")
        self.reg2 = cfg.float("reg2")

    def build_aux(self, dd, data) -> dict:
        """Inverse degrees for the neighbourhood means (in place of the
        reference's incidence matrices, utils/tools.py:100-113)."""
        u_cnt = np.zeros(self.meta.user_nums, np.float32)
        i_cnt = np.zeros(self.meta.item_nums, np.float32)
        np.add.at(u_cnt, dd.pos_u, 1.0)
        np.add.at(i_cnt, dd.pos_i, 1.0)
        return {"inv_deg_u": 1.0 / np.maximum(u_cnt, 1.0),
                "inv_deg_i": 1.0 / np.maximum(i_cnt, 1.0)}

    def _nbr_tables(self, aux):
        u_nbr = segment_mean_embeddings(aux["pos_u"], aux["pos_i"], self.Q,
                                        self.meta.user_nums, aux["inv_deg_u"])
        i_nbr = segment_mean_embeddings(aux["pos_i"], aux["pos_u"], self.P,
                                        self.meta.item_nums, aux["inv_deg_i"])
        return u_nbr, i_nbr

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        u, i, j = batch["u"], batch["i"], batch["j"]
        ue, ie, je = self.P[u], self.Q[i], self.Q[j]
        u_nbr_all, i_nbr_all = self._nbr_tables(aux)
        un, in_, jn = u_nbr_all[u], i_nbr_all[i], i_nbr_all[j]
        d_ui = torch.sum(torch.square(ue + un * in_ - ie), dim=1)
        d_uj = torch.sum(torch.square(ue + un * jn - je), dim=1)
        main = pairwise_loss(self.loss_func, d_ui - d_uj, margin=self.margin,
                             weight=w)
        # Neighbourhood and distance regularisers (TransCF.py:65-71).
        wc = w[:, None]
        reg_nbr = (torch.sum(torch.square((ue - un) * wc))
                   + torch.sum(torch.square((ie - in_) * wc)))
        reg_dist = torch.sum(torch.square((d_ui + self.margin - d_uj) * w))
        return main + self.reg1 * reg_nbr + self.reg2 * reg_dist

    def score_pairs(self, u, i, aux: Aux):
        u_nbr_all, i_nbr_all = self._nbr_tables(aux)
        r = u_nbr_all[u] * i_nbr_all[i]
        return torch.sum(torch.square(self.P[u] + r - self.Q[i]), dim=1)

    def score_all(self, u, aux: Aux):
        """|clip(u) + u_nbr * i_nbr - Q|^2 over item chunks: the
        reference reassigns u_embed to its clipped rows before the
        full-catalog branch is built, so only this branch clips
        (TransCF.py:79-85)."""
        u_nbr_all, i_nbr_all = self._nbr_tables(aux)
        ue = clip_rows_by_norm(self.P[u])[:, None, :]
        un = u_nbr_all[u][:, None, :]
        items = torch.arange(self.meta.item_nums, device=u.device)
        return torch.cat([
            torch.sum(torch.square(ue + un * i_nbr_all[c][None]
                                   - self.Q[c][None]), dim=-1)
            for c in items.split(self.SCORE_ALL_CHUNK)], dim=1)
