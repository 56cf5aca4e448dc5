"""BPR: Bayesian Personalized Ranking (UAI'09).

score(u, i) = <P[u], Q[i]>;  loss = get_loss(ui - uj) +
reg * (l2(u_emb) + l2(i_emb) + l2(j_emb)) over the batch gathers;
full-catalog prediction = U_batch @ Q^T (reference:
model/ranking/BPR.py:33-51).
"""

from __future__ import annotations

import torch
from torch import nn

from cleverrec_tpu_torch.common import init_param, l2_loss, pairwise_loss
from cleverrec_tpu_torch.models.base import Aux, RecModel


class BPR(RecModel):
    name = "BPR"
    sampler = "pairwise"
    # The exact {P, Q} dot-product pairwise form: eligible for the fused
    # epoch kernel (ops/train.py).
    fused_protocol = "pairwise_bpr"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg")
        self.embed_size = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self.P = nn.Parameter(torch.zeros(meta.user_nums, self.embed_size))
        self.Q = nn.Parameter(torch.zeros(meta.item_nums, self.embed_size))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in (self.P, self.Q):
            p.copy_(init_param(generator, self.initializer, p.shape))

    def loss(self, batch, aux: Aux):
        # The reference weights twice: rows scaled by w AND the loss
        # weighted by w (as the JAX BPR.loss).
        w = batch["w"]
        ue = self.P[batch["u"]] * w[:, None]
        ie = self.Q[batch["i"]] * w[:, None]
        je = self.Q[batch["j"]] * w[:, None]
        diff = (ue * ie).sum(dim=1) - (ue * je).sum(dim=1)
        main = pairwise_loss(self.loss_func, diff, weight=w)
        return main + self.reg * (l2_loss(ue) + l2_loss(ie) + l2_loss(je))

    def score_pairs(self, u, i, aux: Aux):
        return (self.P[u] * self.Q[i]).sum(dim=1)

    def score_all(self, u, aux: Aux):
        return self.P[u] @ self.Q.T

    def dot_decomposition(self, u, aux: Aux):
        """(user_vecs, item_table, item_bias|None): enables the masked
        dot-scoring kernels (ops/scores.py)."""
        return self.P[u], self.Q, None
