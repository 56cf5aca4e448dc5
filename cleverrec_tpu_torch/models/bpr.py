"""BPR: Bayesian Personalized Ranking (UAI'09).

score(u, i) = <P[u], Q[i]>;  loss = get_loss(ui - uj) +
reg * (l2(u_emb) + l2(i_emb) + l2(j_emb)) over the batch gathers;
full-catalog prediction = U_batch @ Q^T (reference:
model/ranking/BPR.py:33-51).

``fused_rows_spec`` is BPR's loss over gathered rows for the lazy
row-Adam tier (``train.sparse_rows_force``); the fused tier takes BPR
through ``fused_bpr_epoch``, not through the rows kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from cleverrec_tpu_torch.common import init_param, l2_loss, pairwise_loss
from cleverrec_tpu_torch.models.base import Aux, RecModel


def _rows_loss(loss_func: str, reg: float, rows, w):
    """BPR's loss over gathered (P[u], Q[i], Q[j]) rows and weights w
    [B].  The reference weights twice: rows scaled by w AND the loss
    weighted by w (as the JAX BPR.loss)."""
    ue, ie, je = (r * w[:, None] for r in rows)
    diff = (ue * ie).sum(dim=1) - (ue * je).sum(dim=1)
    main = pairwise_loss(loss_func, diff, weight=w)
    return main + reg * (l2_loss(ue) + l2_loss(ie) + l2_loss(je))


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
        rows = (self.P[batch["u"]], self.Q[batch["i"]], self.Q[batch["j"]])
        return _rows_loss(self.loss_func, self.reg, rows, batch["w"])

    loss_parts = RecModel.rows_only_parts

    def score_pairs(self, u, i, aux: Aux):
        return (self.P[u] * self.Q[i]).sum(dim=1)

    def score_all(self, u, aux: Aux):
        return self.P[u] @ self.Q.T

    def fused_rows_spec(self) -> dict:
        """The rows view of BPR (``models/social.py`` describes the keys):
        planes (u, i, j) and ``BPR.loss``'s formula over the gathered
        rows (w arrives as [B, 1])."""
        reg, lf = self.reg, self.loss_func

        def pack(t):
            return (t["P"].detach(),), (t["Q"].detach(),), ()

        def row_loss(rows, floats, dense, w):
            return _rows_loss(lf, reg, rows, w[:, 0])

        return {"planes": (("u", "u"), ("i", "i"), ("j", "i")),
                "floats": (), "dense": (), "pack": pack,
                "row_loss": row_loss, "chain": None}

    def dot_decomposition(self, u, aux: Aux):
        """(user_vecs, item_table, item_bias|None): enables the masked
        dot-scoring kernels (ops/scores.py)."""
        return self.P[u], self.Q, None
