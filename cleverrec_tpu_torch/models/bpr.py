"""BPR: Bayesian Personalized Ranking (UAI'09).

score(u, i) = <P[u], Q[i]>; full-catalog prediction = U_batch @ Q^T
(reference: model/ranking/BPR.py:33-51).  The loss comes with the
training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from cleverrec_tpu_torch.common import init_param
from cleverrec_tpu_torch.models.base import Aux, RecModel


class BPR(RecModel):
    name = "BPR"

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

    def score_pairs(self, u, i, aux: Aux):
        return (self.P[u] * self.Q[i]).sum(dim=1)

    def score_all(self, u, aux: Aux):
        return self.P[u] @ self.Q.T

    def dot_decomposition(self, u, aux: Aux):
        """(user_vecs, item_table, item_bias|None): enables the masked
        dot-scoring kernels (ops/scores.py)."""
        return self.P[u], self.Q, None
