"""Graph-convolution CF: LightGCN and NGCF (as
``cleverrec_tpu/models/gcn.py``).

- LightGCN (SIGIR'20): E^(l+1) = A_hat E^l with the symmetric-normalised
  bipartite adjacency A_hat = D^-1/2 A D^-1/2 (no self loops, no
  transforms); the final embeddings are the mean over layers 0..L; BPR
  loss with L2 on the ego rows of the batch.  It ranks by inner product,
  so ``dot_decomposition`` takes it to the masked-scoring kernels.
- NGCF (SIGIR'19): E^(l+1) = LeakyReLU_0.2((A_hat E + E) W1 + b1
  + (A_hat E * E) W2 + b2), message dropout after the activation (in
  the loss only, scaled by 1/(1-p)), each layer's output normalised by
  rsqrt(sum x^2 + 1e-12), the layers concatenated; BPR loss with L2 on
  the propagated rows of the batch.  The dropout mask is drawn from the
  generator the trainer passes as ``batch["dropout_gen"]`` (the JAX
  package's ``dropout_key``); without one nothing is dropped.

A_hat is a dense [n, n] matrix (n = users + items) while n^2 * 4 bytes
fit ``graph.dense_budget_mb`` (default 512), each layer one product;
past it, the edge list, each layer a gather and an ``index_add``.
Duplicate (u, i) pairs emit their edge more than once and sum in both
forms.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cleverrec_tpu_torch.common import bpr_loss, init_param, l2_loss
from cleverrec_tpu_torch.models.base import Aux, RecModel
from cleverrec_tpu_torch.models.modules import edge_sum, gather_rows

DENSE_ADJ_BUDGET_MB = 512


def _bipartite_edges(dd, user_nums: int, item_nums: int):
    """Symmetric-normalised bipartite edges over U + I nodes: (rows, cols,
    weights), both directions of every train pair."""
    u = dd.pos_u.astype(np.int64)
    i = dd.pos_i.astype(np.int64) + user_nums
    rows = np.concatenate([u, i])
    cols = np.concatenate([i, u])
    deg = np.zeros(user_nums + item_nums)
    np.add.at(deg, rows, 1.0)
    w = 1.0 / np.sqrt(np.maximum(deg[rows] * deg[cols], 1.0))
    return (rows.astype(np.int32), cols.astype(np.int32),
            w.astype(np.float32))


def _graph_aux(dd, user_nums: int, item_nums: int, cfg) -> dict:
    """{"g_dense": A_hat [n, n]} within the budget, else {"g_row", "g_col",
    "g_w"}: the edge list."""
    rows, cols, w = _bipartite_edges(dd, user_nums, item_nums)
    n = user_nums + item_nums
    budget = cfg.int("graph.dense_budget_mb", DENSE_ADJ_BUDGET_MB)
    if n * n * 4 <= budget * 2 ** 20:
        dense = np.zeros((n, n), np.float32)
        # add.at, not assignment: a repeated edge sums, as in the edge
        # form's index_add.
        np.add.at(dense, (rows, cols), w)
        return {"g_dense": dense}
    return {"g_row": rows, "g_col": cols, "g_w": w}


def _adj_apply(aux: Aux, ego: torch.Tensor) -> torch.Tensor:
    """One A_hat @ E step: a dense product, or the edge list's weighted
    gather summed into its rows."""
    if "g_dense" in aux:
        return aux["g_dense"] @ ego
    return edge_sum(ego, aux["g_row"], aux["g_col"], aux["g_w"],
                    ego.shape[0])


class _GraphModel(RecModel):
    """The shared half of LightGCN and NGCF: the graph, the P and Q
    tables, and the scorers over the propagated embeddings.  Their loss
    is a row sum alone: the propagation over the whole tables is work
    every rank of a split repeats, neither rows nor tables."""

    sampler = "pairwise"
    loss_parts = RecModel.rows_only_parts

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg")
        self.embed_size = d = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self.n_layers = cfg.int("n_layers", 3)
        self.P = nn.Parameter(torch.zeros(meta.user_nums, d))
        self.Q = nn.Parameter(torch.zeros(meta.item_nums, d))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            p.copy_(init_param(generator, self.initializer, p.shape))

    def build_aux(self, dd, data) -> dict:
        return _graph_aux(dd, self.meta.user_nums, self.meta.item_nums,
                          self.cfg)

    def _split(self, final):
        return final[:self.meta.user_nums], final[self.meta.user_nums:]

    def score_pairs(self, u, i, aux: Aux):
        u_g, i_g = self._propagate(aux)
        return (u_g[u] * i_g[i]).sum(dim=1)

    def score_candidates(self, u, cand, aux: Aux):
        u_g, i_g = self._propagate(aux)
        return torch.einsum("bd,bcd->bc", u_g[u], i_g[cand])

    def score_all(self, u, aux: Aux):
        u_g, i_g = self._propagate(aux)
        return u_g[u] @ i_g.T


class LightGCN(_GraphModel):
    name = "LightGCN"

    def _propagate(self, aux: Aux):
        ego = torch.cat([self.P, self.Q], dim=0)
        acc = ego
        for _ in range(self.n_layers):
            ego = _adj_apply(aux, ego)
            acc = acc + ego
        return self._split(acc / (self.n_layers + 1))

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        u_g, i_g = self._propagate(aux)
        ue = gather_rows(u_g, batch["u"])
        s_i = (ue * gather_rows(i_g, batch["i"])).sum(dim=1)
        s_j = (ue * gather_rows(i_g, batch["j"])).sum(dim=1)
        wc = w[:, None]
        reg = (l2_loss(gather_rows(self.P, batch["u"]) * wc)
               + l2_loss(gather_rows(self.Q, batch["i"]) * wc)
               + l2_loss(gather_rows(self.Q, batch["j"]) * wc))
        return bpr_loss(s_i - s_j, weight=w) + self.reg * reg

    def dot_decomposition(self, u, aux: Aux):
        """(user_vecs, item_table, None) for the masked dot-scoring
        kernels (ops/scores.py): the item table is the propagated
        matrix's item rows."""
        u_g, i_g = self._propagate(aux)
        return u_g[u], i_g, None


class NGCF(_GraphModel):
    name = "NGCF"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        self.message_dropout = cfg.float("message_dropout", 0.1)
        d = self.embed_size
        for lid in range(self.n_layers):
            for name, shape in (("W1", (d, d)), ("b1", (d,)), ("W2", (d, d)),
                                ("b2", (d,))):
                self.register_parameter(f"{name}_{lid}",
                                        nn.Parameter(torch.zeros(shape)))

    def _propagate(self, aux: Aux, dropout_gen=None):
        ego = torch.cat([self.P, self.Q], dim=0)
        outs = [ego]
        p = self.message_dropout
        for lid in range(self.n_layers):
            w1, b1, w2, b2 = (getattr(self, f"{n}_{lid}")
                              for n in ("W1", "b1", "W2", "b2"))
            agg = _adj_apply(aux, ego)
            side = (agg + ego) @ w1 + b1
            inter = (agg * ego) @ w2 + b2
            ego = torch.nn.functional.leaky_relu(side + inter, 0.2)
            if dropout_gen is not None and p > 0:
                keep = torch.rand(ego.shape, generator=dropout_gen,
                                  device=ego.device) < 1.0 - p
                ego = torch.where(keep, ego / (1.0 - p),
                                  torch.zeros_like(ego))
            norm = torch.rsqrt(torch.sum(ego * ego, dim=1, keepdim=True)
                               + 1e-12)
            outs.append(ego * norm)
        return self._split(torch.cat(outs, dim=1))

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        u_g, i_g = self._propagate(aux, batch.get("dropout_gen"))
        ue = gather_rows(u_g, batch["u"])
        ie, je = gather_rows(i_g, batch["i"]), gather_rows(i_g, batch["j"])
        s_i = (ue * ie).sum(dim=1)
        s_j = (ue * je).sum(dim=1)
        wc = w[:, None]
        reg = l2_loss(ue * wc) + l2_loss(ie * wc) + l2_loss(je * wc)
        return bpr_loss(s_i - s_j, weight=w) + self.reg * reg
