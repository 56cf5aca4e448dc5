"""Social-diffusion models: DiffNet, DiffNet++ and LR_GCCF (as
``cleverrec_tpu/models/diffnet.py``).

- DiffNet (Wu et al., SIGIR'19): layer-wise social diffusion of the user
  embeddings, h^(l+1) = sigmoid([mean_{v in S(u)} h^l_v ; h^l_u] W_l
  + b_l); the final user vector is h^L plus the mean of the user's
  consumed item rows; inner-product scores, a pairwise loss with L2 on
  the batch's ego rows.  It has no dot decomposition (nor has the JAX
  model), so it evaluates on ``full`` and serves ``dense``.
- DiffNet++ (Wu et al., TKDE'20): the social and the interest diffusion
  of the users, fused per layer by a two-way softmax gate, and the items
  aggregating from their consumers; both layer-(l+1) updates read the
  layer-l embeddings (the item update reads the PRE-update user rows).
  It keeps DiffNet's ``W_l`` and ``b_l``, which it never reads: they get
  a zero gradient and Adam leaves them as they are, as under optax.
- LR_GCCF (Chen et al., AAAI'20): LightGCN's propagation with the L + 1
  layer outputs concatenated in place of their mean; everything else,
  the dot decomposition included, is LightGCN's (gcn.py).

The mean edges a <- b carry the weight 1/deg(a) and are built in numpy
(float64, then float32) over the social pairs and over the train pairs,
duplicates included; each aggregation gathers the edges' rows and sums
them into their segments with ``index_add``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cleverrec_tpu_torch.common import init_param, l2_loss, pairwise_loss
from cleverrec_tpu_torch.data.social import flatten_friend_edges
from cleverrec_tpu_torch.models.base import Aux, RecModel
from cleverrec_tpu_torch.models.gcn import LightGCN, _adj_apply
from cleverrec_tpu_torch.models.modules import edge_sum, gather_rows


def _mean_edges(pairs_a, pairs_b, n_a):
    """Row-normalised aggregation edges a <- b: weights 1/deg(a)."""
    deg = np.zeros(n_a)
    np.add.at(deg, pairs_a, 1.0)
    w = 1.0 / np.maximum(deg[pairs_a], 1.0)
    return (pairs_a.astype(np.int32), pairs_b.astype(np.int32),
            w.astype(np.float32))


def _edges(aux: Aux, prefix: str):
    """(rows, cols, weights) of the mean edges ``prefix`` in ``aux``."""
    return aux[f"{prefix}_row"], aux[f"{prefix}_col"], aux[f"{prefix}_w"]


class DiffNet(RecModel):
    name = "DiffNet"
    sampler = "pairwise"
    loss_parts = RecModel.rows_only_parts

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg")
        self.embed_size = d = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self.n_layers = cfg.int("n_layers", 2)
        self.P = nn.Parameter(torch.zeros(meta.user_nums, d))
        self.Q = nn.Parameter(torch.zeros(meta.item_nums, d))
        for lid in range(self.n_layers):
            self.register_parameter(f"W_{lid}",
                                    nn.Parameter(torch.zeros(2 * d, d)))
            self.register_parameter(f"b_{lid}", nn.Parameter(torch.zeros(d)))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            p.copy_(init_param(generator, self.initializer, p.shape))

    def build_aux(self, dd, data) -> dict:
        if data.user_friends is None:
            raise ValueError(f"{self.name} requires social_file")
        sf_u, sf_v = flatten_friend_edges(data.user_friends)
        s_row, s_col, s_w = _mean_edges(sf_u.astype(np.int64),
                                        sf_v.astype(np.int64),
                                        self.meta.user_nums)
        # The consumed-item mean edges u <- i.
        r_row, r_col, r_w = _mean_edges(dd.pos_u.astype(np.int64),
                                        dd.pos_i.astype(np.int64),
                                        self.meta.user_nums)
        return {"s_row": s_row, "s_col": s_col, "s_w": s_w,
                "r_row": r_row, "r_col": r_col, "r_w": r_w}

    def _propagate(self, aux: Aux):
        """(user rows, item rows) the scores are taken over."""
        users = self.meta.user_nums
        h = self.P
        for lid in range(self.n_layers):
            social = edge_sum(h, *_edges(aux, "s"), users)
            h = torch.sigmoid(torch.cat([social, h], dim=1)
                              @ getattr(self, f"W_{lid}")
                              + getattr(self, f"b_{lid}"))
        return h + edge_sum(self.Q, *_edges(aux, "r"), users), self.Q

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        hu, hi = self._propagate(aux)
        ue = gather_rows(hu, batch["u"])
        s_i = (ue * gather_rows(hi, batch["i"])).sum(dim=1)
        s_j = (ue * gather_rows(hi, batch["j"])).sum(dim=1)
        main = pairwise_loss(self.loss_func, s_i - s_j, weight=w)
        wc = w[:, None]
        reg = (l2_loss(gather_rows(self.P, batch["u"]) * wc)
               + l2_loss(gather_rows(self.Q, batch["i"]) * wc)
               + l2_loss(gather_rows(self.Q, batch["j"]) * wc))
        return main + self.reg * reg

    def score_pairs(self, u, i, aux: Aux):
        hu, hi = self._propagate(aux)
        return (hu[u] * hi[i]).sum(dim=1)

    def score_candidates(self, u, cand, aux: Aux):
        hu, hi = self._propagate(aux)
        return torch.einsum("bd,bcd->bc", hu[u], hi[cand])

    def score_all(self, u, aux: Aux):
        hu, hi = self._propagate(aux)
        return hu[u] @ hi.T


class DiffNetPlusPlus(DiffNet):
    name = "DiffNetPlusPlus"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        # The two-way fusion gate of each layer (social, interest).
        for lid in range(self.n_layers):
            self.register_parameter(f"gate_{lid}",
                                    nn.Parameter(torch.zeros(2)))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        super().init(generator)
        for lid in range(self.n_layers):
            getattr(self, f"gate_{lid}").zero_()

    def build_aux(self, dd, data) -> dict:
        aux = super().build_aux(dd, data)
        # The item <- consumer mean edges of the interest diffusion.
        i_row, i_col, i_w = _mean_edges(dd.pos_i.astype(np.int64),
                                        dd.pos_u.astype(np.int64),
                                        self.meta.item_nums)
        aux.update({"i_row": i_row, "i_col": i_col, "i_w": i_w})
        return aux

    def _propagate(self, aux: Aux):
        users, items = self.meta.user_nums, self.meta.item_nums
        hu, hi = self.P, self.Q
        for lid in range(self.n_layers):
            social = edge_sum(hu, *_edges(aux, "s"), users)
            interest = edge_sum(hi, *_edges(aux, "r"), users)
            g = torch.softmax(getattr(self, f"gate_{lid}"), dim=0)
            hi = hi + edge_sum(hu, *_edges(aux, "i"), items)
            hu = hu + g[0] * social + g[1] * interest
        return hu, hi


class LR_GCCF(LightGCN):
    """Linear residual GCN: LightGCN's propagation, the layer outputs
    concatenated in place of their mean."""

    name = "LR_GCCF"

    def _propagate(self, aux: Aux):
        ego = torch.cat([self.P, self.Q], dim=0)
        outs = [ego]
        for _ in range(self.n_layers):
            ego = _adj_apply(aux, ego)
            outs.append(ego)
        return self._split(torch.cat(outs, dim=1))
