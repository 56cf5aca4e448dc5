"""Graph-attention social models: RML_DGATs and SoHRML (as
``cleverrec_tpu/models/graph.py``).

Both are dual-domain metric learners (``cml_like``: a squared distance,
lower is better): hinge losses over item-domain (u, i, j) and
social-domain (u_s, v, w_neg) rows, loss_i + gamma * loss_s plus the
neighbourhood and distance regularisers (``_domain_losses``).  The
trainer's ``dual`` protocol splits both domains into ``train_batches``
slices an epoch, consumed together.

- RML_DGATs: one GAT layer over FIXED-width neighbour tables drawn once
  a run with numpy's ``default_rng(seed)`` in the JAX call order (so the
  tables equal the JAX package's): a user's items, an item's users, a
  user's friends, each padded with the sentinel id (the table's last
  row).  The self node is appended to every neighbour list.  Sentinel
  neighbours are zeroed but not masked out of the softmax: they keep
  their logit (0 for att_type 0 and 1, relu(b) . h for att_type 2), as
  in the JAX model.  att_type 2 drops the attention MLP's pre-activation
  at keep 0.7 in training, from the trainer's dropout generator.
- SoHRML: a multi-layer GAT over the whole (A + I) bipartite graph and
  the (T + I) social graph as COO edge lists, whose edge attention
  (``att_i``, ``att_s``) the trainer refreshes before each epoch
  (``pre_epoch``: edge scores from the current embeddings, then a row
  softmax).  The attention is a constant of the loss; node dropout on
  the edge attention and message dropout after each layer, training
  only, from the trainer's dropout generator.

Relation vectors: the elementwise product (``mlp_type`` 0) or a ReLU
tower over the concatenation, its operands broadcast explicitly first.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.functional import leaky_relu

from cleverrec_tpu_torch.common import init_param, pairwise_loss
from cleverrec_tpu_torch.data.social import flatten_friend_edges
from cleverrec_tpu_torch.models.base import Aux, RecModel
from cleverrec_tpu_torch.models.modules import (edge_sum, gather_rows,
                                                relu_mlp_logits, sq_dist)
from cleverrec_tpu_torch.sampling import build_member_table

# RML_DGATs' att_type-2 dropout keeps this share of the pre-activations.
GAT_KEEP = 0.7
# Candidates a chunk in RML_DGATs' candidate scoring.
CAND_CHUNK = 16


def _social_arrays(user_friends, user_nums):
    """Flat friend pairs and the friends' table the w-negatives avoid."""
    sf_u, sf_v = flatten_friend_edges(user_friends)
    return sf_u, sf_v, build_member_table(user_friends, user_nums, user_nums)


def _uniform_row_values(rows, n_rows) -> np.ndarray:
    """Per-edge 1/deg(row): the uniform row softmax over an edge list."""
    deg = np.zeros(n_rows)
    np.add.at(deg, rows, 1.0)
    return (1.0 / np.maximum(deg[rows], 1.0)).astype(np.float32)


def _sample_fixed_neighbors(sets: dict[int, list[int]], n_entities: int,
                            width: int, sentinel: int,
                            rng: np.random.Generator) -> np.ndarray:
    """Fixed-width neighbour table: a sample without replacement where a
    list is longer, sentinel padding where it is shorter."""
    out = np.full((n_entities, width), sentinel, dtype=np.int32)
    for e, ids in sets.items():
        if len(ids) > width:
            out[e] = rng.choice(ids, size=width, replace=False)
        else:
            out[e, : len(ids)] = ids
    return out


def _dropout(x: torch.Tensor, keep: float, gen) -> torch.Tensor:
    """Inverted dropout at keep share ``keep``: kept entries scaled by
    1/keep, the rest 0."""
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class _DualDomainBase(RecModel):
    sampler = "dual"
    cml_like = True

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "atten_size", "gamma", "reg1", "reg2",
                    "margin", "att_type", "mlp_type", "train_batches")
        self.embed_size = cfg.int("embed_size")
        self.atten_size = cfg.int("atten_size")
        self.gamma = cfg.float("gamma")
        self.reg1 = cfg.float("reg1")
        self.reg2 = cfg.float("reg2")
        self.margin = cfg.float("margin")
        self.att_type = cfg.int("att_type")
        self.mlp_type = cfg.int("mlp_type")
        self.train_batches = cfg.int("train_batches")

    def _mlp_param_shapes(self) -> dict[str, tuple[int, ...]]:
        shapes = {}
        d = self.embed_size
        for lid in range(self.mlp_type):
            w = min(self.mlp_type - lid, 2) * d
            in_w = 2 * d if lid == 0 else min(self.mlp_type - lid + 1, 2) * d
            shapes[f"W_mlp_{lid}"] = (in_w, w)
            shapes[f"b_mlp_{lid}"] = (w,)
        return shapes

    def _register(self, shapes: dict[str, tuple[int, ...]]) -> None:
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            p.copy_(init_param(generator, self.initializer, p.shape))

    def _relation(self, a, b):
        """mlp_type 0: the elementwise product; else a ReLU tower over the
        concatenation, the operands broadcast to one shape first (eval
        passes [B, 1, d] against [B, C, d])."""
        if self.mlp_type == 0:
            return a * b
        a, b = torch.broadcast_tensors(a, b)
        x = torch.cat([a, b], dim=-1)
        for lid in range(self.mlp_type):
            x = torch.relu(x @ getattr(self, f"W_mlp_{lid}")
                           + getattr(self, f"b_mlp_{lid}"))
        return x

    def loss_parts(self, batch, aux: Aux):
        """(the loss, 0): a row sum over both domains' rows.  The dual
        tier runs whole steps on every rank (the JAX trainer's replicated
        program), and its two domains' rows, of two batch sizes, do not
        split as one batch: a data chunk raises."""
        if "chunk" in batch:
            raise ValueError(f"{self.name}: the dual tier runs whole steps; "
                             "its batch does not split over 'data'")
        return self.rows_only_parts(batch, aux)

    def _domain_losses(self, batch, ue_i, ie, je, un_i, in_, jn,
                       ue_s, ve, we, un_s, vn, wn):
        w_i, w_s = batch["w"], batch["w_s"]
        d_ui = sq_dist(ue_i + self._relation(un_i, in_), ie)
        d_uj = sq_dist(ue_i + self._relation(un_i, jn), je)
        d_uv = sq_dist(ue_s + self._relation(un_s, vn), ve)
        d_uw = sq_dist(ue_s + self._relation(un_s, wn), we)
        loss_i = pairwise_loss(self.loss_func, d_ui - d_uj,
                               margin=self.margin, weight=w_i)
        loss_s = pairwise_loss(self.loss_func, d_uv - d_uw,
                               margin=self.margin, weight=w_s)
        wc_i, wc_s = w_i[:, None], w_s[:, None]
        reg_nbr = (torch.sum(torch.square((ue_i - un_i) * wc_i))
                   + torch.sum(torch.square((ie - in_) * wc_i))
                   + torch.sum(torch.square((ue_s - un_s) * wc_s))
                   + torch.sum(torch.square((ve - vn) * wc_s)))
        reg_dist = (torch.sum(torch.square((d_ui + self.margin - d_uj) * w_i))
                    + torch.sum(torch.square((d_uv + self.margin - d_uw)
                                             * w_s)))
        return (loss_i + self.gamma * loss_s
                + self.reg1 * reg_nbr + self.reg2 * reg_dist)


class RML_DGATs(_DualDomainBase):
    name = "RML_DGATs"
    SCORE_ALL_CHUNK = 512

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("max_i", "max_s")
        self.max_i = cfg.int("max_i")
        self.max_s = cfg.int("max_s")
        d, a = self.embed_size, self.atten_size
        self._register({"P": (meta.user_nums + 1, d),
                        "Q": (meta.item_nums + 1, d), "W": (2 * d, a),
                        "h": (a,), "b": (a,), "W_gat": (d, d),
                        **self._mlp_param_shapes()})

    def build_aux(self, dd, data) -> dict:
        if data.user_friends is None:
            raise ValueError("RML_DGATs requires social_file")
        rng = np.random.default_rng(self.cfg.seed)
        u, i = self.meta.user_nums, self.meta.item_nums
        iu: dict[int, list[int]] = {}
        for uu, items in data.ui_train.items():
            for it in items:
                iu.setdefault(it, []).append(uu)
        u_hist_max = max((len(v) for v in data.ui_train.values()), default=1)
        i_hist_max = max((len(v) for v in iu.values()), default=1)
        s_max = max((len(v) for v in data.user_friends.values()), default=1)
        w_ui = self.max_i if 0 < self.max_i < u_hist_max else u_hist_max
        w_iu = self.max_i if 0 < self.max_i < i_hist_max else i_hist_max
        w_s = self.max_s if 0 < self.max_s < s_max else s_max
        sf_u, sf_v, friends_tbl = _social_arrays(data.user_friends, u)
        return {
            "user_nbrs_i": _sample_fixed_neighbors(data.ui_train, u, w_ui,
                                                   i, rng),
            "item_nbrs": _sample_fixed_neighbors(iu, i, w_iu, u, rng),
            "user_nbrs_s": _sample_fixed_neighbors(data.user_friends, u,
                                                   w_s, u, rng),
            "sf_u": sf_u, "sf_v": sf_v, "friends_tbl": friends_tbl,
        }

    def _gat(self, nbr_table, idx, own, sentinel, embed, dropout_gen=None):
        """One neighbour-attention layer and the GAT transform: own [B, d]
        attends over its neighbours' rows of ``embed`` and itself."""
        nbrs = nbr_table[idx.long()]                        # [B, n]
        exists = (nbrs != sentinel).to(own.dtype)
        ne = gather_rows(embed, nbrs) * exists[:, :, None]  # [B, n, d]
        ne = torch.cat([ne, own[:, None, :]], dim=1)
        if self.att_type == 0:
            logits = torch.einsum("bd,bnd->bn", own, ne)
        elif self.att_type == 1:
            logits = torch.relu(torch.einsum("bd,bnd->bn", own, ne))
        else:
            x = torch.cat([own[:, None, :].expand_as(ne), ne], dim=-1)
            pre = x @ self.W + self.b
            if dropout_gen is not None:
                pre = _dropout(pre, GAT_KEEP, dropout_gen)
            logits = torch.relu(pre) @ self.h
        att = torch.softmax(logits, dim=1)
        return leaky_relu(torch.einsum("bn,bnd->bd", att, ne) @ self.W_gat)

    def _user_gat(self, aux, u, dropout_gen=None):
        return self._gat(aux["user_nbrs_i"], u, gather_rows(self.P, u),
                         self.meta.item_nums, self.Q, dropout_gen)

    def _item_gat(self, aux, i, dropout_gen=None):
        return self._gat(aux["item_nbrs"], i, gather_rows(self.Q, i),
                         self.meta.user_nums, self.P, dropout_gen)

    def _friend_gat(self, aux, u, dropout_gen=None):
        return self._gat(aux["user_nbrs_s"], u, gather_rows(self.P, u),
                         self.meta.user_nums, self.P, dropout_gen)

    def loss(self, batch, aux: Aux):
        gen = batch.get("dropout_gen")
        u, i, j = batch["u"], batch["i"], batch["j"]
        us, v, w = batch["u_s"], batch["v"], batch["w_neg"]
        P, Q = self.P, self.Q
        return self._domain_losses(
            batch, gather_rows(P, u), gather_rows(Q, i), gather_rows(Q, j),
            self._user_gat(aux, u, gen), self._item_gat(aux, i, gen),
            self._item_gat(aux, j, gen), gather_rows(P, us),
            gather_rows(P, v), gather_rows(P, w),
            self._friend_gat(aux, us, gen), self._friend_gat(aux, v, gen),
            self._friend_gat(aux, w, gen))

    def score_pairs(self, u, i, aux: Aux):
        r = self._relation(self._user_gat(aux, u), self._item_gat(aux, i))
        return sq_dist(gather_rows(self.P, u) + r, gather_rows(self.Q, i))

    def score_candidates(self, u, cand, aux: Aux):
        """The user-side GAT once a user, the candidates' item GATs in
        chunks of ``CAND_CHUNK`` a user."""
        un_i, pu = self._user_gat(aux, u), gather_rows(self.P, u)
        b = cand.shape[0]
        out = []
        for chunk in cand.split(CAND_CHUNK, dim=1):
            cc = chunk.shape[1]
            flat = chunk.reshape(-1)
            r = self._relation(un_i.repeat_interleave(cc, dim=0),
                               self._item_gat(aux, flat))
            out.append(sq_dist(pu.repeat_interleave(cc, dim=0) + r,
                               gather_rows(self.Q, flat)).reshape(b, cc))
        return torch.cat(out, dim=1)


class SoHRML(_DualDomainBase):
    name = "SoHRML"
    # [B, chunk, d] relation intermediates in score_all.
    SCORE_ALL_CHUNK = 512

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("gat_layer_nums", "node_dropout", "message_dropout",
                    "max_i", "max_s")
        self.gat_layers = cfg.int("gat_layer_nums")
        self.node_dropout = cfg.float("node_dropout")
        self.message_dropout = cfg.float("message_dropout")
        self.max_i = cfg.int("max_i")
        self.max_s = cfg.int("max_s")
        d, a = self.embed_size, self.atten_size
        shapes = {"P": (meta.user_nums, d), "Q": (meta.item_nums, d),
                  "W": (2 * d, a), "h": (a,), "b": (a,)}
        for lid in range(self.gat_layers):
            shapes[f"W_gat_{lid}"] = (d, d)
            shapes[f"b_gat_{lid}"] = (d,)
        self._register({**shapes, **self._mlp_param_shapes()})

    def build_aux(self, dd, data) -> dict:
        if data.user_friends is None:
            raise ValueError("SoHRML requires social_file")
        rng = np.random.default_rng(self.cfg.seed)
        U, I = self.meta.user_nums, self.meta.item_nums
        # The item domain over U + I nodes: user -> item, item -> user
        # (each list a sample of max_i when longer), then self loops.
        rows_i, cols_i = [], []
        iu: dict[int, list[int]] = {}
        for u, items in data.ui_train.items():
            for it in items:
                iu.setdefault(it, []).append(u)
            sel = (rng.choice(items, self.max_i, replace=False)
                   if 0 < self.max_i < len(items) else items)
            rows_i += [u] * len(sel)
            cols_i += [U + it for it in sel]
        for it, users in iu.items():
            sel = (rng.choice(users, self.max_i, replace=False)
                   if 0 < self.max_i < len(users) else users)
            rows_i += [U + it] * len(sel)
            cols_i += list(sel)
        rows_i += range(U + I)
        cols_i += range(U + I)
        # The social domain over U nodes, then self loops.
        rows_s, cols_s = [], []
        for u, friends in data.user_friends.items():
            sel = (rng.choice(friends, self.max_s, replace=False)
                   if 0 < self.max_s < len(friends) else friends)
            rows_s += [u] * len(sel)
            cols_s += list(sel)
        rows_s += range(U)
        cols_s += range(U)
        sf_u, sf_v, friends_tbl = _social_arrays(data.user_friends, U)
        return {
            "friends_tbl": friends_tbl,
            "adj_i_row": np.asarray(rows_i, np.int32),
            "adj_i_col": np.asarray(cols_i, np.int32),
            "adj_s_row": np.asarray(rows_s, np.int32),
            "adj_s_col": np.asarray(cols_s, np.int32),
            # The uniform row softmax until the first pre_epoch.
            "att_i": _uniform_row_values(rows_i, U + I),
            "att_s": _uniform_row_values(rows_s, U),
            "sf_u": sf_u, "sf_v": sf_v,
        }

    def pre_epoch(self, aux: Aux) -> dict[str, torch.Tensor]:
        """The edge attention of the current embeddings: each edge's score,
        then a softmax over each row's edges; the trainer calls it before
        each epoch and puts the result into its aux."""
        U, I = self.meta.user_nums, self.meta.item_nums
        ego_i = torch.cat([self.P, self.Q], dim=0)
        rows_i, rows_s = aux["adj_i_row"].long(), aux["adj_s_row"].long()
        scores_i = self._edge_scores(ego_i, rows_i, aux["adj_i_col"].long())
        scores_s = self._edge_scores(self.P, rows_s,
                                     aux["adj_s_col"].long())
        return {"att_i": self._row_softmax(scores_i, rows_i, U + I),
                "att_s": self._row_softmax(scores_s, rows_s, U)}

    def _edge_scores(self, embed, rows, cols):
        re, ce = embed[rows], embed[cols]
        if self.att_type == 0:
            return torch.sum(re * ce, dim=1)
        if self.att_type == 1:
            return torch.relu(torch.sum(re * ce, dim=1))
        return relu_mlp_logits(torch.cat([re, ce], dim=1), self.W, self.b,
                               self.h)

    @staticmethod
    def _row_softmax(scores, rows, n_rows):
        """Softmax over each row's edges; every row has its self loop, so
        no row is empty."""
        m = scores.new_full((n_rows,), -torch.inf).scatter_reduce(
            0, rows, scores, "amax", include_self=False)
        e = torch.exp(scores - m[rows])
        denom = scores.new_zeros(n_rows).index_add(0, rows, e)
        return e / torch.clamp(denom[rows], min=1e-30)

    def _propagate(self, aux: Aux, dropout_gen=None):
        """(user rows, item rows, social user rows) after ``gat_layers``
        attentive layers over both graphs."""
        U, I = self.meta.user_nums, self.meta.item_nums
        ego_i = torch.cat([self.P, self.Q], dim=0)
        ego_s = self.P
        att_i, att_s = aux["att_i"], aux["att_s"]
        if dropout_gen is not None and self.node_dropout > 0:
            keep = 1.0 - self.node_dropout
            att_i = _dropout(att_i, keep, dropout_gen)
            att_s = _dropout(att_s, keep, dropout_gen)
        for lid in range(self.gat_layers):
            agg_i = edge_sum(ego_i, aux["adj_i_row"], aux["adj_i_col"],
                             att_i, U + I)
            agg_s = edge_sum(ego_s, aux["adj_s_row"], aux["adj_s_col"],
                             att_s, U)
            w, b = (getattr(self, f"W_gat_{lid}"),
                    getattr(self, f"b_gat_{lid}"))
            ego_i = leaky_relu(agg_i @ w + b)
            ego_s = leaky_relu(agg_s @ w + b)
            if dropout_gen is not None and self.message_dropout > 0:
                keep = 1.0 - self.message_dropout
                ego_i = _dropout(ego_i, keep, dropout_gen)
                ego_s = _dropout(ego_s, keep, dropout_gen)
        return ego_i[:U], ego_i[U:], ego_s

    def loss(self, batch, aux: Aux):
        u_g, i_g, s_g = self._propagate(aux, batch.get("dropout_gen"))
        u, i, j = batch["u"], batch["i"], batch["j"]
        us, v, w = batch["u_s"], batch["v"], batch["w_neg"]
        P, Q = self.P, self.Q
        return self._domain_losses(
            batch, gather_rows(P, u), gather_rows(Q, i), gather_rows(Q, j),
            gather_rows(u_g, u), gather_rows(i_g, i), gather_rows(i_g, j),
            gather_rows(P, us), gather_rows(P, v), gather_rows(P, w),
            gather_rows(s_g, us), gather_rows(s_g, v), gather_rows(s_g, w))

    def score_pairs(self, u, i, aux: Aux):
        u_g, i_g, _ = self._propagate(aux)
        r = self._relation(u_g[u], i_g[i])
        return sq_dist(self.P[u] + r, self.Q[i])

    def score_candidates(self, u, cand, aux: Aux):
        """Propagates once, then scores every candidate."""
        u_g, i_g, _ = self._propagate(aux)
        r = self._relation(u_g[u][:, None, :], i_g[cand])
        return sq_dist(self.P[u][:, None, :] + r, self.Q[cand])

    def score_all(self, u, aux: Aux):
        """Propagates once, then scores the catalog in chunks of
        ``SCORE_ALL_CHUNK`` items (the [B, chunk, d] relation and
        difference would cost d times the [B, I] scores at once)."""
        u_g, i_g, _ = self._propagate(aux)
        ug, pu = u_g[u][:, None, :], self.P[u][:, None, :]
        items = torch.arange(self.meta.item_nums, device=u.device)
        return torch.cat([
            sq_dist(pu + self._relation(ug, i_g[c][None]), self.Q[c][None])
            for c in items.split(self.SCORE_ALL_CHUNK)], dim=1)
