"""Social models: SBPR, TBPR, CUNE_BPR, SAMN and SAMN_single (as
``cleverrec_tpu/models/social.py``).

- SBPR (model/ranking/SBPR.py:41-66): the chain i > social item k >
  negative j; loss = bpr((x_ui - x_uk) / max(suk, 1)) + bpr(x_uk - x_uj)
  + reg * l2 of every gathered embedding and bias, with
  x(u, m) = <P[u], Q[m]> + bias[m]; full-catalog scores are P[u] @ Q^T
  WITHOUT the bias (SBPR.py:62), an asymmetry kept as it is.
- TBPR (CIKM'16, strong and weak ties; the reference's TBPR.py is
  empty): the chain i > strong-tie item s > weak-tie item t > j, three
  bpr links and the same regulariser, over users with both tie classes.
- CUNE_BPR (model/ranking/CUNE_BPR.py:41-66): SBPR's chain over latent
  friends (``data/social.py``), bpr(x_ui - x_uk) +
  bpr((x_uk - x_uj) / (s + 1)) with a learned 0-d scalar s.
- SAMN (model/ranking/SAMN.py:56-107): memory-attended friend vectors
  (key-addressed memory over the normalised joint embeddings of a user
  and each friend), friend-level attention, u_vec = P[u] + u_frien, and
  the pairwise loss over x(u, m) = <u_vec, Q[m]> + i_b[m].  Masked friend
  slots keep their softmax mass in the friend-level attention (their
  logits come from zero rows, h . ReLU(b)) and add zero vectors, as in
  the reference (SAMN.py:77-85).  SAMN_single is the same model: the
  reference's per-user variant computes the same math a user at a time.

Parameters keep the JAX names and shapes: ``P`` [U, d], ``Q`` [I, d],
``bias`` [I + 1] (the last slot is the eval PAD item's and is never
trained) and CUNE_BPR's ``s`` []; SAMN's ``P`` [U + 1, d] (the last row
is the sentinel friend's), ``Q`` [I, d], ``i_b`` [I], ``Key`` [d, mem],
``Mem`` [mem, d], ``W3`` [d, atten], ``b`` and ``h`` [atten].  Each
triple epoch covers only the pairs of users with social positives
(SBPR, CUNE_BPR; utils/sampler.py:105-106) or with both tie classes
(TBPR); SAMN's covers every train pair, in user groups
(``pairwise_grouped``: the trainer's grouped pairwise epoch).

``fused_rows_spec`` describes the fused rows epoch (ops/train.py
``fused_rows_epoch``): the id planes and the table side of each, the
float columns, the dense params, ``pack`` (the model's tables as views
on each side, the item side [Q | bias[:I]] as two tensors, so the epoch
updates them in place and bias[I] passes through), ``row_loss`` (the
model's loss over gathered rows, which the plain version differentiates
with autograd) and ``chain``, the form the CUDA kernel's hand-written
backward takes: which link divides by the float column, which by s + 1,
and reg.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cleverrec_tpu_torch.common import (bpr_loss, init_param, l2_loss,
                                        pairwise_loss)
from cleverrec_tpu_torch.models.base import Aux, RecModel
from cleverrec_tpu_torch.models.modules import gather_rows, relu_mlp_logits
from cleverrec_tpu_torch.sampling import build_csr_lists, build_member_table


def _union_table(ui_train, social_sets, user_nums, item_nums):
    """MemberTable of seen(u) UNION the given social item sets: the
    exclusion set of the social family's negative draw."""
    union = {u: list(items) for u, items in ui_train.items()}
    for sets in social_sets:
        for u, items in sets.items():
            union[u] = union.get(u, []) + list(items)
    return build_member_table(union, user_nums, item_nums)


def _neg_log_sigmoid(x):
    return -torch.nn.functional.logsigmoid(x)


class _SocialTripleBase(RecModel):
    """What SBPR, TBPR and CUNE_BPR share: the tables, the scorers, the
    restricted epoch and the fused rows spec."""

    sampler = "sbpr"
    fused_protocol = "rows"
    item_planes = ("i", "k", "j")
    loss_parts = RecModel.rows_only_parts

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg")
        self.embed_size = d = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self.P = nn.Parameter(torch.zeros(meta.user_nums, d))
        self.Q = nn.Parameter(torch.zeros(meta.item_nums, d))
        self.bias = nn.Parameter(torch.zeros(meta.item_nums + 1))
        self._pairs = None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in (self.P, self.Q):
            p.copy_(init_param(generator, self.initializer, p.shape))
        self.bias.zero_()

    def _keep_users(self, dd, users) -> None:
        """Restrict the epoch's pairs to those of ``users``."""
        has = np.zeros(self.meta.user_nums, bool)
        has[list(users)] = True
        keep = has[dd.pos_u]
        self._pairs = (dd.pos_u[keep], dd.pos_i[keep])

    def _social_aux(self, dd, spu, suk, ui_train) -> dict:
        """SPu as CSR lists with suk, and the seen-union-SPu table of the
        negative draw."""
        self._keep_users(dd, spu)
        meta = self.meta
        return {"spu_csr": build_csr_lists(spu, meta.user_nums, aux=suk),
                "social_neg": _union_table(ui_train, (spu,), meta.user_nums,
                                           meta.item_nums)}

    def epoch_pairs(self, dd):
        if self._pairs is None:
            raise RuntimeError(f"{self.name}: call build_aux first")
        return self._pairs

    # -- scoring --------------------------------------------------------
    def _x(self, ue, idx):
        return (ue * self.Q[idx]).sum(dim=1) + self.bias[idx]

    def _reg_terms(self, batch, w):
        wc = w[:, None]
        terms = 0.0
        for key in self.item_planes:
            idx = batch[key]
            terms = terms + l2_loss(self.Q[idx] * wc) + l2_loss(
                self.bias[idx] * w)
        return terms + l2_loss(self.P[batch["u"]] * wc)

    def score_pairs(self, u, i, aux: Aux):
        return self._x(self.P[u], i)

    def score_all(self, u, aux: Aux):
        # The reference's full-catalog path leaves out the bias (SBPR.py:62).
        return self.P[u] @ self.Q.T

    def dot_decomposition(self, u, aux: Aux):
        """(user_vecs, item_table, None) for the masked dot-scoring
        kernels (ops/scores.py), as ``score_all``: no bias."""
        return self.P[u], self.Q, None

    # -- the fused rows epoch -------------------------------------------
    def _rows_x(self, ue, r):
        """x(u, m) = <P[u], Q[m]> + bias[m] over item rows [Q | bias]."""
        d = self.embed_size
        return (ue * r[:, :d]).sum(dim=1, keepdim=True) + r[:, d:d + 1]

    def _rows_reg(self, ue, item_rows, w):
        d = self.embed_size
        terms = l2_loss(ue * w)
        for r in item_rows:
            terms = terms + l2_loss(r[:, :d] * w) + l2_loss(r[:, d:d + 1] * w)
        return terms

    def _links(self, rows, floats, dense):
        """The chain's link arguments (x_m - x_{m+1}) / divisor, [B, 1]
        each."""
        raise NotImplementedError

    def _chain(self) -> dict:
        raise NotImplementedError

    def fused_rows_spec(self) -> dict:
        """The fused rows epoch's view of the model (see the module
        docstring); ``row_loss(rows, floats, dense, w)`` takes the
        gathered rows [P[u]], [Q | bias] per item plane, the float
        columns and w as [B, 1] columns, and the dense params."""
        reg, n_items = self.reg, self.meta.item_nums
        dense_names = ("s",) if hasattr(self, "s") else ()

        def pack(t):
            return ((t["P"].detach(),),
                    (t["Q"].detach(), t["bias"].detach()[:n_items]),
                    tuple(t[n].detach() for n in dense_names))

        def row_loss(rows, floats, dense, w):
            main = sum(torch.sum(_neg_log_sigmoid(z) * w)
                       for z in self._links(rows, floats, dense))
            return main + reg * self._rows_reg(rows[0], rows[1:], w)

        planes = (("u", "u"),) + tuple((k, "i") for k in self.item_planes)
        return {"planes": planes,
                "floats": ("suk",) if self._chain()["float_link"] is not None
                else (),
                "dense": dense_names, "pack": pack, "row_loss": row_loss,
                "chain": self._chain()}


class SBPR(_SocialTripleBase):
    name = "SBPR"

    def build_aux(self, dd, data) -> dict:
        from cleverrec_tpu_torch.data.social import build_spu
        if data.user_friends is None:
            raise ValueError("SBPR requires social_file")
        spu, suk = build_spu(data.ui_train, data.user_friends)
        return self._social_aux(dd, spu, suk, data.ui_train)

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        ue = self.P[batch["u"]]
        x_ui, x_uk, x_uj = (self._x(ue, batch[k]) for k in ("i", "k", "j"))
        suk = torch.clamp(batch["suk"], min=1.0)
        main = (bpr_loss((x_ui - x_uk) / suk, weight=w)
                + bpr_loss(x_uk - x_uj, weight=w))
        return main + self.reg * self._reg_terms(batch, w)

    def _links(self, rows, floats, dense):
        ue, ri, rk, rj = rows
        x_ui, x_uk, x_uj = (self._rows_x(ue, r) for r in (ri, rk, rj))
        return ((x_ui - x_uk) / torch.clamp(floats[0], min=1.0),
                x_uk - x_uj)

    def _chain(self) -> dict:
        return {"float_link": 0, "dense_link": None, "reg": self.reg}


class TBPR(_SocialTripleBase):
    """TBPR: social recommendation with strong and weak ties (CIKM 2016),
    a fresh implementation from the paper (the reference advertises it,
    README.md:17, but its TBPR.py is empty): ties split by
    neighbourhood overlap (``data/social.py``
    ``build_tie_partitioned_spu``, knob ``strong_ratio``), and

        L = bpr(x_ui - x_us) + bpr(x_us - x_ut) + bpr(x_ut - x_uj) + reg

    over users that have both tie classes."""

    name = "TBPR"
    sampler = "tbpr"
    item_planes = ("i", "s", "t", "j")

    def build_aux(self, dd, data) -> dict:
        from cleverrec_tpu_torch.data.social import build_tie_partitioned_spu
        if data.user_friends is None:
            raise ValueError("TBPR requires social_file")
        strong, weak = build_tie_partitioned_spu(
            data.ui_train, data.user_friends,
            self.cfg.float("strong_ratio", 0.5))
        self._keep_users(dd, set(strong) & set(weak))
        meta = self.meta
        return {"ts_csr": build_csr_lists(strong, meta.user_nums),
                "tw_csr": build_csr_lists(weak, meta.user_nums),
                "social_neg": _union_table(data.ui_train, (strong, weak),
                                           meta.user_nums, meta.item_nums)}

    def _reg_terms(self, batch, w):
        # The JAX TBPR sums the user's term first.
        wc = w[:, None]
        terms = l2_loss(self.P[batch["u"]] * wc)
        for key in self.item_planes:
            idx = batch[key]
            terms = terms + l2_loss(self.Q[idx] * wc) + l2_loss(
                self.bias[idx] * w)
        return terms

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        ue = self.P[batch["u"]]
        x = [self._x(ue, batch[k]) for k in self.item_planes]
        main = sum(bpr_loss(a - b, weight=w) for a, b in zip(x, x[1:]))
        return main + self.reg * self._reg_terms(batch, w)

    def _links(self, rows, floats, dense):
        x = [self._rows_x(rows[0], r) for r in rows[1:]]
        return tuple(a - b for a, b in zip(x, x[1:]))

    def _chain(self) -> dict:
        return {"float_link": None, "dense_link": None, "reg": self.reg}


class CUNE_BPR(_SocialTripleBase):
    name = "CUNE_BPR"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("walk_count", "walk_length", "walk_dim", "window_size",
                    "topk_f")
        self.s = nn.Parameter(torch.zeros(()))   # learned social coefficient

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        super().init(generator)
        self.s.zero_()

    def build_aux(self, dd, data) -> dict:
        """Latent friends from the interactions (no trust file), on the
        device the model's tables are on."""
        from cleverrec_tpu_torch.data.social import build_cune_friends
        cfg = self.cfg
        _, spu, suk = build_cune_friends(
            data.ui_train, self.meta.user_nums, self.meta.item_nums,
            cfg.int("walk_count"), cfg.int("walk_length"),
            cfg.int("walk_dim"), cfg.int("window_size"), cfg.int("topk_f"),
            seed=cfg.seed, device=self.P.device)
        return self._social_aux(dd, spu, suk, data.ui_train)

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        ue = self.P[batch["u"]]
        x_ui, x_uk, x_uj = (self._x(ue, batch[k]) for k in ("i", "k", "j"))
        main = (bpr_loss(x_ui - x_uk, weight=w)
                + bpr_loss((x_uk - x_uj) / (self.s + 1.0), weight=w))
        return main + self.reg * self._reg_terms(batch, w)

    def _links(self, rows, floats, dense):
        ue, ri, rk, rj = rows
        x_ui, x_uk, x_uj = (self._rows_x(ue, r) for r in (ri, rk, rj))
        return x_ui - x_uk, (x_uk - x_uj) / (dense[0] + 1.0)

    def _chain(self) -> dict:
        return {"float_link": None, "dense_link": 1, "reg": self.reg}


class SAMN(RecModel):
    """SAMN (WSDM'19): social attentional memory network, trained on the
    user-grouped pairwise epoch, where the friend attention runs once
    per (user, cell chunk) group instead of once per pair row."""

    name = "SAMN"
    sampler = "pairwise"
    pairwise_grouped = True
    TARGET_CHUNK = 128

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "mem_size", "atten_size", "reg1", "reg2")
        self.embed_size = d = cfg.int("embed_size")
        self.mem_size = m = cfg.int("mem_size")
        self.atten_size = a = cfg.int("atten_size")
        self.reg1 = cfg.float("reg1")
        self.reg2 = cfg.float("reg2")
        self.P = nn.Parameter(torch.zeros(meta.user_nums + 1, d))
        self.Q = nn.Parameter(torch.zeros(meta.item_nums, d))
        self.i_b = nn.Parameter(torch.zeros(meta.item_nums))
        self.Key = nn.Parameter(torch.zeros(d, m))
        self.Mem = nn.Parameter(torch.zeros(m, d))
        self.W3 = nn.Parameter(torch.zeros(d, a))
        self.b = nn.Parameter(torch.zeros(a))
        self.h = nn.Parameter(torch.zeros(a))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            p.copy_(init_param(generator, self.initializer, p.shape))

    def build_aux(self, dd, data) -> dict:
        if dd.friends_padded is None:
            raise ValueError(f"{self.name} requires social_file")
        return {"friends_padded": dd.friends_padded}

    def _user_vec(self, u, aux: Aux):
        """u_vec = P[u] + the attention-weighted memory friend vectors
        (SAMN.py:56-89); rsqrt(|x|^2 + 1e-12) keeps the masked friend
        slots' zero rows finite through the normalisation."""
        friends = aux["friends_padded"][u].long()          # [B, F]
        ue = gather_rows(self.P, u)                        # [B, d]
        exists = (friends != self.meta.user_nums).to(ue.dtype)
        fe = gather_rows(self.P, friends) * exists[:, :, None]  # [B,F,d]
        un = ue * torch.rsqrt(torch.sum(ue * ue, dim=1, keepdim=True)
                              + 1e-12)
        fn = fe * torch.rsqrt(torch.sum(fe * fe, dim=2, keepdim=True)
                              + 1e-12)
        joint = un[:, None, :] * fn
        atten_key = torch.softmax(joint @ self.Key, dim=-1)
        atten_key = atten_key * exists[:, :, None]
        f_vec = (atten_key @ self.Mem) * fe                # [B, F, d]
        att = torch.softmax(relu_mlp_logits(f_vec, self.W3, self.b, self.h),
                            dim=1)                         # [B, F]
        return ue + torch.einsum("bf,bfd->bd", att, f_vec)

    def _tower_l2(self):
        return l2_loss(self.W3) + l2_loss(self.b) + l2_loss(self.h)

    loss = RecModel.summed_parts

    def loss_parts(self, batch, aux: Aux):
        """(the pairwise loss and reg1's L2 over the batch's rows, reg2's
        L2 of the attention tower: a table term)."""
        w = batch["w"]
        uv = self._user_vec(batch["u"], aux)
        ie, je = (gather_rows(self.Q, batch[k]) for k in ("i", "j"))
        ib, jb = (gather_rows(self.i_b, batch[k]) for k in ("i", "j"))
        s_i = torch.sum(uv * ie, dim=1) + ib
        s_j = torch.sum(uv * je, dim=1) + jb
        main = pairwise_loss(self.loss_func, s_i - s_j, weight=w)
        wc = w[:, None]
        l2_1 = (l2_loss(uv * wc) + l2_loss(ie * wc) + l2_loss(je * wc)
                + l2_loss(ib * w) + l2_loss(jb * w))
        return main + self.reg1 * l2_1, self.reg2 * self._tower_l2()

    def loss_grouped_pairwise(self, batch, aux: Aux):
        """The user-grouped pairwise loss: ``gu`` [G] users, ``gi`` and
        ``gj`` [G, T] positive and negative cells, ``gw`` [G, T] their
        validity.  A valid cell (g, t) is one flat pair row, with the
        flat loss's terms (uv's L2 becomes |uv_g|^2 times the group's
        valid-cell count); the friend attention runs once a group.  Pad
        cells hold the id ``item_nums``: they read the last item's row,
        as JAX's clamped gather does, at weight 0."""
        gw = batch["gw"]
        last = self.meta.item_nums - 1
        gi = torch.clamp(batch["gi"], max=last)
        gj = torch.clamp(batch["gj"], max=last)
        uv = self._user_vec(batch["gu"], aux)              # [G, d]
        ie, je = gather_rows(self.Q, gi), gather_rows(self.Q, gj)  # [G,T,d]
        ib, jb = gather_rows(self.i_b, gi), gather_rows(self.i_b, gj)
        s_i = torch.einsum("gd,gtd->gt", uv, ie) + ib
        s_j = torch.einsum("gd,gtd->gt", uv, je) + jb
        main = pairwise_loss(self.loss_func, s_i - s_j, weight=gw)
        wc = gw[..., None]
        l2_1 = (0.5 * torch.sum(torch.sum(uv * uv, dim=1)
                                * torch.sum(gw, dim=1))
                + l2_loss(ie * wc) + l2_loss(je * wc) + l2_loss(ib * gw)
                + l2_loss(jb * gw))
        return main + self.reg1 * l2_1 + self.reg2 * self._tower_l2()

    def score_pairs(self, u, i, aux: Aux):
        uv = self._user_vec(u, aux)
        return torch.sum(uv * self.Q[i], dim=1) + self.i_b[i]

    def score_candidates(self, u, cand, aux: Aux):
        # The friend attention once a user, then one dot a candidate.
        uv = self._user_vec(u, aux)
        return torch.einsum("bd,bcd->bc", uv, self.Q[cand]) + self.i_b[cand]

    def score_all(self, u, aux: Aux):
        return self._user_vec(u, aux) @ self.Q.T + self.i_b[None, :]

    def dot_decomposition(self, u, aux: Aux):
        """(user_vecs, item_table, item_bias) for the masked dot-scoring
        kernels (ops/scores.py)."""
        return self._user_vec(u, aux), self.Q, self.i_b


class SAMNSingle(SAMN):
    """The reference's per-user SAMN variant: the same math, batched."""

    name = "SAMN_single"
