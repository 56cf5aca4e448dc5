"""NCF family: GMF, MLP, NeuMF (WWW'17), as ``cleverrec_tpu/models/ncf.py``.

- GMF  (model/ranking/GMF.py:29-58):  logits = <h_gmf, P[u] * Q[i]>;
  pointwise sigmoid cross-entropy; test scores pass through sigmoid.
- MLP  (model/ranking/MLP.py:29-75):  towers ``layers=[l0, l0/2, ...]``,
  P/Q width l0/2, per-layer W_l [l, l/2] + b_l with ReLU, output h_mlp.
- NeuMF (model/ranking/NeuMF.py:27-110): GMF and MLP embeddings side by
  side, output h_neumf over concat(gmf, mlp).  ``h_gmf`` and ``h_mlp``
  take no part in its loss: they are kept for the warm start from
  pretrained GMF and MLP models (``NeuMF.warm_start``).

Parameters keep the JAX names and shapes: ``W_l`` is [in, out] and is
applied as ``x @ W_l``; biases and output weights are 1-D.

MLP and NeuMF describe their fused pointwise epoch with
``fused_mlp_spec`` (ops/train.py ``fused_mlp_epoch``): the user and item
tables it concatenates on the feature axis, the dense order
W_0..W_{L-1}, b_0..b_{L-1}, h, the width of the GMF branch, its two
regularisers, and ``row_loss``, the model's loss over gathered rows that
the kernel's plain version differentiates with autograd.
"""

from __future__ import annotations

import torch
from torch import nn

from cleverrec_tpu_torch.common import (init_param, l2_loss, sigmoid_xent,
                                        sigmoid_xent_loss)
from cleverrec_tpu_torch.models.base import Aux, RecModel
from cleverrec_tpu_torch.train.checkpoint import graft_neumf, load_params


def mlp_tower(params, x, n_layers: int):
    """relu(x @ W_l + b_l) for l < n_layers; ``params`` maps the JAX
    names to tensors."""
    for lid in range(n_layers):
        x = torch.relu(x @ params[f"W_{lid}"] + params[f"b_{lid}"])
    return x


class _NCFBase(RecModel):
    sampler = "pointwise"
    loss_parts = RecModel.rows_only_parts

    def _param(self, name: str, *shape: int) -> None:
        self.register_parameter(name, nn.Parameter(torch.zeros(*shape)))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            p.copy_(init_param(generator, self.initializer, p.shape))

    def _tower_params(self) -> tuple[str, ...]:
        """Registers W_0, b_0, W_1, b_1, ... (the JAX init order); returns
        the names in the fused spec's order, W_0..W_{L-1}, b_0..b_{L-1}."""
        for lid, width in enumerate(self.layers):
            self._param(f"W_{lid}", width, width // 2)
            self._param(f"b_{lid}", width // 2)
        n_layers = len(self.layers)
        return (tuple(f"W_{lid}" for lid in range(n_layers))
                + tuple(f"b_{lid}" for lid in range(n_layers)))

    def _params(self):
        return dict(self.named_parameters())


class GMF(_NCFBase):
    name = "GMF"
    # {P, Q, h_gmf} elementwise-product form with sigmoid cross-entropy:
    # eligible for the fused pointwise epoch (ops/train.py fused_gmf_epoch).
    fused_protocol = "pointwise_bce"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "reg")
        self.embed_size = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self._param("P", meta.user_nums, self.embed_size)
        self._param("Q", meta.item_nums, self.embed_size)
        self._param("h_gmf", self.embed_size)

    def _logits(self, u, i):
        return (self.P[u] * self.Q[i] * self.h_gmf).sum(dim=1)

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        ue = self.P[batch["u"]] * w[:, None]
        ie = self.Q[batch["i"]] * w[:, None]
        logits = (ue * ie * self.h_gmf).sum(dim=1)
        main = sigmoid_xent_loss(batch["y"], logits, weight=w)
        return main + self.reg * (l2_loss(ue) + l2_loss(ie))

    def score_pairs(self, u, i, aux: Aux):
        return torch.sigmoid(self._logits(u, i))

    def score_all(self, u, aux: Aux):
        return torch.sigmoid((self.P[u] * self.h_gmf) @ self.Q.T)

    def dot_decomposition(self, u, aux: Aux):
        """(user_vecs, item_table, None) for the masked dot-scoring kernels
        (ops/scores.py): sigmoid is monotonic, so ranking the logits
        (P[u] * h) . Q ranks the sigmoid scores."""
        return self.P[u] * self.h_gmf, self.Q, None


class MLP(_NCFBase):
    name = "MLP"
    # Tower objective: eligible for the fused pointwise tower epoch
    # (ops/train.py fused_mlp_epoch).
    fused_protocol = "pointwise_mlp"

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("layers", "reg")
        self.layers = cfg.int_list("layers")
        self.reg = cfg.float("reg")
        half = self.layers[0] // 2
        self._param("P", meta.user_nums, half)
        self._param("Q", meta.item_nums, half)
        self._param("h_mlp", self.layers[-1] // 2)
        self._tower = self._tower_params()

    def fused_mlp_spec(self) -> dict:
        """The fused tower epoch's view of MLP: tables P and Q, no GMF
        branch, ``reg`` on both tables' rows, and ``row_loss`` = MLP.loss
        over gathered rows (y and w as [B, 1] columns)."""
        n_layers, reg = len(self.layers), self.reg

        def row_loss(pe, qe, dense, y, w):
            pe = pe * w
            qe = qe * w
            x = torch.cat([pe, qe], dim=1)
            for lid in range(n_layers):
                x = torch.relu(x @ dense[lid] + dense[n_layers + lid])
            logits = x @ dense[2 * n_layers][:, None]          # [B, 1]
            main = torch.sum(sigmoid_xent(logits, y) * w)
            return main + reg * (l2_loss(pe) + l2_loss(qe))

        return {"u": ("P",), "i": ("Q",), "dense": self._tower + ("h_mlp",),
                "row_loss": row_loss, "gmf_width": 0, "reg_gmf": reg,
                "reg_mlp": reg}

    def _logits(self, ue, ie):
        x = mlp_tower(self._params(), torch.cat([ue, ie], dim=-1),
                      len(self.layers))
        return x @ self.h_mlp

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        ue = self.P[batch["u"]] * w[:, None]
        ie = self.Q[batch["i"]] * w[:, None]
        main = sigmoid_xent_loss(batch["y"], self._logits(ue, ie), weight=w)
        return main + self.reg * (l2_loss(ue) + l2_loss(ie))

    def score_pairs(self, u, i, aux: Aux):
        return torch.sigmoid(self._logits(self.P[u], self.Q[i]))


class NeuMF(_NCFBase):
    name = "NeuMF"
    fused_protocol = "pointwise_mlp"
    # The warm start's checkpoints: both keys set, or neither.
    pretrain_keys = ("gmf_pretrain", "mlp_pretrain")

    def __init__(self, cfg, meta):
        super().__init__(cfg, meta)
        cfg.require("embed_size", "layers", "reg1", "reg2")
        self.embed_size = d = cfg.int("embed_size")
        self.layers = cfg.int_list("layers")
        self.reg1 = cfg.float("reg1")
        self.reg2 = cfg.float("reg2")
        half = self.layers[0] // 2
        self._param("P_gmf", meta.user_nums, d)
        self._param("Q_gmf", meta.item_nums, d)
        self._param("h_gmf", d)
        self._param("P_mlp", meta.user_nums, half)
        self._param("Q_mlp", meta.item_nums, half)
        self._param("h_mlp", self.layers[-1] // 2)
        self._tower = self._tower_params()
        self._param("h_neumf", d + self.layers[-1] // 2)

    def warm_start(self, params: dict, cfg) -> dict:
        """``params`` grafted from the GMF and MLP checkpoints that
        ``gmf_pretrain`` and ``mlp_pretrain`` name."""
        return graft_neumf(params, load_params(cfg.str("gmf_pretrain")),
                           load_params(cfg.str("mlp_pretrain")))

    def fused_mlp_spec(self) -> dict:
        """The fused tower epoch's view of NeuMF: the user tables ride one
        concatenated [U, d + l0/2] gather ([P_gmf | P_mlp]; the same on
        the item side), ``reg1`` on the GMF slices, ``reg2`` on the MLP
        slices, and ``row_loss`` = NeuMF.loss over the split slices."""
        n_layers, d = len(self.layers), self.embed_size
        reg1, reg2 = self.reg1, self.reg2

        def row_loss(pe, qe, dense, y, w):
            pe = pe * w
            qe = qe * w
            ug, um = pe[:, :d], pe[:, d:]
            ig, im = qe[:, :d], qe[:, d:]
            x = torch.cat([um, im], dim=1)
            for lid in range(n_layers):
                x = torch.relu(x @ dense[lid] + dense[n_layers + lid])
            z = torch.cat([ug * ig, x], dim=1)
            logits = z @ dense[2 * n_layers][:, None]          # [B, 1]
            main = torch.sum(sigmoid_xent(logits, y) * w)
            return (main + reg1 * (l2_loss(ug) + l2_loss(ig))
                    + reg2 * (l2_loss(um) + l2_loss(im)))

        return {"u": ("P_gmf", "P_mlp"), "i": ("Q_gmf", "Q_mlp"),
                "dense": self._tower + ("h_neumf",), "row_loss": row_loss,
                "gmf_width": d, "reg_gmf": reg1, "reg_mlp": reg2}

    def _logits(self, ug, ig, um, im):
        y_mlp = mlp_tower(self._params(), torch.cat([um, im], dim=-1),
                          len(self.layers))
        return torch.cat([ug * ig, y_mlp], dim=-1) @ self.h_neumf

    def loss(self, batch, aux: Aux):
        w = batch["w"]
        wcol = w[:, None]
        ug = self.P_gmf[batch["u"]] * wcol
        ig = self.Q_gmf[batch["i"]] * wcol
        um = self.P_mlp[batch["u"]] * wcol
        im = self.Q_mlp[batch["i"]] * wcol
        main = sigmoid_xent_loss(batch["y"], self._logits(ug, ig, um, im),
                                 weight=w)
        return (main + self.reg1 * (l2_loss(ug) + l2_loss(ig))
                + self.reg2 * (l2_loss(um) + l2_loss(im)))

    def score_pairs(self, u, i, aux: Aux):
        return torch.sigmoid(self._logits(self.P_gmf[u], self.Q_gmf[i],
                                          self.P_mlp[u], self.Q_mlp[i]))
