"""Rating prediction: the FM and FFM models and their trainer (as
``cleverrec_tpu/rating.py``).

Math parity with the reference:
- FM (model/rating/FM.py:26-56): y_pre = w0 + sum_i w_i x_i +
  0.5 * sum_f [(sum_i x_i v_if)^2 - sum_i (x_i v_if)^2]; square loss
  (summed, weighted) + reg * (l2(wi) + l2(vif)) over the WHOLE tables;
  padded feature slots contribute zero through x_val = 0.
- Trainer (model/RatingRecommender.py:26-105): shuffled batches each
  epoch, the training RMSE computed from the predictions gathered DURING
  the epoch (parameters moving, as the reference), per-epoch test RMSE and
  MAE, the best epoch the one of lowest test RMSE.

Parameters have the JAX shapes (``w0`` 0-d, ``wi`` [rows], ``vif`` [rows,
d] or, for FFM, [rows, n_fields, d], rows = feature_nums + 1 rounded up to
a multiple of 8), so ``weights.load_params`` carries JAX's parameters
across unchanged.  No kernel is on this path: the JAX package's FM sums
are XLA einsums, here plain PyTorch.

Under a mesh (cleverrec_tpu/rating.py:151-158, :193-203) every leaf with
a leading dim that divides the ``model`` size M is row-sharded over
``model`` once drawn (``wi``, ``vif``; JAX's rule for FM, not the ranking
trainer's: 1-D and 3-D leaves too) and ``w0`` is replicated; each step's
loss and each test read the tables all-gathered
(``sharding.table_views``, ``gspmd``).  A data axis D > 1 splits each
step's batch as the JAX trainer's batch constraint does: each data rank
keeps its chunk of the step's rows (``x_idx``, ``x_val``, ``y`` and
``w``; ``torch.tensor_split``, uneven chunks too), its part of the loss
is the square loss over them plus, on data rank 0 alone, the L2 table
term (``FM.loss_parts``), and one all-reduce a step sums the parts'
gradients and losses over ``data`` (``sharding.over_data``); each
rank's predictions are all-gathered in row order after the epoch, where
the training RMSE reads them.  The ranks of a model group take one
gradient of ``w0`` (``sharding.agree_grads``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from cleverrec_tpu_torch.common import (cdiv, init_param, l2_loss,
                                        make_initializer, make_optimizer)
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data.libfm import RatingData, load_rating_data
from cleverrec_tpu_torch.metrics import rmse_mae
from cleverrec_tpu_torch.parallel import sharding
from cleverrec_tpu_torch.parallel.mesh import mesh_device


class FM(nn.Module):
    name = "FM"

    def __init__(self, cfg: Config, feature_nums: int):
        super().__init__()
        cfg.require("embed_size", "reg")
        self.cfg = cfg
        self.embed_size = cfg.int("embed_size")
        self.reg = cfg.float("reg")
        self.feature_nums = feature_nums
        self.initializer = make_initializer(cfg.init_method, cfg.stddev)
        rows = self._table_rows()
        self.w0 = nn.Parameter(torch.zeros(()))
        self.wi = nn.Parameter(torch.zeros(rows))
        self.vif = nn.Parameter(torch.zeros(self._vif_shape(rows)))

    def _table_rows(self) -> int:
        """feature_nums + 1 pad row, rounded up to a multiple of 8 (the JAX
        shape); the extra rows are zero and never addressed."""
        f = self.feature_nums + 1
        return ((f + 7) // 8) * 8

    def _vif_shape(self, rows: int) -> tuple:
        return (rows, self.embed_size)

    def _draw_vif(self, generator: torch.Generator, rows: int):
        return init_param(generator, self.initializer, (rows, self.embed_size))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """w0 zero, wi then vif drawn from ``generator``; rows past the pad
        row (feature_nums) zero."""
        rows, live = self._table_rows(), self.feature_nums + 1
        wi = init_param(generator, self.initializer, (rows,))
        vif = self._draw_vif(generator, rows)
        wi[live:] = 0.0
        vif[live:] = 0.0
        self.w0.zero_()
        self.wi.copy_(wi)
        self.vif.copy_(vif)

    def predict(self, x_idx, x_val):
        wi = self.wi[x_idx] * x_val                          # [B, F]
        v = self.vif[x_idx] * x_val[:, :, None]              # [B, F, d]
        sum_sq = torch.square(v.sum(dim=1))                  # [B, d]
        sq_sum = torch.square(v).sum(dim=1)                  # [B, d]
        y2 = (sum_sq - sq_sum).sum(dim=1)
        return self.w0 + wi.sum(dim=1) + 0.5 * y2

    def loss_parts(self, x_idx, x_val, y, w):
        """(the summed weighted square loss over the rows, reg * (l2(wi) +
        l2(vif)) over the whole tables: a table term, y_pre)."""
        y_pre = self.predict(x_idx, x_val)
        main = torch.sum(torch.square(y - y_pre) * w)
        return main, self.reg * (l2_loss(self.wi) + l2_loss(self.vif)), y_pre

    def loss(self, x_idx, x_val, y, w):
        """(summed weighted square loss + reg * (l2(wi) + l2(vif)), y_pre)."""
        rows, tables, y_pre = self.loss_parts(x_idx, x_val, y, w)
        return rows + tables, y_pre


class FFM(FM):
    """Field-aware Factorization Machine (Juan et al., RecSys'16), as the
    JAX package's: each feature owns one latent vector PER FIELD, and with
    libFM input a column's field is its position, clamped to the last
    field: y = w0 + sum_i w_i x_i +
    sum_{a<b} <v[x_a, field_b], v[x_b, field_a]> x_a x_b."""

    name = "FFM"

    def __init__(self, cfg: Config, feature_nums: int, n_fields: int):
        self.n_fields = n_fields
        super().__init__(cfg, feature_nums)

    def _vif_shape(self, rows: int) -> tuple:
        return (rows, self.n_fields, self.embed_size)

    def _draw_vif(self, generator: torch.Generator, rows: int):
        # Drawn as [rows, fields * d] (its fans), as the JAX package.
        return self.initializer(
            generator, (rows, self.n_fields * self.embed_size)).reshape(
                rows, self.n_fields, self.embed_size)

    def predict(self, x_idx, x_val):
        wi = self.wi[x_idx] * x_val                              # [B, F]
        out = self.w0 + wi.sum(dim=1)
        n_pos = x_idx.shape[1]
        v = self.vif[x_idx] * x_val[:, :, None, None]           # [B,F,G,d]
        # Positions grouped by field: T[g, h] = sum_{a: f(a)=g} v_a[h], and
        #   sum_{a<b} <v_a[f(b)], v_b[f(a)]>
        #     = (sum_{g,h} <T[g,h], T[h,g]> - sum_a |v_a[f(a)]|^2) / 2.
        f_pos = torch.arange(n_pos, device=v.device).clamp(
            max=self.n_fields - 1)
        onehot = torch.eye(self.n_fields, device=v.device)[f_pos]  # [F, G]
        t = torch.einsum("ag,bahd->bghd", onehot, v)
        full = torch.einsum("bghd,bhgd->b", t, t)
        v_diag = v[:, torch.arange(n_pos, device=v.device), f_pos, :]
        diag = (v_diag * v_diag).sum(dim=(1, 2))
        return out + 0.5 * (full - diag)


_RATING_MODELS = {"FM": FM, "FFM": FFM}


def fm_row_sharded(model: FM, mesh) -> list[str]:
    """The leaves JAX's FMTrainer places on ``model``: every leaf with
    ndim >= 1 whose leading dim divides the model axis (none at M 1)."""
    if mesh is None or mesh.shape["model"] == 1:
        return []
    sharding.unshard_model(model)
    return [n for n, p in model.named_parameters()
            if p.ndim >= 1 and p.shape[0] % mesh.shape["model"] == 0]


class FMTrainer:
    """Trains ``model`` on ``data`` on ``device`` (default ``cuda``; the
    model is moved there), or on ``mesh``'s device, which ``device`` may
    name but not contradict."""

    def __init__(self, model: FM, data: RatingData, cfg: Config, logger=None,
                 device=None, mesh=None):
        self.mesh = mesh
        self.device = mesh_device(device, mesh)
        self.model = model.to(self.device)
        self._row_names = fm_row_sharded(model, mesh)
        self.data = data
        self.cfg = cfg
        self.logger = logger
        self.optimizer = make_optimizer(cfg.optimizer, cfg.lr)
        self.batch_size = cfg.batch_size
        self._n = len(data.y_tr)
        self.steps = cdiv(self._n, self.batch_size)
        self._xi = torch.as_tensor(data.x_idx_tr, device=self.device).long()
        self._xv = torch.as_tensor(data.x_val_tr, device=self.device)
        self._y = torch.as_tensor(data.y_tr, device=self.device)
        self._gen = None

    def init_state(self, seed: int | None = None):
        """(params, opt_state) of a fresh run: the model's parameters drawn
        from a generator seeded with ``seed`` (default ``cfg.seed``), and
        the epoch permutations' device generator seeded from it."""
        gen = torch.Generator().manual_seed(
            self.cfg.seed if seed is None else seed)
        sharding.unshard_model(self.model)
        self.model.init(gen)
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=gen)))
        if self._row_names:
            sharding.shard_model(self.model, self.mesh, self._row_names)
        params = dict(self.model.named_parameters())
        return params, self.optimizer.init(params)

    def _views(self):
        return sharding.table_views(self.model, self.mesh, "gspmd")

    def epoch_order(self):
        """(order, w), each [steps, batch_size]: a permutation of
        steps * batch_size slots, not of the n rows; slots >= n weigh 0
        and read row n - 1 (cleverrec_tpu/rating.py:161-166)."""
        perm = torch.randperm(self.steps * self.batch_size,
                              generator=self._gen, device=self.device)
        w = (perm < self._n).float()
        order = perm.clamp(max=self._n - 1)
        return order.view(self.steps, -1), w.view(self.steps, -1)

    def train_epoch(self, params, opt_state, order=None, w=None):
        """One epoch over ``order`` and ``w`` ([steps, B]; drawn by
        ``epoch_order`` when not given), one optimizer step a row of them.
        Returns (params, opt_state, mean loss, order, w, y_pres [steps, B]:
        each step's predictions before its update)."""
        if order is None:
            order, w = self.epoch_order()
        order = torch.as_tensor(order, device=self.device).long()
        w = torch.as_tensor(w, device=self.device).float()
        names, leaves = list(params), list(params.values())
        mesh = self.mesh
        losses, y_pres = [], []
        for rows, wt in zip(order, w):
            step = sharding.data_chunk({"rows": rows, "w": wt}, mesh)
            rows = step["rows"]
            with self._views():
                *parts, y_pre = self.model.loss_parts(
                    self._xi[rows], self._xv[rows], self._y[rows], step["w"])
                loss = sharding.part_of_loss(parts, mesh)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
            grads, loss = sharding.over_data(grads, loss.detach(), mesh)
            if mesh is not None and mesh.shape["model"] > 1:
                grads = sharding.agree_grads(
                    grads, sharding.shards_of(self.model), mesh)
            self.optimizer.update(params, grads, opt_state)
            losses.append(loss)
            y_pres.append(y_pre.detach())
        y_pres = sharding.gather_chunks(torch.stack(y_pres).T,
                                        order.shape[1], mesh).T
        return (params, opt_state, torch.stack(losses).mean(), order, w,
                y_pres)

    def run(self, seed: int | None = None):
        """The whole loop: each epoch trains, logs the training RMSE and
        MAE of its in-flight predictions (the log record's ``train``
        attribute), tests (``eval``), and the best epoch by test RMSE is
        logged last (``best``) and returned as {"rmse", "mae", "epoch"}."""

        def log(msg, *args, **extra):
            if self.logger:
                self.logger.info(msg, *args, extra=extra)

        params, opt_state = self.init_state(seed)
        best = {"rmse": float("inf"), "mae": None, "epoch": 0}
        for epoch in range(1, self.cfg.epoches + 1):
            t1 = time.perf_counter()
            params, opt_state, loss, order, w, y_pres = self.train_epoch(
                params, opt_state)
            rmse_tr, mae_tr = self.train_rmse(order, w, y_pres)
            train_s = time.perf_counter() - t1
            log(" Training epoch %d\n time=%.2fs, RMSE=%.4f, MAE=%.4f",
                epoch, train_s, rmse_tr, mae_tr,
                train={"epoch": epoch, "seconds": train_s,
                       "loss": float(loss), "rmse": rmse_tr, "mae": mae_tr})
            t2 = time.perf_counter()
            rmse_t, mae_t = self.test()
            log("  Testing RMSE=%.4f, MAE=%.4f", rmse_t, mae_t,
                eval={"epoch": epoch, "seconds": time.perf_counter() - t2,
                      "rmse": rmse_t, "mae": mae_t})
            if rmse_t < best["rmse"]:
                best = {"rmse": rmse_t, "mae": mae_t, "epoch": epoch}
        log("best_epoch=%d, best_rmse=%.4f, best_mae=%.4f",
            best["epoch"], best["rmse"], best["mae"], best=best)
        self.params, self.opt_state = params, opt_state
        return best

    def train_rmse(self, order, w, y_pres):
        """(RMSE, MAE) of an epoch's in-flight predictions against the
        labels of the rows they were made for, weight-0 slots left out
        (the reference's quirk, RatingRecommender.py:47-54)."""
        keep = (torch.as_tensor(w).reshape(-1) > 0).cpu().numpy()
        y_pre = torch.as_tensor(y_pres).reshape(-1).cpu().numpy()[keep]
        rows = torch.as_tensor(order).reshape(-1).cpu().numpy()[keep]
        return rmse_mae(self.data.y_tr[rows], y_pre)

    @torch.no_grad()
    def test(self):
        """(RMSE, MAE) of the model's predictions on the test rows, in
        chunks of ``test.batch_size``."""
        bt = self.cfg.test_batch_size
        preds = []
        for s in range(0, len(self.data.y_t), bt):
            xi = torch.as_tensor(self.data.x_idx_t[s: s + bt],
                                 device=self.device).long()
            xv = torch.as_tensor(self.data.x_val_t[s: s + bt],
                                 device=self.device)
            with self._views():
                preds.append(self.model.predict(xi, xv).cpu().numpy())
        y_pre = np.concatenate(preds) if preds else np.zeros(0)
        return rmse_mae(self.data.y_t, y_pre)


def make_rating_model(cfg: Config, data: RatingData) -> FM:
    """The configured rating model (FFM takes its field count from the
    data's row width)."""
    name = cfg.recommender
    if name not in _RATING_MODELS:
        raise KeyError(f"unknown rating model {name!r}; "
                       f"available: {sorted(_RATING_MODELS)}")
    if name == "FFM":
        return FFM(cfg, data.feature_nums, n_fields=data.x_idx_tr.shape[1])
    return FM(cfg, data.feature_nums)


def run_rating(cfg: Config, logger=None, device=None, mesh=None):
    """Load the libFM files, train and test the configured model on
    ``device`` (default ``cuda``) or over ``mesh``; returns the best
    epoch's {"rmse", "mae", "epoch"}."""
    data = load_rating_data(cfg)
    model = make_rating_model(cfg, data)
    return FMTrainer(model, data, cfg, logger=logger, device=device,
                     mesh=mesh).run()
