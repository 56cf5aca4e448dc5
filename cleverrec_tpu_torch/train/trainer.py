"""The training loop: the main-path parts of
``cleverrec_tpu/train/trainer.py``.

An epoch is the model's sampler's whole epoch as [steps, B] tensors,
drawn in one pass from an explicit generator on the trainer's device:
(u, i, j, w) for the pairwise protocol (BPR, LRML, TransCF), (u, i, y,
w) for the pointwise one (GMF, MLP, NeuMF), (u, i, w) and negs
[steps, B, neg_ratio] for ``cml`` (CML), (u, i, k, j, suk, w) for
``sbpr`` (SBPR, CUNE_BPR) and (u, i, s, t, j, w) for ``tbpr`` (TBPR).
With ``train.sbpr_epoch_tensors=False`` SBPR, TBPR and CUNE_BPR draw
the same columns step by step instead (``sampling.sbpr_batch``,
``tbpr_batch`` over one ``epoch_permutation``; ``_build_batch``), and
either tier takes them.  The model's ``build_aux`` runs first (the social
models' SPu lists and exclusion tables, SAMN's friend lists, TransCF's
inverse degrees) and its ``epoch_pairs`` give the pairs the epoch
covers.  ``Trainer.aux``, which the loss and
the evaluator read, holds those pairs as ``pos_u`` and ``pos_i`` and
the numeric arrays of ``build_aux`` as device tensors (as the JAX
trainer's ``arrays``); the sampler's tables stay out of it.  It is
trained through one of two tiers:

- the fused tier (Adam and ``train.fused_kernel`` on; it defaults on for
  a CUDA device and off on the CPU), one call of an ``ops.train`` epoch
  function, the CUDA kernel on the card and its plain version on the
  CPU, chosen by the model's ``fused_protocol``:
  ``pairwise_bpr`` (the bpr loss only) runs ``fused_bpr_epoch`` and
  ``pointwise_bce`` runs ``fused_gmf_epoch``, both with invalid slots at
  the sentinel ids and ``n_sent * LOG2`` taken off the loss;
  ``cml_hinge`` (the hinge loss only) runs ``fused_cml_epoch``, invalid
  slots at the sentinel ids in u, i and every negative plane, and
  ``n_sent * cml_sentinel_bias`` taken off the loss;
  ``pointwise_mlp`` runs ``fused_mlp_epoch`` over the model's
  ``fused_mlp_spec``, masked by w in the kernel, with no correction;
  ``rows`` runs ``fused_rows_epoch`` over the model's
  ``fused_rows_spec`` (the social BPR chain, or LRML's form), invalid
  slots at the sentinel ids, masked in the kernel, with no correction
  (``train.fused_stream`` selects the same kernel: on the card the state
  stays in device memory either way);
- the lazy row-Adam tier (``train.sparse_rows_force``; BPR and the
  social-triple family with Adam): per step, autograd of the model's
  ``fused_rows_spec`` row loss over the gathered rows, then
  ``ops.sparse_adam`` on the touched rows only (LazyAdam) and plain Adam
  on the dense params.  Forced, it takes precedence over the fused tier,
  and the force on a model or optimizer the tier does not take raises;
  ``train.sparse_rows=False`` is its opt-out, moot while nothing but the
  force selects it (the card has no VMEM ceiling to overflow);
- the user-grouped pairwise epoch (a ``pairwise_grouped`` model, SAMN,
  unless ``train.grouped_pairs=False``): every user's pair cells laid
  into groups of ``TARGET_CHUNK`` once a run (``_build_grouped``), a
  fresh negative a valid cell and a permutation of groups each epoch,
  ``batch_size // TARGET_CHUNK`` groups a step through
  ``model.loss_grouped_pairwise`` and the optimizer;
- the bucketed-history tier (a pointwise ``history_bucketing`` model,
  NAIS, unless ``train.bucketed_histories=False``): users fall into
  power-of-two history-width buckets (``_build_buckets``), each with its
  seen table cut to its width and its own grid, built once a run: a
  model with ``loss_grouped`` takes each user's seen items and
  ``neg_ratio`` times as many negative cells in groups of
  ``TARGET_CHUNK`` (``_grouped_bucket``), any other the pointwise layout
  of the bucket's pairs at a batch fitted to it.  Each epoch trains the
  buckets in width order, each on fresh negatives and its own
  permutation, and reports the step-weighted mean of their losses;
- the scan tier: per step, autograd of ``model.loss``, the optax-semantics
  update of ``common.make_optimizer``, then ``model.postprocess``.

Each step of the autograd tiers (scan, grouped, bucketed) hands the
loss ``dropout_gen``, a generator on the device that the trainer owns
and checkpoints beside the sampler's (NGCF's message dropout draws from
it; the JAX trainer's ``dropout_key``).

``run(resume_from=...)`` restarts from a ``train/checkpoint.py``
checkpoint at its epoch + 1, and ``save.best=True`` checkpoints the best
epoch under ``saved_dir/<model>``; ``init_state`` applies the config's
warm start through the model's ``warm_start`` (NeuMF from
``gmf_pretrain`` and ``mlp_pretrain``, NAIS and NAIS_single from
``fism_pretrain``).  A warm-start key that the model does not read, or
one of its keys without the others, raises.

Parameters live in the model (``params`` is ``dict(model.named_parameters())``)
and are updated in place, so the evaluator always scores the current
tables.  Loss accounting matches the reference: per-batch summed loss
averaged over the number of batches (RankingRecommender.py:61).
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from cleverrec_tpu_torch import sampling
from cleverrec_tpu_torch.common import cdiv, make_optimizer, resolve_device
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data.arrays import DeviceData, build_device_data
from cleverrec_tpu_torch.data.dataset import RankingData
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models.base import RecModel
from cleverrec_tpu_torch.ops.sparse_adam import (dense_adam_leaf,
                                                 sparse_rows_adam)
from cleverrec_tpu_torch.ops.train import (LOG2, _cols, _side,
                                           cml_sentinel_bias,
                                           fused_bpr_epoch, fused_cml_epoch,
                                           fused_gmf_epoch, fused_mlp_epoch,
                                           fused_rows_epoch, mlp_epoch_plan,
                                           rows_epoch_plan, sentinel_dims)
from cleverrec_tpu_torch.train import checkpoint

# History widths of the bucketed tier's buckets below h_max
# (cleverrec_tpu/train/trainer.py:1702-1704); h_max is the last.
HISTORY_WIDTHS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
# Options of the JAX trainer that the port does not have yet, each with
# the test that it is set and where ROADMAP.md queues it.  A set option
# raises rather than be ignored.
_TIERS = "queue 1, item 17 (the trainer's VMEM-capacity tiers)"
_UNPORTED = (
    ("train.fused_bf16", lambda c, k: c.bool(k), _TIERS),
    ("train.fused_grouped", lambda c, k: c.bool(k), _TIERS),
    ("train.fused_groups", lambda c, k: c.int(k, 0) > 1, _TIERS),
    ("profile.dir", lambda c, k: bool(c.get(k)),
     "queue 1, item 4 (the port's benchmark and traces)"),
)


def _refuse_unported(cfg: Config) -> None:
    for key, is_set, where in _UNPORTED:
        if is_set(cfg, key):
            raise NotImplementedError(
                f"{key} is not ported yet (ROADMAP.md {where})")
    if cfg.str("neg_sampling", "uniform") != "uniform":
        raise NotImplementedError(
            "only uniform negatives are ported; neg_sampling="
            f"{cfg.str('neg_sampling')} waits (ROADMAP.md queue 1, item 7)")


def _joined(tensors, names):
    """The named [N, w_k] tensors side by side, [N, sum w_k]; a single
    one is the tensor itself."""
    if len(names) == 1:
        return tensors[names[0]].detach()
    return torch.cat([tensors[n].detach() for n in names], dim=1)


def _split_back(tensors, names, joined):
    """Copy each slice of ``joined`` back into the tensor it came from."""
    if len(names) == 1:
        return
    off = 0
    for n in names:
        width = tensors[n].shape[1]
        tensors[n].detach().copy_(joined[:, off:off + width])
        off += width


class Trainer:
    """Trains ``model`` on ``data`` on ``device`` (default ``cuda``; the
    model is moved there) and evaluates it with the ``Evaluator``."""

    def __init__(self, model: RecModel, data: RankingData, cfg: Config,
                 logger=None, device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP.md queue 1, item 16)")
        _refuse_unported(cfg)
        if model.sampler not in ("pairwise", "pointwise", "cml", "sbpr",
                                 "tbpr"):
            raise NotImplementedError(
                f"sampler {model.sampler!r} is not ported yet: the port "
                "trains the pairwise, pointwise, cml, sbpr and tbpr "
                "protocols (ROADMAP.md queue 1, item 11)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.logger = logger
        self._warm = self._warm_start_keys()
        self.dd: DeviceData = build_device_data(data)
        # build_aux may restrict the epoch's pairs (the social family), so
        # it runs before epoch_pairs.
        self.model_aux = model.build_aux(self.dd, data)
        pos_u, pos_i = model.epoch_pairs(self.dd)
        self.n_pairs = len(pos_u)
        self.batch_size = cfg.batch_size
        self.neg_ratio = cfg.neg_ratio
        self._epoch_rows = self._rows_per_epoch()
        self.steps_per_epoch = cdiv(self._epoch_rows, self.batch_size)
        padded = self.steps_per_epoch * self.batch_size
        self._n_sent = padded - self._epoch_rows
        # The per-step social samplers (utils/sampler.py's batch layout).
        self._per_step = (model.sampler in ("sbpr", "tbpr")
                          and not cfg.bool("train.sbpr_epoch_tensors", True))
        self._grid = None
        if (getattr(model, "pairwise_grouped", False)
                and cfg.bool("train.grouped_pairs", True)):
            self._build_grouped(pos_u, pos_i)
        bucketed = (getattr(model, "history_bucketing", False)
                    and model.sampler == "pointwise"
                    and cfg.bool("train.bucketed_histories", True))
        self._build_layout(pos_u, pos_i, padded, layout=not bucketed)
        self.aux: dict[str, torch.Tensor] = {
            name: torch.as_tensor(a, device=self.device)
            for name, a in (("pos_u", pos_u), ("pos_i", pos_i),
                            *self.model_aux.items())
            if isinstance(a, np.ndarray)}
        self._buckets = self._build_buckets(pos_u, pos_i) if bucketed else None
        self.optimizer = make_optimizer(cfg.optimizer, cfg.lr)
        self.sparse_rows = self._sparse_rows_eligible()
        self.fused = not self.sparse_rows and self._fused_epoch_eligible()
        self._gen: torch.Generator | None = None
        self._dropout_gen: torch.Generator | None = None
        self.evaluator = Evaluator(model, self.dd, cfg, device=self.device)

    def _rows_per_epoch(self) -> int:
        """Rows an epoch: a pairwise or social pair fills neg_ratio rows, a
        pointwise pair one positive and neg_ratio negatives, a CML pair
        one row that carries its neg_ratio negatives."""
        s = self.model.sampler
        if s in ("pairwise", "sbpr", "tbpr"):
            return self.n_pairs * self.neg_ratio
        if s == "pointwise":
            return self.n_pairs * (1 + self.neg_ratio)
        return self.n_pairs

    def _build_grouped(self, pos_u, pos_i) -> None:
        """The grouped pairwise epoch's grid: each user's pairs repeated
        neg_ratio times, laid in order into that user's groups of
        ``TARGET_CHUNK`` cells; ``pg_user`` [G_pad], ``pg_pos`` and
        ``pg_w`` [G_pad, T] (pad cells hold ``item_nums`` and weight 0).
        G_pad fills the last step of ``batch_size // TARGET_CHUNK``
        groups."""
        tc, nr = self.model.TARGET_CHUNK, self.neg_ratio
        item_nums = self.dd.item_nums
        order = np.argsort(pos_u, kind="stable")
        su, si = pos_u[order], pos_i[order]
        users, starts = np.unique(su, return_index=True)
        cells = np.diff(np.append(starts, len(su))) * nr
        n_groups = -(-cells // tc)
        g_total = int(n_groups.sum())
        per_step = max(self.batch_size // tc, 1)
        steps = cdiv(g_total, per_step)
        g_pad = steps * per_step
        # Cell c of user k lands at slot_off[k] + (c - c_off[k]).
        c_off = np.concatenate([[0], np.cumsum(cells)])
        slot_off = np.concatenate([[0], np.cumsum(n_groups * tc)])
        k_of_cell = np.repeat(np.arange(len(users)), cells)
        dest = slot_off[k_of_cell] + (np.arange(int(cells.sum()))
                                      - c_off[k_of_cell])
        flat_pos = np.full(g_pad * tc, item_nums, np.int32)
        flat_pos[dest] = np.repeat(si, nr)
        flat_w = np.zeros(g_pad * tc, np.float32)
        flat_w[dest] = 1.0
        pg_user = np.zeros(g_pad, np.int32)
        pg_user[:g_total] = np.repeat(users, n_groups)
        self._grid = {
            "pg_user": pg_user, "pg_pos": flat_pos.reshape(g_pad, tc),
            "pg_w": flat_w.reshape(g_pad, tc)}
        self._grid_steps, self._grid_per_step = steps, per_step
        self.steps_per_epoch = steps
        if self.logger:
            self.logger.info(
                "grouped pairwise epoch: %d groups x %d cells, %d steps",
                g_total, tc, steps)

    def _build_buckets(self, pos_u, pos_i) -> list[dict]:
        """The bucketed tier's plan (cleverrec_tpu/train/trainer.py:1686-1745):
        each pair goes to the first width of ``HISTORY_WIDTHS`` below h_max,
        then h_max, that holds its user's seen count; a bucket reads the
        seen rows cut to its width.  A model with ``loss_grouped`` gets
        the grouped grid of the bucket's users (``_grouped_bucket``), any
        other the pointwise layout of the bucket's pairs at a batch of
        min(batch_size, the bucket's rows rounded up to 256, at least
        256).  A bucket holds its ``width``, ``pairs``, ``steps``, ``aux``
        and ``grid`` (numpy, ``g_user`` [G_pad], ``g_pos``, ``g_y``,
        ``g_w`` [G_pad, T], ``g_nun`` [G_pad]; None for the row layout)
        with its tensors in ``dev`` (all but ``g_nun``: the draw counts
        the unseen items from the sampler's table)."""
        seen = self.dd.seen
        lens = np.asarray(seen.lens)
        h_max = seen.rows.shape[1]
        widths = [w for w in HISTORY_WIDTHS if w < h_max] + [h_max]
        bidx = np.searchsorted(np.asarray(widths), lens[pos_u], side="left")
        grouped = hasattr(self.model, "loss_grouped")
        grp = 1 + self.neg_ratio
        plan = []
        for k, width in enumerate(widths):
            sel = bidx == k
            n_sel = int(sel.sum())
            if n_sel == 0:
                continue
            aux = dict(self.aux)
            aux["seen_rows"] = self.aux["seen_rows"][:, :width].contiguous()
            bucket = {"width": width, "pairs": n_sel, "aux": aux}
            if grouped:
                grid, bucket["steps"], bucket["per_step"] = (
                    self._grouped_bucket(np.unique(pos_u[sel])))
                arrays = grid
            else:
                rows = n_sel * grp
                b = min(self.batch_size, max(256, cdiv(rows, 256) * 256))
                bucket.update(rows=rows, batch=b, steps=cdiv(rows, b))
                grid = None
                arrays = sampling.pointwise_epoch_static(
                    pos_u[sel], pos_i[sel], lens, self.dd.item_nums,
                    bucket["steps"] * b, self.neg_ratio)
            bucket["grid"] = grid
            bucket["dev"] = {name: torch.as_tensor(a, device=self.device)
                             for name, a in arrays.items()
                             if name != "g_nun"}
            plan.append(bucket)
        self.steps_per_epoch = sum(b["steps"] for b in plan)
        if self.logger:
            self.logger.info(
                "history buckets (%s): %s", "grouped" if grouped else "row",
                ", ".join(f"w={b['width']}:{b['pairs']}p/{b['steps']}s"
                          for b in plan),
                extra={"buckets": [{k: b[k] for k in ("width", "pairs",
                                                       "steps")}
                                   for b in plan]})
        return plan

    def _grouped_bucket(self, users):
        """One bucket's grouped grid (cleverrec_tpu/train/trainer.py:
        1747-1796) over its sorted ``users``: user u's first lens[u] cells
        hold its seen items (y = 1), the next neg_ratio * lens[u] cells
        are negatives (item_nums until drawn), the rest of its
        ceil((1 + neg_ratio) lens[u] / TARGET_CHUNK) groups pad (weight
        0); the grid is padded with user-0 groups to whole steps of
        ``batch_size // TARGET_CHUNK`` groups.  ``g_nun``: each group's
        unseen count, as in JAX's grid (the draw does not read it).
        Returns (grid, steps, groups a step)."""
        tc, grp = self.model.TARGET_CHUNK, 1 + self.neg_ratio
        item_nums = self.dd.item_nums
        lens = np.asarray(self.dd.seen.lens)
        deg = lens[users].astype(np.int64)
        n_groups = -(-(grp * deg) // tc)
        g_total = int(n_groups.sum())
        per_step = max(self.batch_size // tc, 1)
        steps = cdiv(g_total, per_step)
        g_pad = steps * per_step
        slot_off = np.concatenate([[0], np.cumsum(n_groups * tc)[:-1]])
        flat_pos = np.full(g_pad * tc, item_nums, np.int32)
        flat_y = np.zeros(g_pad * tc, np.float32)
        flat_w = np.zeros(g_pad * tc, np.float32)
        hist = self.dd.seen.rows[users]
        k, j = np.nonzero(np.arange(hist.shape[1])[None, :] < deg[:, None])
        flat_pos[slot_off[k] + j] = hist[k, j]
        flat_y[slot_off[k] + j] = 1.0
        cells = grp * deg
        k = np.repeat(np.arange(len(users)), cells)
        c_off = np.concatenate([[0], np.cumsum(cells)[:-1]])
        flat_w[slot_off[k] + np.arange(int(cells.sum())) - c_off[k]] = 1.0
        g_user = np.zeros(g_pad, np.int32)
        g_user[:g_total] = np.repeat(users, n_groups)
        grid = {"g_user": g_user, "g_pos": flat_pos.reshape(g_pad, tc),
                "g_y": flat_y.reshape(g_pad, tc),
                "g_w": flat_w.reshape(g_pad, tc),
                "g_nun": np.maximum(item_nums - lens[g_user], 1).astype(
                    np.int32)}
        return grid, steps, per_step

    def _build_layout(self, pos_u, pos_i, padded: int,
                      layout: bool = True) -> None:
        """The sampler's per-run constants on the device: the static epoch
        layout (none for the per-step samplers, the grouped epoch and,
        ``layout`` False, the bucketed tier, whose buckets hold their own),
        the membership table its negatives avoid (the seen items, or the
        social models' seen-union-social table), the social models' CSR
        lists and, for the per-step samplers, each list's lengths and the
        union table as ``MemberTable``s (the negative is drawn by rank
        from the union, so no bitmap and no seen table)."""
        aux, dd, sampler = self.model_aux, self.dd, self.model.sampler
        neg = aux.get("social_neg", dd.seen)
        head = (pos_u, pos_i, neg.lens)
        tail = (dd.item_nums, padded, self.neg_ratio)
        if self._per_step or self._grid is not None or not layout:
            static = {}
        elif sampler == "sbpr":
            spu = aux["spu_csr"]
            static = sampling.sbpr_epoch_static(
                *head, sampling.csr_lens(spu), spu["off"], *tail)
        elif sampler == "tbpr":
            ts, tw = aux["ts_csr"], aux["tw_csr"]
            static = sampling.tbpr_epoch_static(
                *head, sampling.csr_lens(ts), ts["off"], sampling.csr_lens(tw),
                tw["off"], *tail)
        elif sampler == "pointwise":
            static = sampling.pointwise_epoch_static(*head, *tail)
        elif sampler == "cml":
            # One row per pair, its negatives drawn per row: the pairwise
            # layout at neg_ratio 1.
            static = sampling.pairwise_epoch_static(*head, *tail[:2], 1)
        else:
            static = sampling.pairwise_epoch_static(*head, *tail)

        def put(a):
            return torch.as_tensor(a, device=self.device)

        self._static = {k: put(v) for k, v in static.items()}
        self._neg_rows, self._neg_lens = put(neg.rows), put(neg.lens)
        self._csr = {name: {k: put(c[k]) for k in ("flat", "off", "suk")}
                     for name, c in aux.items() if name.endswith("_csr")}
        if self._grid is not None:
            self._pg = {k: put(v) for k, v in self._grid.items()}
        self._tables = {}
        if self._per_step:
            self._tables = {
                name: sampling.MemberTable(None, put(sampling.csr_lens(c)),
                                           None)
                for name, c in aux.items() if name.endswith("_csr")}
            self._tables["social_neg"] = sampling.MemberTable(
                self._neg_rows, self._neg_lens, None)

    def _warm_start_keys(self) -> tuple[str, ...]:
        """The warm-start keys set in the config: all of the model's
        ``pretrain_keys`` or none.  A key the model does not read, or
        some of its keys without the others, raises."""
        own = getattr(self.model, "pretrain_keys", ())
        given = tuple(k for k in checkpoint.PRETRAIN_KEYS if k in self.cfg)
        if given and set(given) != set(own):
            raise ValueError(
                f"{', '.join(given)} set, but {self.model.name} warm-starts "
                f"from {' and '.join(own) if own else 'no checkpoint'}: set "
                "all of its keys or none")
        return given

    def _sparse_rows_eligible(self) -> bool:
        """The lazy row-Adam tier: ``train.sparse_rows_force`` on a model
        with a ``fused_rows_spec`` on the rows or BPR protocol, under
        Adam; the force on any other model or optimizer raises.  The JAX
        trainer also takes it, unless ``train.sparse_rows=False``, where
        the TPU's resident plan overflows VMEM; the card has no such
        ceiling, so here only the force selects it."""
        if not self.cfg.bool("train.sparse_rows_force", False):
            return False
        if (getattr(self.model, "fused_protocol", None)
                not in ("rows", "pairwise_bpr")
                or not hasattr(self.model, "fused_rows_spec")
                or self.cfg.optimizer != "Adam"):
            raise ValueError(
                "train.sparse_rows_force: the lazy row-Adam tier takes a "
                "model with a rows spec (BPR and the social-triple family) "
                f"under Adam, not {self.model.name} under "
                f"{self.cfg.optimizer}")
        return True

    def _fused_epoch_eligible(self) -> bool:
        """The fused epoch kernels hard-code their model's form and Adam;
        the BPR kernel also the -log sigmoid objective (GMF's sigmoid
        cross-entropy is its only objective, as in the JAX trainer), and
        the CML kernel the hinge.
        ``train.fused_kernel`` turns the tier on or off (default: on for
        a CUDA device).  A tower the kernel does not take (more than 4
        layers, or shared memory short) or a rows spec outside the forms
        the kernel has a backward for (the social BPR chain, LRML's hinge)
        is declined here, with a log line, and trains through the scan
        tier."""
        proto = getattr(self.model, "fused_protocol", None)
        if (proto is None or self.cfg.optimizer != "Adam"
                or (proto == "pairwise_bpr" and self.cfg.loss_func != "bpr")
                or (proto == "cml_hinge" and self.cfg.loss_func != "hinge")
                or not self.cfg.bool("train.fused_kernel",
                                     self.device.type == "cuda")):
            return False
        try:
            if proto == "pointwise_mlp":
                spec = self.model.fused_mlp_spec()
                n_layers = (len(spec["dense"]) - 1) // 2
                mlp_epoch_plan(spec["gmf_width"],
                               [tuple(getattr(self.model, n).shape)
                                for n in spec["dense"][:n_layers]])
            elif proto == "rows":
                rows_epoch_plan(self.model.fused_rows_spec())
        except ValueError as e:
            if self.logger:
                self.logger.info("fused epoch kernel skipped (%s); using the "
                                 "scan tier", e)
            return False
        if (proto == "rows" and self.logger
                and self.cfg.bool("train.fused_stream", False)):
            self.logger.info("train.fused_stream: the streamed rows epoch is "
                             "the same kernel here (the state stays in "
                             "device memory)")
        return True

    # -- one epoch ------------------------------------------------------
    def sample_epoch(self) -> dict:
        """The next epoch's draw of the model's sampler, each column
        [steps, B] on the device; for the grouped epoch, ``j`` [G_pad, T]
        (a negative a cell, ``item_nums`` on pad cells) and ``perm``
        [steps, G/step] (the groups of each step); for the bucketed tier,
        ``buckets``, each bucket's draw in plan order."""
        if self._gen is None:
            raise RuntimeError("call init_state first")
        if self._grid is not None:
            return self._sample_grouped()
        if self._buckets is not None:
            return {"buckets": [self._sample_bucket(b)
                                for b in self._buckets]}
        if self._per_step:
            steps, b = self.steps_per_epoch, self.batch_size
            perm, valid = sampling.epoch_permutation(
                self._gen, self._epoch_rows, steps * b)
            batches = [self._build_batch(r, v) for r, v in zip(
                perm.reshape(steps, b), valid.reshape(steps, b))]
            return {k: torch.stack([bt[k] for bt in batches])
                    for k in batches[0]}
        head = (self._gen, self._static, self._neg_rows, self._neg_lens)
        lists = {"sbpr": ("spu_csr",), "tbpr": ("ts_csr", "tw_csr")}.get(
            self.model.sampler, ())
        tensors_fn = {"sbpr": sampling.sbpr_epoch_tensors,
                      "tbpr": sampling.tbpr_epoch_tensors,
                      "pointwise": sampling.pointwise_epoch_tensors,
                      "pairwise": sampling.pairwise_epoch_tensors,
                      "cml": functools.partial(sampling.cml_epoch_tensors,
                                               neg_ratio=self.neg_ratio)}[
                          self.model.sampler]
        return tensors_fn(*head, *(self._csr[n] for n in lists),
                          self._epoch_rows, self.steps_per_epoch,
                          self.batch_size)

    def _build_batch(self, rows, valid) -> dict[str, torch.Tensor]:
        """One step's rows of the per-step social sampler, from that
        step's shuffled row ids ``rows`` [B] and weights ``valid`` [B]."""
        t, csr = self._tables, self._csr
        common = (self._gen, rows, valid, self.aux["pos_u"],
                  self.aux["pos_i"], None, self.dd.item_nums,
                  self.neg_ratio)
        if self.model.sampler == "sbpr":
            return sampling.sbpr_batch(*common, t["spu_csr"], csr["spu_csr"],
                                       social_neg=t["social_neg"])
        return sampling.tbpr_batch(*common, t["ts_csr"], t["tw_csr"],
                                   csr["ts_csr"], csr["tw_csr"],
                                   social_neg=t["social_neg"])

    def _sample_grouped(self) -> dict[str, torch.Tensor]:
        """A fresh unseen negative for every cell of the grid (weight-0
        cells get ``item_nums``) and a permutation of the groups."""
        pg, g_pad = self._pg, self._grid["pg_user"].shape[0]
        j = sampling.sample_not_in(
            self._gen, sampling.MemberTable(self._neg_rows, self._neg_lens,
                                            None),
            pg["pg_user"], self.dd.item_nums, pg["pg_pos"].shape)
        j = torch.where(pg["pg_w"] > 0, j, self.dd.item_nums)
        perm = torch.randperm(g_pad, generator=self._gen, device=self.device)
        return {"j": j, "perm": perm.reshape(self._grid_steps,
                                             self._grid_per_step)}

    def _sample_bucket(self, bucket) -> dict[str, torch.Tensor]:
        """One bucket's draw: for the grouped grid, ``gt`` [G_pad, T] (the
        positives, a fresh unseen negative on each negative cell, and
        ``item_nums`` on pad cells) and ``perm`` [steps, G/step]; for
        the row layout, the pointwise epoch's [steps, b] columns."""
        dev = bucket["dev"]
        if bucket["grid"] is None:
            return sampling.pointwise_epoch_tensors(
                self._gen, dev, self._neg_rows, self._neg_lens,
                bucket["rows"], bucket["steps"], bucket["batch"])
        j = sampling.sample_not_in(
            self._gen, sampling.MemberTable(self._neg_rows, self._neg_lens,
                                            None),
            dev["g_user"], self.dd.item_nums, dev["g_pos"].shape)
        gt = torch.where(dev["g_y"] > 0, dev["g_pos"], j)
        gt = torch.where(dev["g_w"] > 0, gt, self.dd.item_nums)
        perm = torch.randperm(dev["g_user"].shape[0], generator=self._gen,
                              device=self.device)
        return {"gt": gt, "perm": perm.reshape(bucket["steps"],
                                               bucket["per_step"])}

    def _run_epoch(self, params, opt_state, tensors):
        """Train one epoch on given sampled tensors ([steps, B] each, the
        grouped epoch's ``j`` and ``perm``, or the bucketed tier's
        ``buckets``); returns (params, opt_state, mean per-step loss as a
        0-dim tensor).  ``params`` must be the model's own parameters."""
        if self._grid is not None:
            return self._grouped_epoch(params, opt_state, tensors)
        if self._buckets is not None:
            return self._bucketed_epoch(params, opt_state,
                                        tensors["buckets"])
        if self.sparse_rows:
            return self._sparse_rows_epoch(params, opt_state, tensors)
        if self.fused:
            return self._fused_epoch(params, opt_state, tensors)
        return self._scan_epoch(params, opt_state, tensors)

    def _steps(self, params, opt_state, batches, loss_fn, aux=None):
        """One optimizer step a batch on ``loss_fn(batch, aux)`` (default
        aux: ``self.aux``), each batch with the trainer's
        ``dropout_gen``; returns (params, opt_state, mean loss)."""
        names = list(params)
        leaves = [params[k] for k in names]
        aux = self.aux if aux is None else aux
        losses = torch.zeros(len(batches), dtype=torch.float32,
                             device=self.device)
        for s, batch in enumerate(batches):
            loss = loss_fn({**batch, "dropout_gen": self._dropout_gen}, aux)
            # A parameter outside the loss (NeuMF's h_gmf and h_mlp, kept
            # for the warm start) gets a zero gradient, as under JAX:
            # Adam then leaves it and its moments as they were.
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, torch.autograd.grad(
                         loss, leaves, allow_unused=True))]
            opt_state = self.optimizer.update(params, dict(zip(names, grads)),
                                              opt_state)
            self.model.postprocess()
            losses[s] = loss.detach()
        return params, opt_state, losses.mean()

    def _scan_epoch(self, params, opt_state, tensors):
        batches = [{k: v[s] for k, v in tensors.items()}
                   for s in range(tensors["u"].shape[0])]
        return self._steps(params, opt_state, batches, self.model.loss)

    def _grouped_epoch(self, params, opt_state, tensors):
        pg, j = self._pg, tensors["j"]
        batches = [{"gu": pg["pg_user"][sel], "gi": pg["pg_pos"][sel],
                    "gj": j[sel], "gw": pg["pg_w"][sel]}
                   for sel in tensors["perm"]]
        return self._steps(params, opt_state, batches,
                           self.model.loss_grouped_pairwise)

    def _bucketed_epoch(self, params, opt_state, draws):
        """Each bucket's steps on its draw, in plan order, over its own
        aux; the loss is the bucket losses' mean weighted by their steps
        (cleverrec_tpu/train/trainer.py:1949-1958)."""
        total, steps = 0.0, 0
        for bucket, draw in zip(self._buckets, draws):
            if bucket["grid"] is None:
                batches = [{k: v[s] for k, v in draw.items()}
                           for s in range(bucket["steps"])]
                loss_fn = self.model.loss
            else:
                dev = bucket["dev"]
                batches = [{"gu": dev["g_user"][sel], "gt": draw["gt"][sel],
                            "gy": dev["g_y"][sel], "gw": dev["g_w"][sel]}
                           for sel in draw["perm"]]
                loss_fn = self.model.loss_grouped
            params, opt_state, loss = self._steps(
                params, opt_state, batches, loss_fn, bucket["aux"])
            total = total + loss * bucket["steps"]
            steps += bucket["steps"]
        return params, opt_state, total / steps

    def _sparse_rows_epoch(self, params, opt_state, tensors):
        """Per step: the model's rows loss over each plane's gathered rows
        (a side's tables joined on the feature axis), its gradients with
        respect to those rows, then LazyAdam on the rows each side's
        planes touched (every row of the batch, weight-0 rows too, as the
        JAX tier) and plain Adam on the dense params."""
        spec = self.model.fused_rows_spec()
        names = [n for n, _ in spec["planes"]]
        sides = [sd for _, sd in spec["planes"]]
        packs = [spec["pack"](t) for t in (params, opt_state.mu,
                                           opt_state.nu)]
        tables = {sd: [tuple(_cols(x) for x in _side(p[k])) for p in packs]
                  for k, sd in enumerate(("u", "i"))}
        dense = [p[2] for p in packs]
        count, lr = opt_state.count, self.cfg.lr
        steps = tensors["w"].shape[0]
        losses = torch.zeros(steps, dtype=torch.float32, device=self.device)
        for s in range(steps):
            ids = [tensors[n][s].long() for n in names]
            rows = [torch.cat([x[i] for x in tables[sd][0]], dim=1)
                    for i, sd in zip(ids, sides)]
            leaves = [r.requires_grad_() for r in rows] + [
                x.detach().requires_grad_() for x in dense[0]]
            loss = spec["row_loss"](
                tuple(leaves[:len(rows)]),
                tuple(tensors[n][s].to(torch.float32)[:, None]
                      for n in spec["floats"]),
                tuple(leaves[len(rows):]),
                tensors["w"][s].to(torch.float32)[:, None])
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for sd in ("u", "i"):
                on = [k for k, side in enumerate(sides) if side == sd]
                side_ids = torch.cat([ids[k] for k in on])
                side_g = torch.cat([grads[k] for k in on])
                off = 0
                for x, m, v in zip(*tables[sd]):
                    width = x.shape[1]
                    sparse_rows_adam(x, m, v, side_ids,
                                     side_g[:, off:off + width], count, lr)
                    off += width
            for x, m, v, g in zip(*dense, grads[len(rows):]):
                dense_adam_leaf(x, m, v, torch.zeros_like(x) if g is None
                                else g, count, lr)
            count += 1
            losses[s] = loss.detach()
        opt_state.count = count
        return params, opt_state, losses.mean()

    def _fused_epoch(self, params, opt_state, tensors):
        u_sent, i_sent = (n - 1 for n in sentinel_dims(self.dd.user_nums,
                                                       self.dd.item_nums))
        inval = tensors["w"] == 0

        def ids(name, sentinel):
            return torch.where(inval, sentinel, tensors[name]).to(
                torch.int32).contiguous()

        def col(name):
            return tensors[name].to(torch.float32).contiguous()

        steps = tensors["u"].shape[0]
        proto, t0, lr = self.model.fused_protocol, opt_state.count, self.cfg.lr

        def with_moments(name):
            return (params[name].detach(), opt_state.mu[name],
                    opt_state.nu[name])

        if proto == "pairwise_bpr":
            (p, mp, vp), (q, mq, vq) = map(with_moments, ("P", "Q"))
            raw = fused_bpr_epoch(p, q, mp, vp, mq, vq, ids("u", u_sent),
                                  ids("i", i_sent), ids("j", i_sent), t0,
                                  lr=lr, reg=self.model.reg)
            loss = raw - self._n_sent * LOG2
        elif proto == "pointwise_bce":
            (p, mp, vp), (q, mq, vq), (h, mh, vh) = map(
                with_moments, ("P", "Q", "h_gmf"))
            raw = fused_gmf_epoch(p, q, h, mp, vp, mq, vq, mh, vh,
                                  ids("u", u_sent), ids("i", i_sent),
                                  col("y"), t0, lr=lr, reg=self.model.reg)
            loss = raw - self._n_sent * LOG2
        elif proto == "cml_hinge":
            (p, mp, vp), (q, mq, vq) = map(with_moments, ("P", "Q"))
            negs = torch.where(inval[..., None], i_sent, tensors["negs"]).to(
                torch.int32).contiguous()
            margin, item_nums = self.model.margin, self.dd.item_nums
            raw = fused_cml_epoch(p, q, mp, vp, mq, vq, ids("u", u_sent),
                                  ids("i", i_sent), negs, t0, lr=lr,
                                  reg=self.model.reg, margin=margin,
                                  item_nums=item_nums)
            loss = raw - self._n_sent * cml_sentinel_bias(
                margin, item_nums, self.neg_ratio)
        elif proto == "rows":
            spec = self.model.fused_rows_spec()
            sides = [sd for _, sd in spec["planes"]]
            planes = [ids(name, u_sent if sd == "u" else i_sent)
                      for name, sd in spec["planes"]]
            state = [x for t in (params, opt_state.mu, opt_state.nu)
                     for x in spec["pack"](t)]
            loss = fused_rows_epoch(*state, planes,
                                    [col(n) for n in spec["floats"]], t0,
                                    sides=sides, spec=spec, lr=lr)
        else:
            loss = self._fused_mlp(params, opt_state, ids("u", u_sent),
                                   ids("i", i_sent), col("y"), col("w"))
        # Adam's count advances by the padded step count, as in the JAX
        # trainer: padded steps are Adam steps too.
        opt_state.count += steps
        return params, opt_state, loss / steps

    def _fused_mlp(self, params, opt_state, u, i, y, w):
        """The tower epoch over the model's spec: each side's tables joined
        on the feature axis (NeuMF: [P_gmf | P_mlp]) for the epoch, then
        split back; the dense params are updated where they are.  Params
        outside the spec pass through unchanged."""
        spec = self.model.fused_mlp_spec()
        state = []
        for t in (params, opt_state.mu, opt_state.nu):
            state += [_joined(t, spec["u"]), _joined(t, spec["i"]),
                      [t[n].detach() for n in spec["dense"]]]
        raw = fused_mlp_epoch(*state, u, i, y, w, opt_state.count, spec=spec,
                              lr=self.cfg.lr)
        for k, t in enumerate((params, opt_state.mu, opt_state.nu)):
            _split_back(t, spec["u"], state[3 * k])
            _split_back(t, spec["i"], state[3 * k + 1])
        return raw

    # -- public API -----------------------------------------------------
    def init_state(self, seed: int | None = None, warm_start: bool = True):
        """(params, opt_state) of a fresh run: the model's parameters drawn
        from a generator seeded with ``seed`` (default ``cfg.seed``), then
        the config's warm start (the model's ``warm_start``), and the
        sampler's and the dropout's device generators seeded from the
        same stream."""
        gen = torch.Generator().manual_seed(
            self.cfg.seed if seed is None else seed)
        self.model.init(gen)
        self._gen, self._dropout_gen = (
            torch.Generator(device=self.device).manual_seed(
                int(torch.randint(2 ** 62, (1,), generator=gen)))
            for _ in range(2))
        params = dict(self.model.named_parameters())
        if warm_start and self._warm:
            own = {k: p.detach() for k, p in params.items()}
            checkpoint.copy_into(own, self.model.warm_start(own, self.cfg),
                                 "warm start")
            if self.logger:
                self.logger.info("warm start: %s from %s", self.model.name,
                                 ", ".join(self.cfg.str(k)
                                           for k in self._warm))
        return params, self.optimizer.init(params)

    def rng_state(self) -> dict[str, torch.Tensor]:
        """The generators a run draws from: the sampler's, the dropout's
        and torch's CPU generator (and the card's, on a card)."""
        state = {"sampler": self._gen.get_state(),
                 "dropout": self._dropout_gen.get_state(),
                 "cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            state["cuda"] = torch.cuda.get_rng_state(self.device)
        return state

    def save(self, path: str, params, opt_state, epoch: int) -> str:
        """A train-state checkpoint of this run after ``epoch`` epochs."""
        return checkpoint.save_checkpoint(path, params, opt_state, epoch,
                                          self.rng_state())

    def resume(self, path: str):
        """(params, opt_state, epoch) of the run that ``save`` wrote to
        ``path``, the model's parameters and the generators set to it."""
        params, opt_state = self.init_state(warm_start=False)
        state = checkpoint.load_checkpoint(path)
        checkpoint.copy_into({k: p.detach() for k, p in params.items()},
                              state["params"], "parameter")
        opt_state = checkpoint.load_optimizer_state(state["opt_state"],
                                                    opt_state)
        rng = state["rng"]
        self._gen.set_state(rng["sampler"])
        if "dropout" in rng:
            self._dropout_gen.set_state(rng["dropout"])
        torch.set_rng_state(rng["cpu"])
        if "cuda" in rng and self.device.type == "cuda":
            torch.cuda.set_rng_state(rng["cuda"], self.device)
        return params, opt_state, int(state["epoch"])

    def train_epoch(self, params, opt_state):
        params, opt_state, loss = self._run_epoch(params, opt_state,
                                                  self.sample_epoch())
        return params, opt_state, float(loss)

    def train_epochs(self, params, opt_state, n_epochs: int):
        """n epochs in a row; returns (params, opt_state, losses[n])."""
        losses = []
        for _ in range(n_epochs):
            params, opt_state, loss = self.train_epoch(params, opt_state)
            losses.append(loss)
        return params, opt_state, losses

    def evaluate(self) -> dict[int, tuple[float, float, float]]:
        """{K: (HR, MRR, NDCG)} of the model's current parameters."""
        return self.evaluator.evaluate(self.aux)

    def run(self, seed: int | None = None, resume_from: str | None = None):
        """Full train/eval loop with best-NDCG@topk[0] tracking
        (RankingRecommender.py:400-440).  Each epoch line carries its
        numbers as the log record's ``train`` attribute, each eval's as
        ``eval``, and the summary's as ``best``.  ``resume_from``, a
        checkpoint directory, restarts at its epoch + 1; with
        ``save.best=True`` each new best epoch's train state is saved to
        ``saved_dir/<model>`` (the reference's disabled save path,
        RankingRecommender.py:432-433, made to work)."""

        def log(msg, *args, **extra):
            if self.logger:
                self.logger.info(msg, *args, extra=extra)

        if resume_from:
            params, opt_state, epoch = self.resume(resume_from)
            log("resumed from %s at epoch %d", resume_from, epoch)
        else:
            params, opt_state = self.init_state(seed)
            epoch = 0
        save_dir = None
        if self.cfg.bool("save.best", False):
            save_dir = os.path.join(self.cfg.str("saved_dir", "./saved_model"),
                                    self.model.name)
        topk = self.cfg.topk
        best = {"epoch": 0, "ndcg": 0.0, "metrics": {}}
        interval = self.cfg.test_interval
        while epoch < self.cfg.epoches:
            next_eval = min(((epoch // interval) + 1) * interval,
                            self.cfg.epoches)
            block = next_eval - epoch
            t1 = time.perf_counter()
            params, opt_state, losses = self.train_epochs(params, opt_state,
                                                          block)
            train_s = time.perf_counter() - t1
            epoch = next_eval
            log(" epoch %d\n  Training loss: %.4f, time: %.2fs (%d epochs)",
                epoch, losses[-1], train_s, block,
                train={"epoch": epoch, "losses": losses, "seconds": train_s})
            if epoch % interval:
                continue
            t2 = time.perf_counter()
            results = self.evaluate()
            eval_s = time.perf_counter() - t2
            log("  Testing time: %.2fs", eval_s,
                eval={"epoch": epoch, "seconds": eval_s, "metrics": results})
            for k in topk:
                hr, mrr, ndcg = results[k]
                log("  (k=%d) HR=%.4f, MRR=%.4f, NDCG=%.4f", k, hr, mrr, ndcg)
            if results[topk[0]][2] > best["ndcg"]:
                best = {"epoch": epoch, "ndcg": results[topk[0]][2],
                        "metrics": results}
                if save_dir:
                    self.save(save_dir, params, opt_state, epoch)
                    log("  saved to %s", save_dir)
        log("best_epoch: %d", best["epoch"], best=best)
        for k in topk:
            if k in best["metrics"]:
                hr, mrr, ndcg = best["metrics"][k]
                log("  (k=%d) HR=%.4f, MRR=%.4f, NDCG=%.4f", k, hr, mrr, ndcg)
        self.params, self.opt_state = params, opt_state
        return best
