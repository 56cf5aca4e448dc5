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
either tier takes them.  The ``dual`` protocol (RML_DGATs, SoHRML)
splits two domains into the model's ``train_batches`` steps: the item
rows (u, i, j, w), every train pair ``neg_ratio`` times, and the social
rows (u_s, v, w_neg, w_s), every friend pair ``neg_ratio`` times with a
negative user outside u_s's friends, each domain on its own permutation
with weight-0 padding (``_sample_dual``).  With
``neg_sampling=popularity`` every item negative of the pairwise,
pointwise, CML and dual protocols, on every tier, is drawn in
proportion to the items' train popularity (``pop_cdf``; the sbpr and
tbpr protocols refuse it, as in the JAX trainer).  The model's
``build_aux`` runs first (the social
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
  stays in device memory either way).  The config shapes the tier as the
  JAX trainer's capacity tiers do, less their VMEM planning, which has no
  counterpart on the card (``_fused_options``; one log line says what
  runs):

  - the grouped epoch (``train.fused_groups`` G > 1, on the BPR, GMF,
    MLP/NeuMF and CML protocols; the rows protocol raises): users dealt
    to G groups of equal pair mass once a run (``_build_group_plan``),
    each group's whole epoch drawn in the permuted id space
    (``_sample_fused_groups``) and trained by one launch of the same
    epoch kernel on that group's slice of the user state
    (``_fused_grouped_epoch``): block-coordinate Adam, a user row's
    moments advancing only in its group's steps, items and dense params
    every step, CML's covariance regulariser spanning the frozen rows
    through their partial sums; the state is back in user order after
    the epoch, so checkpoints, resume and evaluation see no difference;
  - bf16 state storage (``train.fused_bf16``, on the BPR and rows
    protocols): the state rounded to bf16 on entry and on every write,
    row gradients rounded before their sums, f32 arithmetic; it yields to
    the grouped epoch and to ``train.fused_stream`` (both f32, as in the
    JAX trainer) and declines, to f32, where a padded table reaches
    32,768 rows;
  - ``train.fused_grouped``: in JAX the grouped epoch where the resident
    one overflows VMEM; on the card it never does, so it changes
    nothing (as ``train.sparse_rows`` below);
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
it; the JAX trainer's ``dropout_key``).  A model with ``pre_epoch``
(SoHRML's edge attention) has it called under ``no_grad`` before each
epoch, on the parameters that enter it, and its arrays replace those of
``aux``; they are not checkpointed, since the first epoch after a resume
computes them again from the loaded parameters.

``run(resume_from=...)`` restarts from a ``train/checkpoint.py``
checkpoint at its epoch + 1, and ``save.best=True`` checkpoints the best
epoch under ``saved_dir/<model>``; ``init_state`` applies the config's
warm start through the model's ``warm_start`` (NeuMF from
``gmf_pretrain`` and ``mlp_pretrain``, NAIS and NAIS_single from
``fism_pretrain``).  A warm-start key that the model does not read, or
one of its keys without the others, raises.

Under a mesh (``parallel/mesh.py``; ``Trainer(mesh=...)``, each rank
one process) every rank holds a full replica and owns a generator with
the same seed, so every rank draws the same whole epoch; the JAX
trainer's data-parallel tiers then split its steps
(cleverrec_tpu/train/trainer.py:505-600, 800-865, 984-1022, 1466-1640):

- the fused mesh-DP tier (the fused tier, ``train.fused_mesh_dp``, on by
  default): the steps padded to a multiple of D * max(K, 1) (K =
  ``train.dp_sync_every``, default 0: once an epoch), each rank's epoch
  kernel on its steps/D chunk against its replica, Adam from the count
  so far (and + round * K), and the ranks' deltas combined after each
  K-step round (``train.dp_delta_combine``, default ``mean``); the raw
  loss summed over the ranks before the sentinel correction, the Adam
  count advanced by steps/D;
- grouped under DP (``train.fused_groups``): each group's steps padded to
  a multiple of D, each rank's chunk of every group in the
  block-coordinate walk, ``n_sents / D`` sentinels a group off each
  rank's loss, one combine after the walk;
- the scan tier's local Adam (``train.dp_local_adam``, at a model axis
  of 1 under the gspmd exchange): each rank's steps/D chunk of whole
  batches through the scan tier, K defaulting to 2 and the combine to
  ``sum``, the loss the ranks' sum over the unpadded step count.

``_dp_delta_combine`` combines every float leaf of the state (parameters
and optimizer moments; the integer count passes) through the pure rule
``dp_combine_rule``, fed the ranks' summed deltas by one collective.

The scan tier without local Adam splits each step's batch over ``data``,
the JAX trainer's GSPMD layout (cleverrec_tpu/train/trainer.py:1498-1512,
1563-1575): every rank draws the whole batch, keeps its data chunk of
every leaf (``sharding.data_chunk``: ``torch.tensor_split``'s D
contiguous chunks, uneven ones too; a batch-shaped draw of the loss,
EATNN's friend edges, is drawn whole and cut), and computes its part of
the loss (``model.loss_parts``: the rows term over its chunk, plus the
table terms on data rank 0 alone); one all-reduce a step sums the parts'
gradients and losses over ``data`` (``sharding.over_data``), so the
step's loss and update are the whole batch's.  Work on whole tables
(graph propagation, NGCF's dropout masks) every rank repeats.  Under
``parallel.exchange=explicit`` the row lookups take this rank's chunk of
ids through ``row_sharded_gather``, and the sum over ``data`` of the
tables' gradients, which JAX's data-axis form makes in its backward, is
that all-reduce.  A model without ``loss_parts`` raises.  The grouped
pairwise, bucketed and dual tiers, to which the JAX trainer adds no batch
constraint, run the whole step on every rank, and every rank takes data
rank 0's gradients and loss (``sharding.over_data``, one all-reduce a
step), so that a kernel that sums in a run-dependent order
(``index_add``'s atomics on a card) leaves no two replicas apart; the
lazy row-Adam tier declines under a mesh.

A model axis M > 1 (cleverrec_tpu/train/trainer.py:290-300, 1340-1342,
1478-1512, 2016-2018): ``init_state`` draws the whole tables, then keeps
this rank's rows of each row-shardable table (``parallel/sharding.py``:
2-D, an entity cardinality high, the height a multiple of M), so the
model's parameters, and Adam's moments, are row blocks; other leaves are
replicated.  The fused tier declines (so does it under
``parallel.exchange=explicit`` on any mesh of two or more ranks), and so
does local Adam; every other tier runs through ``_steps``, whose loss
reads full-height views of the tables (``sharding.table_views``): under
``parallel.exchange=gspmd`` (the default) each row-sharded table
all-gathered once a step, under ``explicit`` every embedding table an
``ExchangeTable`` (row lookups through the row-sharded gather, any other
use the all-gathered table).  Gradients and the optimizer act on the
blocks; ``pre_epoch`` reads all-gathered tables.  A replicated leaf
takes model rank 0's gradient (``sharding.agree_grads``), so that
kernels that sum in a run-dependent order (``index_add`` on a card)
leave no two replicas of a model group apart.  ``save`` gathers the
blocks and their moments on every rank and rank 0 writes the unmeshed
format; ``resume`` and warm starts load whole tables and keep this rank's
rows.  Every rank evaluates (``full_sharded``: a dot-decomposable model
scores its own item rows) and can resume.  A ``1 x 1`` mesh runs the
unmeshed program.

``profile.dir``: ``run`` traces the second block of epochs (the first
pays the kernels' builds) once with ``torch.profiler`` (CPU activity,
and CUDA on a card) and writes a Chrome trace
``<profile.dir>/<model>_rank<R>.json`` (R 0 without a mesh), as the JAX
trainer traces its second block.

Parameters live in the model (``params`` is ``dict(model.named_parameters())``)
and are updated in place, so the evaluator always scores the current
tables.  Loss accounting matches the reference: per-batch summed loss
averaged over the number of batches (RankingRecommender.py:61).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time

import numpy as np
import torch

from cleverrec_tpu_torch import sampling
from cleverrec_tpu_torch.common import cdiv, make_optimizer
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data.arrays import DeviceData, build_device_data
from cleverrec_tpu_torch.data.dataset import RankingData
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models.base import RecModel, has_loss_parts
from cleverrec_tpu_torch.ops.sparse_adam import (dense_adam_leaf,
                                                 sparse_rows_adam)
from cleverrec_tpu_torch.ops.train import (EPOCH_FNS, LOG2, _cols, _side,
                                           bf16_fits, cml_sentinel_bias,
                                           grouped_rows, mlp_epoch_plan,
                                           rows_epoch_plan, sentinel_dims)
from cleverrec_tpu_torch.parallel import sharding
from cleverrec_tpu_torch.parallel.mesh import mesh_device
from cleverrec_tpu_torch.train import checkpoint
from cleverrec_tpu_torch.utils import trace

# History widths of the bucketed tier's buckets below h_max
# (cleverrec_tpu/train/trainer.py:1702-1704); h_max is the last.
HISTORY_WIDTHS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
# The protocols whose fused epoch has a grouped form
# (cleverrec_tpu/train/trainer.py:867-1319), and those with bf16 storage.
GROUPED_PROTOCOLS = ("pairwise_bpr", "pointwise_bce", "pointwise_mlp",
                     "cml_hinge")
BF16_PROTOCOLS = ("pairwise_bpr", "rows")
# The data-parallel tiers' delta combines (cleverrec_tpu/train/trainer.py:
# 36-75).
DP_COMBINES = ("mean", "sum", "count")


def _touched(d: torch.Tensor) -> torch.Tensor:
    """The ``count`` combine's touch test of a delta d: 1.0 for each row
    (of a 0-d or 1-d leaf: each element) with sum |d| > 0, else 0.0.  A
    row whose update rounds to nothing on a rank counts as untouched
    there."""
    a = d.abs()
    if d.ndim > 1:
        a = a.sum(dim=tuple(range(1, d.ndim)))
    return (a > 0).to(d.dtype)


def dp_combine_rule(old, dsum, tsum, mode: str, n: int):
    """A combined float leaf from its value before the round ``old``, the
    sum of the n ranks' deltas ``dsum`` and, for ``count``, the sum of
    their ``_touched`` vectors ``tsum``:

    - ``mean``: old + dsum / n, parameter averaging;
    - ``sum``: old + dsum, the first-order composition of the ranks'
      walks;
    - ``count``: old + dsum / max(tsum, 1) row by row, a row touched by c
      ranks divided by c.

    A pure function: the collectives only supply the sums."""
    if mode == "mean":
        return old + dsum / n
    if mode == "sum":
        return old + dsum
    if mode != "count":
        raise ValueError(f"train.dp_delta_combine={mode!r}: want one of "
                         f"{', '.join(DP_COMBINES)}")
    den = torch.clamp(tsum, min=1.0)
    return old + dsum / den.reshape(tuple(den.shape)
                                    + (1,) * (dsum.ndim - den.ndim))


def _dp_delta_combine(mesh, mode: str, leaves, olds) -> None:
    """Combine the ranks' float ``leaves`` (updated in place since
    ``olds``) over the mesh's data axis, in place: one all-reduce of every
    delta (and, for ``count``, every touch vector) joined flat, then
    ``dp_combine_rule``.  Every rank ends with the same bits."""
    deltas = [x - o for x, o in zip(leaves, olds)]
    parts = [d.reshape(-1) for d in deltas]
    if mode == "count":
        parts += [_touched(d).reshape(-1) for d in deltas]
    flat = mesh.all_reduce_sum(torch.cat(parts), "data")
    sums, off = [], 0
    for d in deltas:
        sums.append(flat[off:off + d.numel()].view(d.shape))
        off += d.numel()
    tsums = [None] * len(deltas)
    if mode == "count":
        for k, d in enumerate(deltas):
            n = d.shape[0] if d.ndim else 1
            tsums[k] = flat[off:off + n].view(d.shape[:1])
            off += n
    n = mesh.shape["data"]
    for x, o, ds, ts in zip(leaves, olds, sums, tsums):
        x.copy_(dp_combine_rule(o, ds, ts, mode, n))


def _state_leaves(params, opt_state) -> list[torch.Tensor]:
    """The float leaves a combine covers: every parameter and every
    tensor of the optimizer's state (Adam's moments, Adagrad's sums)."""
    leaves = [p.detach() for p in params.values()]
    if opt_state is not None:
        for f in dataclasses.fields(opt_state):
            value = getattr(opt_state, f.name)
            if isinstance(value, dict):
                leaves += list(value.values())
    return [x for x in leaves if x.is_floating_point()]


def popularity_cdf(dd: DeviceData, cfg: Config, sampler: str):
    """The items' cumulative train popularity [I] (float32, numpy) under
    ``neg_sampling=popularity``, else None: float64 degrees over every
    train pair, their cumsum over the total, then float32, as in the JAX
    trainer (cleverrec_tpu/train/trainer.py:128-139).  The sbpr, tbpr and
    samn protocols raise, as there: their negatives avoid the social
    items too."""
    mode = cfg.str("neg_sampling", "uniform")
    if mode not in ("uniform", "popularity"):
        raise ValueError(f"neg_sampling={mode}: want uniform or popularity")
    if mode == "uniform":
        return None
    if sampler in ("sbpr", "tbpr", "samn"):
        raise ValueError(
            "neg_sampling=popularity is not supported for the "
            f"{sampler!r} protocol (its negatives have social-exclusion "
            "semantics); use uniform")
    deg = np.zeros(dd.item_nums, np.float64)
    np.add.at(deg, dd.pos_i, 1.0)
    return (np.cumsum(deg) / max(deg.sum(), 1.0)).astype(np.float32)


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


def _p_stats(x):
    """(sum_a, sum_a2, sum_sq, col_sum) over the rows of x [N, d]: a is a
    row's sum, sq its squared norm (zero rows add nothing)."""
    row_a = x.sum(dim=1)
    return (row_a.sum(), (row_a * row_a).sum(), (x * x).sum(), x.sum(dim=0))


def _full_shapes(model) -> dict:
    """{name: shape} of the model's parameters at full height (a row
    block's name in ``model.row_shards`` at its table's height)."""
    shards = sharding.shards_of(model)
    return {n: (shards[n],) + tuple(p.shape[1:]) if n in shards
            else tuple(p.shape) for n, p in model.named_parameters()}


def _row_sharded_names(model, mesh) -> list[str]:
    """The parameters a mesh with a model axis above 1 splits by rows."""
    if mesh is None or mesh.shape["model"] == 1:
        return []
    return [n for n, shape in _full_shapes(model).items()
            if sharding._rowshardable(torch.empty(shape, device="meta"),
                                      model.meta, mesh)]


class Trainer:
    """Trains ``model`` on ``data`` on ``device`` (default ``cuda``; the
    model is moved there) and evaluates it with the ``Evaluator``; under
    a ``mesh`` (``parallel.Mesh``) on the mesh's device, which ``device``
    may name but not contradict."""

    def __init__(self, model: RecModel, data: RankingData, cfg: Config,
                 logger=None, device=None, mesh=None):
        self.exchange = cfg.str("parallel.exchange", "gspmd")
        if self.exchange not in sharding.EXCHANGES:
            raise ValueError(f"parallel.exchange={self.exchange!r}: want one "
                             f"of {', '.join(sharding.EXCHANGES)}")
        if (cfg.int("train.fused_groups", 0) > 1
                and getattr(model, "fused_protocol", None) == "rows"):
            raise ValueError(
                f"train.fused_groups: {model.name}'s rows epoch has no "
                "grouped form (the JAX trainer's grouped epoch takes the "
                f"{', '.join(GROUPED_PROTOCOLS)} protocols); unset it")
        self.dd: DeviceData = build_device_data(data)
        pop_cdf = popularity_cdf(self.dd, cfg, model.sampler)
        self.mesh = mesh
        self.device = mesh_device(device, mesh)
        self.model = model.to(self.device)
        # The row-sharded tables under a model axis above 1, and whether
        # the loss reads views of the tables (any mesh, explicit too).
        self._row_names = _row_sharded_names(model, mesh)
        self._viewed = mesh is not None and bool(
            self._row_names or self.exchange == "explicit")
        self.cfg = cfg
        self.logger = logger
        self._warm = self._warm_start_keys()
        self._pop_cdf = (None if pop_cdf is None
                         else torch.as_tensor(pop_cdf, device=self.device))
        # build_aux may restrict the epoch's pairs (the social family), so
        # it runs before epoch_pairs.
        self.model_aux = model.build_aux(self.dd, data)
        pos_u, pos_i = model.epoch_pairs(self.dd)
        self._pairs = (pos_u, pos_i)
        self.n_pairs = len(pos_u)
        self.batch_size = cfg.batch_size
        self.neg_ratio = cfg.neg_ratio
        self._epoch_rows = self._rows_per_epoch()
        self.steps_per_epoch = (
            model.train_batches if model.sampler == "dual"
            else cdiv(self._epoch_rows, self.batch_size))
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
        # The fused tier's form (_fused_options): the grouped epoch's
        # group count (0: ungrouped) and the state's storage.
        self._groups, self.table_dtype = 0, torch.float32
        # The fused tier's epoch functions by protocol: the kernels'
        # wrappers (ops.train.PLAIN_EPOCH_FNS holds their plain versions).
        self.epoch_fns = dict(EPOCH_FNS)
        # The data-parallel tiers' data ranks (1: none runs), K-step
        # rounds (0: one a epoch) and combine (_setup_dp).
        self._dp, self._sync_k, self._combine = 1, 0, None
        # What the data ranks of an autograd tier do with each step
        # (_setup_dp): None, "split" or "agree".
        self._data_mode = None
        self._real_steps = self.steps_per_epoch
        self.sparse_rows = self._sparse_rows_eligible()
        self.fused = not self.sparse_rows and self._fused_epoch_eligible()
        self._group_plan = (self._build_group_plan(pos_u, pos_i)
                            if self._groups else None)
        self.tier = self._tier_name()
        self._setup_dp()
        # Under a model axis the ranks of a group agree on each replicated
        # leaf's gradient (_steps).
        self._agree = mesh is not None and mesh.shape["model"] > 1
        if not self.fused and logger and (
                cfg.int("train.fused_groups", 0) > 1
                or cfg.bool("train.fused_bf16", False)
                or cfg.bool("train.fused_grouped", False)):
            logger.info("train.fused_groups, train.fused_bf16 and "
                        "train.fused_grouped shape the fused epoch tier, "
                        "which this run does not take")
        self._gen: torch.Generator | None = None
        self._dropout_gen: torch.Generator | None = None
        self.evaluator = Evaluator(model, self.dd, cfg, device=self.device,
                                   mesh=mesh)

    def _rows_per_epoch(self) -> int:
        """Rows an epoch: a pairwise or social pair fills neg_ratio rows, a
        pointwise pair one positive and neg_ratio negatives, a CML pair
        one row that carries its neg_ratio negatives."""
        s = self.model.sampler
        if s in ("pairwise", "sbpr", "tbpr", "dual"):
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
        if (self._per_step or self._grid is not None or not layout
                or sampler == "dual"):
            static = {}
        else:
            static = self._static_layout(pos_u, pos_i, padded)

        def put(a):
            return torch.as_tensor(a, device=self.device)

        self._static = {k: put(v) for k, v in static.items()}
        self._neg_rows, self._neg_lens = put(neg.rows), put(neg.lens)
        # The bitmap tests the popularity draws' candidates.
        self._neg_bits = (put(neg.bits) if self._pop_cdf is not None
                          and neg.bits is not None else None)
        if sampler == "dual":
            if not len(aux["sf_u"]):
                raise ValueError(f"{self.model.name}: no friend pairs")
            self._friends = sampling.table_to(aux["friends_tbl"],
                                              self.device)
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

    def _static_layout(self, pos_u, pos_i, padded: int) -> dict:
        """The whole-epoch sampler's static layout (numpy) of ``padded``
        rows."""
        aux, sampler = self.model_aux, self.model.sampler
        neg = aux.get("social_neg", self.dd.seen)
        head = (pos_u, pos_i, neg.lens)
        tail = (self.dd.item_nums, padded, self.neg_ratio)
        if sampler == "sbpr":
            spu = aux["spu_csr"]
            return sampling.sbpr_epoch_static(
                *head, sampling.csr_lens(spu), spu["off"], *tail)
        if sampler == "tbpr":
            ts, tw = aux["ts_csr"], aux["tw_csr"]
            return sampling.tbpr_epoch_static(
                *head, sampling.csr_lens(ts), ts["off"], sampling.csr_lens(tw),
                tw["off"], *tail)
        if sampler == "pointwise":
            return sampling.pointwise_epoch_static(*head, *tail)
        if sampler == "cml":
            # One row per pair, its negatives drawn per row: the pairwise
            # layout at neg_ratio 1.
            return sampling.pairwise_epoch_static(*head, *tail[:2], 1)
        return sampling.pairwise_epoch_static(*head, *tail)

    def _build_group_plan(self, pos_u, pos_i) -> dict:
        """The grouped epoch's plan, built once a run
        (cleverrec_tpu/train/trainer.py:905-1040): users sorted by pair
        count (stable), heaviest first, dealt to the G groups in snake
        order, a user's slot in its group its round, so that each group
        holds the same pair mass; ``new_of_old`` [U] and ``old_of_new``
        [G * rows] (a filler slot holds U, a zero pad row).  Each group's
        pairs in the permuted id space get their own static layout
        (``pairwise_epoch_static``; pointwise for GMF, MLP and NeuMF; CML
        the pairwise one at neg_ratio 1) padded to ``steps_eq`` steps, the
        most any group needs (under a data mesh of D ranks rounded up to a
        multiple of D); ``n_sents`` the padding rows of each group,
        ``grp_counts`` its real users, and ``seen`` the negatives' table
        with its rows permuted.  The ungrouped layout is dropped."""
        proto, g_n = self.model.fused_protocol, self._groups
        un, item_nums, b = self.dd.user_nums, self.dd.item_nums, \
            self.batch_size
        rows = grouped_rows(un, g_n)
        counts = np.bincount(pos_u, minlength=un)
        rank_of = np.argsort(-counts, kind="stable")
        r = np.arange(un)
        rnd, pos = r // g_n, r % g_n
        g_of_rank = np.where(rnd % 2 == 0, pos, g_n - 1 - pos)
        new_of_old = np.empty(un, np.int64)
        new_of_old[rank_of] = g_of_rank * rows + rnd
        old_of_new = np.full(g_n * rows, un, np.int64)
        old_of_new[new_of_old] = r
        neg = self.model_aux.get("social_neg", self.dd.seen)
        seen = sampling.permute_rows(neg, old_of_new, item_nums)
        pos_up = new_of_old[pos_u]
        order = np.argsort(pos_up, kind="stable")
        pos_up, pos_ip = pos_up[order].astype(np.int32), pos_i[order]
        bounds = np.searchsorted(pos_up, np.arange(g_n + 1) * rows)
        per_pair = {"pairwise_bpr": self.neg_ratio, "cml_hinge": 1}.get(
            proto, 1 + self.neg_ratio)
        if proto in ("pairwise_bpr", "cml_hinge"):
            static_fn = sampling.pairwise_epoch_static
            static_neg = self.neg_ratio if proto == "pairwise_bpr" else 1
        else:
            static_fn, static_neg = (sampling.pointwise_epoch_static,
                                     self.neg_ratio)
        pairs = np.diff(bounds)
        steps_eq = max(1, max(cdiv(int(n) * per_pair, b) for n in pairs))
        # Under the data mesh each rank runs steps_eq / D of every group.
        steps_eq = cdiv(steps_eq, self._dp) * self._dp
        padded = steps_eq * b
        statics = [static_fn(pos_up[lo:hi], pos_ip[lo:hi], seen.lens,
                             item_nums, padded, static_neg)
                   for lo, hi in zip(bounds[:-1], bounds[1:])]

        def put(a):
            return torch.as_tensor(a, device=self.device)

        plan = {"rows": rows, "new_of_old": new_of_old,
                "old_of_new": old_of_new, "statics": statics,
                "steps_eq": steps_eq,
                "n_sents": [padded - int(n) * per_pair for n in pairs],
                "rows_total": [int(n) * per_pair for n in pairs],
                "grp_counts": np.bincount(g_of_rank, minlength=g_n),
                "seen": seen,
                "dev": {"statics": [{k: put(v) for k, v in st.items()}
                                    for st in statics],
                        "seen": sampling.MemberTable(
                            put(seen.rows), put(seen.lens),
                            put(seen.bits) if self._pop_cdf is not None
                            and seen.bits is not None else None),
                        "old": put(old_of_new), "new": put(new_of_old)}}
        self._static = {}
        self.steps_per_epoch = g_n * steps_eq
        if self.logger:
            self.logger.info(
                "grouped fused epoch: %d user groups x %d rows, %d steps a "
                "group", g_n, rows, steps_eq,
                extra={"groups": {"groups": g_n, "rows": rows,
                                  "steps": steps_eq}})
        return plan

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
        if self.mesh is not None and self.mesh.size > 1:
            # The JAX trainer's lazy tier is unmeshed only.
            if self.logger:
                self.logger.info("train.sparse_rows_force: the lazy row-Adam "
                                 "tier declines under a mesh, as in the JAX "
                                 "trainer")
            return False
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
        dp = self.mesh.shape["data"] if self.mesh is not None else 1
        if self.mesh is not None and self.mesh.size > 1 and (
                self.mesh.shape["model"] > 1 or self.exchange == "explicit"):
            # cleverrec_tpu/train/trainer.py:293-297: row-sharded tables
            # and the explicit exchange take the scan path.
            if self.logger:
                self.logger.info(
                    "the fused epoch kernel declines under a %s (the JAX "
                    "trainer's rule); the scan tier trains",
                    "model axis above 1" if self.mesh.shape["model"] > 1
                    else "parallel.exchange=explicit")
            return False
        if dp > 1 and not self.cfg.bool("train.fused_mesh_dp", True):
            if self.logger:
                self.logger.info("train.fused_mesh_dp=False: the data mesh "
                                 "trains through the scan tier")
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
        self._dp = dp
        self._fused_options(proto)
        return True

    def _fused_options(self, proto: str) -> None:
        """The fused tier's form, from the options the config names
        (cleverrec_tpu/train/trainer.py:337-476, less its VMEM planning,
        which has no counterpart on the card):

        - ``train.fused_groups`` G > 1: the grouped epoch with G user
          groups (``_build_group_plan``) on the ``GROUPED_PROTOCOLS``
          (the rows protocol raised in ``__init__``);
        - ``train.fused_bf16``: bf16 state storage on the
          ``BF16_PROTOCOLS``, unless the grouped epoch or
          ``train.fused_stream`` takes precedence (both store f32 in the
          JAX trainer) or a padded table reaches ``BF16_MAX_ROWS`` rows
          (the JAX planners' decline); other protocols store f32;
        - ``train.fused_grouped``: in JAX the grouped epoch where the
          resident one overflows VMEM; the card's resident epoch never
          overflows, so it changes nothing;
        - ``train.fused_stream`` (rows): the same kernel here, the state
          in device memory either way; under a data mesh it does not
          apply (the JAX trainer streams only unmeshed), so bf16 storage
          does not yield to it there.

        One log line says what runs."""
        cfg, notes = self.cfg, []
        groups = cfg.int("train.fused_groups", 0)
        if groups > 1:
            self._groups = groups
            notes.append(f"the grouped epoch, {groups} user groups "
                         "(train.fused_groups; block-coordinate Adam over "
                         "the user table, f32)")
        stream = proto == "rows" and cfg.bool("train.fused_stream", False)
        if stream and self._dp > 1:
            # The JAX trainer streams only at mesh_dp == 1.
            stream = False
            notes.append("train.fused_stream does not apply under a data "
                         "mesh (the JAX trainer streams only unmeshed)")
        elif stream:
            notes.append("train.fused_stream: the streamed rows epoch is "
                         "the same kernel here (the state stays in device "
                         "memory)")
        if cfg.bool("train.fused_bf16", False):
            heights = sentinel_dims(self.dd.user_nums, self.dd.item_nums)
            if proto not in BF16_PROTOCOLS:
                notes.append(f"train.fused_bf16 does not apply: the {proto} "
                             "epoch stores f32, as in the JAX trainer")
            elif self._groups:
                notes.append("train.fused_bf16 yields to the grouped epoch, "
                             "which stores f32")
            elif stream:
                notes.append("train.fused_bf16 yields to train.fused_stream, "
                             "which stores f32")
            elif not bf16_fits(self.dd.user_nums, self.dd.item_nums):
                notes.append(f"train.fused_bf16 declined: a padded table of "
                             f"{max(heights)} rows is past bf16 storage's "
                             "32767; the epoch stores f32")
            else:
                self.table_dtype = torch.bfloat16
                notes.append("bf16 state storage (f32 compute, "
                             "train.fused_bf16)")
        if cfg.bool("train.fused_grouped", False):
            notes.append("train.fused_grouped changes nothing: the resident "
                         "epoch has no VMEM ceiling to overflow on the card")
        if notes and self.logger:
            self.logger.info("fused epoch kernel: %s", "; ".join(notes),
                             extra={"fused_form": {
                                 "groups": self._groups,
                                 "storage": str(self.table_dtype)}})

    def _tier_name(self) -> str:
        """The tier ``_run_epoch`` takes."""
        if self._grid is not None:
            return "grouped_pairs"
        if self._buckets is not None:
            return "bucketed"
        if self.sparse_rows:
            return "sparse_rows"
        if self._group_plan is not None:
            return "fused_grouped"
        if self.fused:
            return "fused"
        return "dual" if self.model.sampler == "dual" else "scan"

    def _setup_dp(self) -> None:
        """The data mesh's reading of the config
        (cleverrec_tpu/train/trainer.py:213-230, 505-530, 1466-1512): the
        fused tier trains mesh-DP (grouped too), the scan tier local Adam
        with ``train.dp_local_adam``; their steps padded to a multiple of
        D * max(K, 1) and the combine checked.  Without local Adam the
        scan tier splits each batch over ``data``; any other tier runs
        the whole step on every rank, the ranks agreeing on its gradients.
        One log line says which, and names the data-parallel options set
        that the run does not apply."""
        cfg, mesh = self.cfg, self.mesh
        dp = mesh.shape["data"] if mesh is not None else 1
        n_model = mesh.shape["model"] if mesh is not None else 1
        # Local Adam at a model axis of 1 under gspmd alone
        # (cleverrec_tpu/train/trainer.py:1478-1483).
        local = (self.tier == "scan" and n_model == 1
                 and self.exchange != "explicit"
                 and cfg.bool("train.dp_local_adam", False))
        split = dp > 1 and (self.tier in ("fused", "fused_grouped") or local)
        applied = {"train.dp_local_adam": local or not cfg.bool(
                       "train.dp_local_adam", False),
                   "train.dp_sync_every": split
                   and self.tier != "fused_grouped",
                   "train.dp_delta_combine": split,
                   "train.fused_mesh_dp": dp > 1}
        unused = [k for k, on in applied.items() if k in cfg and not on]
        note = (f"; {', '.join(unused)} not applied (the JAX trainer "
                "ignores them here too)" if unused else "")
        tables = ""
        if n_model > 1:
            tables = (f"; {', '.join(self._row_names) or 'no table'} "
                      f"row-sharded over {n_model} model ranks, the loss "
                      f"on full views ({self.exchange}: "
                      + ("one all-gather a table a step)"
                         if self.exchange == "gspmd" else
                         "row lookups through the row-sharded gather)"))
        if dp == 1:
            if unused and self.logger:
                self.logger.info("%s shape a data mesh of 2 or more ranks, "
                                 "which this run does not have",
                                 ", ".join(unused))
            if n_model > 1 and self.logger:
                self.logger.info(
                    "mesh 1x%d: the %s tier%s", n_model, self.tier, tables,
                    extra={"mesh_tier": {"tier": self.tier, "data": 1,
                                         "model": n_model,
                                         "tables": self._row_names,
                                         "exchange": self.exchange}})
            return
        tag = f"mesh {dp}x{n_model}"
        if split:
            self._dp = dp
            if self.tier == "fused_grouped":
                # One combine after the block-coordinate walk.
                self._sync_k = 0
            else:
                self._sync_k = cfg.int("train.dp_sync_every",
                                       2 if local else 0)
                self._pad_dp_steps(dp * max(self._sync_k, 1))
            self._combine = cfg.str("train.dp_delta_combine",
                                    "sum" if local else "mean")
            if self._combine not in DP_COMBINES:
                raise ValueError(
                    f"train.dp_delta_combine={self._combine!r}: want one of "
                    f"{', '.join(DP_COMBINES)}")
            if local:
                self.tier = "scan_local_adam"
            if self.logger:
                self.logger.info(
                    "%s: the %s tier, each rank %d of %d steps, the deltas "
                    "combined by %s %s%s", tag, self.tier,
                    self.steps_per_epoch // dp, self.steps_per_epoch,
                    self._combine,
                    f"every {self._sync_k} steps" if self._sync_k
                    else "once an epoch", note,
                    extra={"mesh_tier": {"tier": self.tier, "data": dp,
                                         "sync_every": self._sync_k,
                                         "combine": self._combine}})
            return
        if self.tier == "scan":
            if not has_loss_parts(self.model):
                raise ValueError(
                    f"{self.model.name} has no loss_parts: the scan tier's "
                    f"batch split over 'data' ({tag}) needs the loss in "
                    "per-rank parts")
            self._data_mode = "split"
            sizes = {hi - lo for lo, hi in (
                sharding.chunk_bounds(self.batch_size, dp, d)
                for d in range(dp))}
            chunk = "-".join(str(n) for n in sorted(sizes))
            if self.logger:
                self.logger.info(
                    "%s: the scan tier, the batch split over 'data' (%s of %d "
                    "rows a data rank; its loss part, the table terms on data "
                    "rank 0; one all-reduce of the parts' gradients a step; "
                    "the %s exchange)%s%s", tag, chunk, self.batch_size,
                    self.exchange, tables, note,
                    extra={"mesh_tier": {"tier": self.tier, "data": dp,
                                         "model": n_model, "split": "batch",
                                         "chunk": chunk,
                                         "exchange": self.exchange}})
            return
        self._data_mode = "agree"
        if self.logger:
            self.logger.info("%s: the %s tier runs the whole step on every "
                             "data rank (replicated, as the JAX trainer adds "
                             "no batch constraint to it; data rank 0's "
                             "gradients taken)%s%s", tag, self.tier,
                             tables, note,
                             extra={"mesh_tier": {"tier": self.tier,
                                                  "data": dp,
                                                  "model": n_model}})

    def _pad_dp_steps(self, quantum: int) -> None:
        """Pad the epoch to a multiple of ``quantum`` steps: the static
        layout rebuilt at the padded size (the JAX trainer's
        ``_ensure_dp_static``), the padding rows sentinels."""
        steps = cdiv(self.steps_per_epoch, quantum) * quantum
        if steps == self.steps_per_epoch:
            return
        self.steps_per_epoch = steps
        padded = steps * self.batch_size
        self._n_sent = padded - self._epoch_rows
        if self._static:
            self._static = {
                k: torch.as_tensor(v, device=self.device)
                for k, v in self._static_layout(*self._pairs,
                                                padded).items()}

    # -- one epoch ------------------------------------------------------
    def sample_epoch(self) -> dict:
        """The next epoch's draw of the model's sampler, each column
        [steps, B] on the device (the dual protocol's item columns
        [steps, B_i] and social columns [steps, B_s]); for the grouped
        epoch, ``j`` [G_pad, T] (a negative a cell, ``item_nums`` on pad
        cells) and ``perm`` [steps, G/step] (the groups of each step); for
        the bucketed tier, ``buckets``, each bucket's draw in plan
        order.  Inside the span ``train.sample``."""
        with trace.span("train.sample"):
            return self._sample_epoch()

    def _sample_epoch(self) -> dict:
        if self._gen is None:
            raise RuntimeError("call init_state first")
        if self.model.sampler == "dual":
            return self._sample_dual()
        if self._group_plan is not None:
            return self._sample_fused_groups()
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
        pop = ({"pop_cdf": self._pop_cdf, "bits": self._neg_bits}
               if self._pop_cdf is not None else {})
        return self._tensors_fn()(*head, *(self._csr[n] for n in lists),
                                  self._epoch_rows, self.steps_per_epoch,
                                  self.batch_size, **pop)

    def _tensors_fn(self):
        """The model's whole-epoch sampler of ``sampling``."""
        return {"sbpr": sampling.sbpr_epoch_tensors,
                "tbpr": sampling.tbpr_epoch_tensors,
                "pointwise": sampling.pointwise_epoch_tensors,
                "pairwise": sampling.pairwise_epoch_tensors,
                "cml": functools.partial(sampling.cml_epoch_tensors,
                                         neg_ratio=self.neg_ratio)}[
                                             self.model.sampler]

    def _sample_fused_groups(self) -> dict:
        """The grouped epoch's draw: ``groups``, each group's whole epoch
        of ``steps_eq`` steps in the permuted id space, drawn in group
        order from the trainer's generator over the group's static
        layout and the permuted seen table."""
        plan, dev = self._group_plan, self._group_plan["dev"]
        seen = dev["seen"]
        pop = ({"pop_cdf": self._pop_cdf, "bits": seen.bits}
               if self._pop_cdf is not None else {})
        fn = self._tensors_fn()
        return {"groups": [
            fn(self._gen, static, seen.rows, seen.lens, total,
               plan["steps_eq"], self.batch_size, **pop)
            for static, total in zip(dev["statics"], plan["rows_total"])]}

    def _seen_table(self) -> sampling.MemberTable:
        """The table the item negatives avoid, as tensors."""
        return sampling.MemberTable(self._neg_rows, self._neg_lens,
                                    self._neg_bits)

    def _sample_dual(self) -> dict[str, torch.Tensor]:
        """The dual protocol's epoch (cleverrec_tpu/train/trainer.py:
        1960-2005): m_i = n_pairs * neg_ratio item rows and m_s =
        max(friend pairs * neg_ratio, 1) social rows, each domain padded
        to ``steps`` batches of cdiv(m, steps) rows on its own
        permutation, drawn by ``pairwise_batch`` and
        ``social_pairwise_batch``."""
        steps, nr = self.steps_per_epoch, self.neg_ratio
        m_i = self._epoch_rows
        m_s = max(len(self.aux["sf_u"]) * nr, 1)
        perm_i, valid_i = sampling.epoch_permutation(
            self._gen, m_i, steps * cdiv(m_i, steps))
        perm_s, valid_s = sampling.epoch_permutation(
            self._gen, m_s, steps * cdiv(m_s, steps))
        batch = {**sampling.pairwise_batch(
            self._gen, perm_i, valid_i, self.aux["pos_u"], self.aux["pos_i"],
            self._seen_table(), self.dd.item_nums, nr, self._pop_cdf),
            **sampling.social_pairwise_batch(
                self._gen, perm_s, valid_s, self.aux["sf_u"],
                self.aux["sf_v"], self._friends, self.dd.user_nums, nr)}
        return {k: v.reshape(steps, -1) for k, v in batch.items()}

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
        j = sampling.draw_negatives(
            self._gen, self._seen_table(), pg["pg_user"], self.dd.item_nums,
            pg["pg_pos"].shape, self._pop_cdf)
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
                bucket["rows"], bucket["steps"], bucket["batch"],
                pop_cdf=self._pop_cdf, bits=self._neg_bits)
        j = sampling.draw_negatives(
            self._gen, self._seen_table(), dev["g_user"], self.dd.item_nums,
            dev["g_pos"].shape, self._pop_cdf)
        gt = torch.where(dev["g_y"] > 0, dev["g_pos"], j)
        gt = torch.where(dev["g_w"] > 0, gt, self.dd.item_nums)
        perm = torch.randperm(dev["g_user"].shape[0], generator=self._gen,
                              device=self.device)
        return {"gt": gt, "perm": perm.reshape(bucket["steps"],
                                               bucket["per_step"])}

    def _run_epoch(self, params, opt_state, tensors):
        """Train one epoch on given sampled tensors ([steps, B] each, the
        grouped epoch's ``j`` and ``perm``, the bucketed tier's
        ``buckets``, or the grouped fused epoch's ``groups``); returns
        (params, opt_state, mean per-step loss as a 0-dim tensor).
        ``params`` must be the model's own parameters."""
        if self._grid is not None:
            return self._grouped_epoch(params, opt_state, tensors)
        if self._buckets is not None:
            return self._bucketed_epoch(params, opt_state,
                                        tensors["buckets"])
        if self.sparse_rows:
            return self._sparse_rows_epoch(params, opt_state, tensors)
        if self._group_plan is not None:
            return self._fused_grouped_epoch(params, opt_state,
                                             tensors["groups"])
        if self.fused:
            return self._fused_epoch(params, opt_state, tensors)
        if self.tier == "scan_local_adam":
            return self._local_adam_epoch(params, opt_state, tensors)
        return self._scan_epoch(params, opt_state, tensors)

    def _dp_rounds(self, params, opt_state, tensors, run):
        """This rank's chunk of the epoch's [steps, ...] ``tensors`` (the
        steps/D from data index x steps/D), in rounds of K steps (the
        whole chunk when K is 0): ``run(part, offset)`` trains one round's
        steps ``part``, ``offset`` steps into the chunk, in place and
        returns their summed loss; the ranks' state is combined after
        each round.  Returns (steps/D, the loss summed over the rounds and
        the ranks)."""
        local = tensors["u"].shape[0] // self._dp
        first = self.mesh.index("data") * local
        width = self._sync_k or local
        leaves = _state_leaves(params, opt_state)
        raw = torch.zeros((), dtype=torch.float32, device=self.device)
        for lo in range(0, local, width):
            part = {k: v[first + lo:first + lo + width]
                    for k, v in tensors.items()}
            olds = [x.clone() for x in leaves]
            raw = raw + run(part, lo)
            _dp_delta_combine(self.mesh, self._combine, leaves, olds)
        return local, self.mesh.all_reduce_sum(raw, "data")

    def _views(self, exchange=None):
        """The tables' full-height views for a loss or a read under the
        mesh (``sharding.table_views``; ``exchange`` default the run's),
        or nothing to do."""
        if not self._viewed:
            return contextlib.nullcontext()
        return sharding.table_views(self.model, self.mesh,
                                    exchange or self.exchange)

    def _steps(self, params, opt_state, batches, loss_fn, aux=None):
        """One optimizer step a batch on ``loss_fn(batch, aux)`` (default
        aux: ``self.aux``), each batch with the trainer's
        ``dropout_gen``; returns (params, opt_state, the batches' losses
        [n]).  Under a data axis, as ``_data_mode`` says: ``split``, each
        rank's part's gradients and loss (``_scan_epoch``'s chunks)
        summed over ``data``; ``agree``, data rank 0's taken.
        Under a model axis the loss reads the tables through ``_views``,
        the gradients reach the row blocks, and the ranks of a model group
        take one gradient of each replicated leaf
        (``sharding.agree_grads``)."""
        names = list(params)
        leaves = [params[k] for k in names]
        aux = self.aux if aux is None else aux
        mode, mesh = self._data_mode, self.mesh
        losses = torch.zeros(len(batches), dtype=torch.float32,
                             device=self.device)
        for s, batch in enumerate(batches):
            with trace.span("train.step"):
                with self._views():
                    loss = loss_fn({**batch,
                                    "dropout_gen": self._dropout_gen}, aux)
                # A parameter outside the loss (NeuMF's h_gmf and h_mlp,
                # kept for the warm start) gets a zero gradient, as under
                # JAX: Adam then leaves it and its moments as they were.
                grads = dict(zip(names, [
                    torch.zeros_like(p) if g is None else g
                    for p, g in zip(leaves, torch.autograd.grad(
                        loss, leaves, allow_unused=True))]))
                loss = loss.detach()
                if mode:
                    grads, loss = sharding.over_data(
                        grads, loss, mesh, take_rank0=mode == "agree")
                if self._agree:
                    grads = sharding.agree_grads(
                        grads, sharding.shards_of(self.model), mesh)
                opt_state = self.optimizer.update(params, grads, opt_state)
                self.model.postprocess()
                losses[s] = loss
        return params, opt_state, losses

    @staticmethod
    def _batches(tensors):
        return [{k: v[s] for k, v in tensors.items()}
                for s in range(tensors["u"].shape[0])]

    def _scan_epoch(self, params, opt_state, tensors):
        """The scan and dual tiers: each step on this data rank's chunk of
        its batch and its part of the loss (the model's ``loss_parts``,
        the table terms on data rank 0 alone) where the batch splits, else
        on the whole batch and the whole loss."""
        mesh = self.mesh if self._data_mode == "split" else None

        def part(batch, aux):
            return sharding.part_of_loss(self.model.loss_parts(batch, aux),
                                         mesh)
        params, opt_state, losses = self._steps(
            params, opt_state,
            [sharding.data_chunk(b, mesh) for b in self._batches(tensors)],
            part)
        return params, opt_state, losses.mean()

    def _local_adam_epoch(self, params, opt_state, tensors):
        """The scan tier's local Adam under the data mesh
        (cleverrec_tpu/train/trainer.py:1466-1640): this rank's steps/D
        chunk of whole batches in K-step rounds (``_dp_rounds``); the
        loss is the ranks' sum over the unpadded step count (padding
        steps are all weight 0)."""
        def run(part, _):
            return self._steps(params, opt_state, self._batches(part),
                               self.model.loss)[2].sum()

        _, raw = self._dp_rounds(params, opt_state, tensors, run)
        return params, opt_state, raw / self._real_steps

    def _grouped_epoch(self, params, opt_state, tensors):
        pg, j = self._pg, tensors["j"]
        batches = [{"gu": pg["pg_user"][sel], "gi": pg["pg_pos"][sel],
                    "gj": j[sel], "gw": pg["pg_w"][sel]}
                   for sel in tensors["perm"]]
        params, opt_state, losses = self._steps(
            params, opt_state, batches, self.model.loss_grouped_pairwise)
        return params, opt_state, losses.mean()

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
            params, opt_state, losses = self._steps(
                params, opt_state, batches, loss_fn, bucket["aux"])
            total = total + losses.mean() * bucket["steps"]
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
        """One fused epoch: the epoch kernel over every step, or under the
        data mesh over this rank's chunk in K-step rounds with the ranks'
        state combined after each (``_dp_rounds``); the Adam count
        advances by the steps a rank ran (padded steps are Adam steps
        too, as in the JAX trainer), the loss is the raw sum (over the
        ranks) less the sentinel terms, over the steps."""
        steps, count = tensors["u"].shape[0], opt_state.count
        if self._dp == 1:
            raw = self._fused_apply(params, opt_state, tensors, count)
            ran = steps
        else:
            ran, raw = self._dp_rounds(
                params, opt_state, tensors,
                lambda part, lo: self._fused_apply(params, opt_state, part,
                                                   count + lo))
        opt_state.count = count + ran
        return params, opt_state, self._fused_loss(raw, steps)

    def _fused_loss(self, raw, steps: int):
        """The epoch's mean loss from the raw sum over ``steps`` steps:
        the BPR, GMF and CML epochs' sentinel slots' terms taken off
        (``n_sent * LOG2``, CML's ``n_sent * cml_sentinel_bias``)."""
        proto = self.model.fused_protocol
        if proto in ("pairwise_bpr", "pointwise_bce"):
            raw = raw - self._n_sent * LOG2
        elif proto == "cml_hinge":
            raw = raw - self._n_sent * cml_sentinel_bias(
                self.model.margin, self.dd.item_nums, self.neg_ratio)
        return raw / steps

    def _fused_apply(self, params, opt_state, tensors, t0: int):
        """The protocol's epoch function over ``tensors`` ([steps, B]
        columns) from Adam step ``t0``, on the state in place; returns the
        raw summed loss (sentinel slots' terms included)."""
        u_sent, i_sent = (n - 1 for n in sentinel_dims(self.dd.user_nums,
                                                       self.dd.item_nums))
        inval = tensors["w"] == 0

        def ids(name, sentinel):
            return torch.where(inval, sentinel, tensors[name]).to(
                torch.int32).contiguous()

        def col(name):
            return tensors[name].to(torch.float32).contiguous()

        proto, lr = self.model.fused_protocol, self.cfg.lr

        def with_moments(name):
            return (params[name].detach(), opt_state.mu[name],
                    opt_state.nu[name])

        if proto == "pairwise_bpr":
            (p, mp, vp), (q, mq, vq) = map(with_moments, ("P", "Q"))
            raw = self.epoch_fns["bpr"](
                p, q, mp, vp, mq, vq, ids("u", u_sent), ids("i", i_sent),
                ids("j", i_sent), t0, lr=lr, reg=self.model.reg,
                table_dtype=self.table_dtype)
        elif proto == "pointwise_bce":
            (p, mp, vp), (q, mq, vq), (h, mh, vh) = map(
                with_moments, ("P", "Q", "h_gmf"))
            raw = self.epoch_fns["gmf"](
                p, q, h, mp, vp, mq, vq, mh, vh, ids("u", u_sent),
                ids("i", i_sent), col("y"), t0, lr=lr, reg=self.model.reg)
        elif proto == "cml_hinge":
            (p, mp, vp), (q, mq, vq) = map(with_moments, ("P", "Q"))
            negs = torch.where(inval[..., None], i_sent, tensors["negs"]).to(
                torch.int32).contiguous()
            margin, item_nums = self.model.margin, self.dd.item_nums
            raw = self.epoch_fns["cml"](
                p, q, mp, vp, mq, vq, ids("u", u_sent), ids("i", i_sent),
                negs, t0, lr=lr, reg=self.model.reg, margin=margin,
                item_nums=item_nums)
        elif proto == "rows":
            spec = self.model.fused_rows_spec()
            sides = [sd for _, sd in spec["planes"]]
            planes = [ids(name, u_sent if sd == "u" else i_sent)
                      for name, sd in spec["planes"]]
            state = [x for t in (params, opt_state.mu, opt_state.nu)
                     for x in spec["pack"](t)]
            raw = self.epoch_fns["rows"](
                *state, planes, [col(n) for n in spec["floats"]], t0,
                sides=sides, spec=spec, lr=lr, table_dtype=self.table_dtype)
        else:
            raw = self._fused_mlp(params, opt_state, ids("u", u_sent),
                                  ids("i", i_sent), col("y"), col("w"), t0)
        return raw

    def _fused_grouped_epoch(self, params, opt_state, groups):
        """The grouped fused epoch (cleverrec_tpu/train/trainer.py:
        1042-1282) on each group's draw ``groups[g]``: the user state (P,
        or MLP's and NeuMF's joined user table, and its moments) permuted
        into group order with one zero pad row behind the fillers; group
        g's epoch kernel on its slice of ``rows`` rows, ids shifted by
        g * rows and invalid slots at ``sentinel_dims(rows, I)``, with
        Adam from step count + g * steps (block-coordinate: a user row's
        moments move only in its group's steps; items and dense params
        every step); CML's launches carry the frozen rows' partial sums,
        kept as running totals across the groups.  Then the state goes
        back to the user order, the count advances by G * steps and the
        loss is the groups' (sentinel terms off) over G * steps.

        Under the data mesh (cleverrec_tpu/train/trainer.py:984-1022) each
        rank walks the groups over its steps/D chunk of each group's draw,
        group g's launch from count + g * steps/D, takes n_sents[g] / D
        sentinels off its loss, and reports its part of the epoch's mean
        (over the global G * steps); the parts are summed over the ranks,
        the state combined once after the walk, and the count advances by
        G * steps / D."""
        if self._dp == 1:
            return params, opt_state, self._grouped_walk(params, opt_state,
                                                         groups)
        steps = groups[0]["u"].shape[0]
        local = steps // self._dp
        first = self.mesh.index("data") * local
        leaves = _state_leaves(params, opt_state)
        olds = [x.clone() for x in leaves]
        part = self._grouped_walk(
            params, opt_state,
            [{k: v[first:first + local] for k, v in draw.items()}
             for draw in groups], steps)
        _dp_delta_combine(self.mesh, self._combine, leaves, olds)
        return params, opt_state, self.mesh.all_reduce_sum(part, "data")

    def _grouped_walk(self, params, opt_state, groups, steps=None):
        """The block-coordinate walk of ``_fused_grouped_epoch`` over the
        groups' draws ``groups`` ([local, B] columns each), in place: the
        count advances by G * local; returns the loss over G * ``steps``
        (default local), n_sents[g] * local / steps sentinels of group g
        taken off."""
        plan, proto = self._group_plan, self.model.fused_protocol
        rows, lr, reg = plan["rows"], self.cfg.lr, getattr(self.model,
                                                          "reg", 0.0)
        u_sent, i_sent = (n - 1 for n in sentinel_dims(rows,
                                                       self.dd.item_nums))
        trio = (params, opt_state.mu, opt_state.nu)
        mlp = proto == "pointwise_mlp"
        spec = self.model.fused_mlp_spec() if mlp else None
        names = spec["u"] if mlp else ("P",)
        old = plan["dev"]["old"]

        def perm_in(t):
            x = _joined(t, names)
            return torch.cat([x, x.new_zeros((1, x.shape[1]))])[old]
        user = [perm_in(t) for t in trio]
        if mlp:
            item = [_joined(t, spec["i"]) for t in trio]
            dense = [[t[n].detach() for n in spec["dense"]] for t in trio]
        else:
            item = [t["Q"].detach() for t in trio]
        local = groups[0]["u"].shape[0]
        steps = local if steps is None else steps
        count = opt_state.count
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        if proto == "cml_hinge":
            tot = _p_stats(user[0])
            bias = cml_sentinel_bias(self.model.margin, self.dd.item_nums,
                                     self.neg_ratio)
        for g, draw in enumerate(groups):
            g0 = g * rows
            inval = draw["w"] == 0
            u = torch.where(inval, u_sent, draw["u"] - g0).to(
                torch.int32).contiguous()
            i = torch.where(inval, i_sent, draw["i"]).to(
                torch.int32).contiguous()
            p, mp, vp = (x[g0:g0 + rows] for x in user)
            t0 = count + g * local
            n_sent = plan["n_sents"][g] / (steps // local)
            if proto == "pairwise_bpr":
                j = torch.where(inval, i_sent, draw["j"]).to(
                    torch.int32).contiguous()
                raw = self.epoch_fns["bpr"](p, item[0], mp, vp, item[1],
                                            item[2], u, i, j, t0, lr=lr,
                                            reg=reg)
                total = total + (raw - n_sent * LOG2)
            elif proto == "pointwise_bce":
                h = [t["h_gmf"].detach() for t in trio]
                raw = self.epoch_fns["gmf"](
                    p, item[0], h[0], mp, vp, item[1], item[2], h[1], h[2],
                    u, i, draw["y"].to(torch.float32).contiguous(), t0,
                    lr=lr, reg=reg)
                total = total + (raw - n_sent * LOG2)
            elif proto == "cml_hinge":
                negs = torch.where(inval[..., None], i_sent, draw["negs"]).to(
                    torch.int32).contiguous()
                res = _p_stats(p)
                fro = tuple(a - b for a, b in zip(tot, res))
                ur = int(plan["grp_counts"][g])
                raw = self.epoch_fns["cml"](
                    p, item[0], mp, vp, item[1], item[2], u, i, negs, t0,
                    lr=lr, reg=reg, margin=self.model.margin,
                    item_nums=self.dd.item_nums,
                    frozen=(ur, self.dd.user_nums - ur, *fro))
                tot = tuple(a + b for a, b in zip(fro, _p_stats(p)))
                total = total + (raw - n_sent * bias)
            else:
                col = {k: draw[k].to(torch.float32).contiguous()
                       for k in ("y", "w")}
                total = total + self.epoch_fns["mlp"](
                    p, item[0], dense[0], mp, item[1], dense[1], vp,
                    item[2], dense[2], u, i, col["y"], col["w"], t0,
                    spec=spec, lr=lr)
        new = plan["dev"]["new"]
        for t, x in zip(trio, user):
            back = x[new]
            if len(names) == 1:
                t[names[0]].detach().copy_(back)
            else:
                _split_back(t, names, back)
        if mlp:
            for t, x in zip(trio, item):
                _split_back(t, spec["i"], x)
        opt_state.count = count + len(groups) * local
        return total / (len(groups) * steps)

    def _fused_mlp(self, params, opt_state, u, i, y, w, t0):
        """The tower epoch over the model's spec: each side's tables joined
        on the feature axis (NeuMF: [P_gmf | P_mlp]) for the epoch, then
        split back; the dense params are updated where they are.  Params
        outside the spec pass through unchanged."""
        spec = self.model.fused_mlp_spec()
        state = []
        for t in (params, opt_state.mu, opt_state.nu):
            state += [_joined(t, spec["u"]), _joined(t, spec["i"]),
                      [t[n].detach() for n in spec["dense"]]]
        raw = self.epoch_fns["mlp"](*state, u, i, y, w, t0, spec=spec,
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
        # A model that holds row blocks (an earlier init_state) gets its
        # full-height tables back first: the draw is the unmeshed run's.
        sharding.unshard_model(self.model)
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
        if self._row_names:
            # cleverrec_tpu/train/trainer.py:2016-2018: placed after the
            # model's own init and the warm start.
            sharding.shard_model(self.model, self.mesh, self._row_names)
            params = dict(self.model.named_parameters())
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

    def save(self, path: str, params, opt_state, epoch: int) -> str | None:
        """A train-state checkpoint of this run after ``epoch`` epochs, in
        the unmeshed format; returns its path.  Under a mesh every rank
        calls it (the row blocks and their moments are gathered over
        ``model``) and rank 0 alone writes (the others return None)."""
        shards = sharding.shards_of(self.model)
        if shards:
            params = sharding.full_tensors(params, shards, self.mesh)
            opt_state = checkpoint.map_optimizer_state(
                opt_state, lambda t: sharding.full_tensors(t, shards,
                                                           self.mesh))
        if self.mesh is not None and self.mesh.rank != 0:
            return None
        return checkpoint.save_checkpoint(path, params, opt_state, epoch,
                                          self.rng_state())

    def resume(self, path: str):
        """(params, opt_state, epoch) of the run that ``save`` wrote to
        ``path``, the model's parameters and the generators set to it
        (under a model axis this rank's rows of each row-sharded leaf)."""
        params, opt_state = self.init_state(warm_start=False)
        state = checkpoint.load_checkpoint(path)
        shards = sharding.shards_of(self.model)
        if shards:
            state["params"] = sharding.local_tensors(state["params"], shards,
                                                     self.mesh)
            state["opt_state"] = checkpoint.map_saved_state(
                state["opt_state"], lambda t: sharding.local_tensors(
                    t, shards, self.mesh))
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
        with trace.span("train.epoch"):
            if hasattr(self.model, "pre_epoch"):
                # The epoch's constants from the parameters that enter it
                # (SoHRML's edge attention), which evaluate then reads too.
                with torch.no_grad(), self._views("gspmd"):
                    self.aux.update(self.model.pre_epoch(self.aux))
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

    @contextlib.contextmanager
    def _profile(self, out_dir: str):
        """Trace the block inside with ``torch.profiler`` (CPU activity,
        and CUDA on a card) and write its Chrome trace
        ``<out_dir>/<model>_rank<R>.json``."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        rank = self.mesh.rank if self.mesh is not None else 0
        path = os.path.join(str(out_dir), f"{self.model.name}_rank{rank}.json")
        with torch.profiler.profile(activities=acts) as prof:
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(str(out_dir), exist_ok=True)
        prof.export_chrome_trace(path)
        if self.logger:
            self.logger.info("  profile trace written to %s", path,
                             extra={"profile": path})

    def run(self, seed: int | None = None, resume_from: str | None = None):
        """Full train/eval loop with best-NDCG@topk[0] tracking
        (RankingRecommender.py:400-440).  Each epoch line carries its
        numbers as the log record's ``train`` attribute, each eval's as
        ``eval``, and the summary's as ``best``.  ``resume_from``, a
        checkpoint directory, restarts at its epoch + 1; with
        ``save.best=True`` each new best epoch's train state is saved to
        ``saved_dir/<model>`` (the reference's disabled save path,
        RankingRecommender.py:432-433, made to work), by rank 0 alone
        under a mesh.  With ``profile.dir`` the second block of epochs is
        traced once (``_profiled``)."""

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
        # Under a mesh every rank calls save (the row blocks are gathered)
        # and rank 0 alone writes.
        if self.cfg.bool("save.best", False):
            save_dir = os.path.join(self.cfg.str("saved_dir", "./saved_model"),
                                    self.model.name)
        profile_dir = self.cfg.get("profile.dir")
        traced = False
        topk = self.cfg.topk
        best = {"epoch": 0, "ndcg": 0.0, "metrics": {}}
        interval = self.cfg.test_interval
        while epoch < self.cfg.epoches:
            next_eval = min(((epoch // interval) + 1) * interval,
                            self.cfg.epoches)
            block = next_eval - epoch
            # The second block, as the JAX trainer traces it
            # (cleverrec_tpu/train/trainer.py:2164-2175): the first pays
            # the builds.
            trace = bool(profile_dir) and epoch > 0 and not traced
            t1 = time.perf_counter()
            with (self._profile(profile_dir) if trace
                  else contextlib.nullcontext()):
                params, opt_state, losses = self.train_epochs(
                    params, opt_state, block)
            traced = traced or trace
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
                if save_dir and self.save(save_dir, params, opt_state,
                                          epoch):
                    log("  saved to %s", save_dir)
        log("best_epoch: %d", best["epoch"], best=best)
        for k in topk:
            if k in best["metrics"]:
                hr, mrr, ndcg = best["metrics"][k]
                log("  (k=%d) HR=%.4f, MRR=%.4f, NDCG=%.4f", k, hr, mrr, ndcg)
        self.params, self.opt_state = params, opt_state
        return best
