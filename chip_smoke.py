"""Drive the PyTorch port's serving, eval and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py        (from the root of a checkout)

Builds the port's CUDA kernels from ``cleverrec_tpu_torch/csrc`` with
``nvcc`` (one process per source, all at once), then, with BPR at the
width of ``conf/BPR.properties`` (embed_size 128):

- Phase A, ml-100k (narrow catalog, kernel ``dot_scores``): rebuilds the
  ratings from ``benchmarks/UIRT/ml100k.{train,test}.libfm``, serves
  4 x 256 users at k=10 through ``build_retrieval_fn(backend="auto")``
  (which must pick ``fused``) and holds every answer against the
  ``dense`` backend; runs the Evaluator in ``full_fused`` and ``full``
  mode on a random split (full-catalog eval), in ``full_fused`` mode
  past the global bitmap budget (a member table built with budget 0:
  the test users' bitmaps built once from their rows, the metrics equal
  ``full``'s) and in ``candidate`` mode on the default leave-one-out,
  99-negative protocol.  Random weights from the config's seed.
- Phase B, a 131072-id synthetic catalog (wide catalog, kernel
  ``dot_gmax``): the generator of ``benchmarks/catalog_scale.py``
  (49,152 users x 40 rows), 4 x 1024 users at k=20 through
  ``backend="fused"``, held against ``dense``; then the same calls with
  ``approx=True`` (the rescue from a bf16 copy of the table), held to
  the same path with ``dot_gmax``'s plain version on the card, with
  their top-20 id agreement with the exact answers and both times.
- Phase H, catalog-scale ranking (kernel ``dot_topk_scores``): the same
  generator over 4,194,304 ids, 593,231 distinct items, past both the
  evaluator's streaming threshold and the 1 GiB global bitmap budget
  (each batch's bitmaps come from its rows).  4 x 1024 users at k=20
  through ``backend="auto"``, which must pick ``stream``, held against
  ``dense``; the Evaluator, which must take ``full_stream`` by default,
  held to the ``full`` evaluator and to a 4096-item-chunk stream; and
  ``dot_topk_scores`` on the same calls' users, ranked with ``topk``
  through its ``item_map``, held against ``dense``.
- Phase C, training (kernel ``bpr_epoch``): the port's CLI
  (``cleverrec_tpu_torch.cli.main``) on the default recipe,
  ``CleverRec.properties`` + ``conf/BPR.properties`` on the rebuilt
  ml-100k: 30 epochs through the fused tier, eval every epoch.  The
  kernel must launch once per epoch, the last loss must be below the
  first, and the best HR@10 at least ``MIN_HR10``.
- Phase D, the JAX parity recipe of ``benchmarks/PARITY_BPR.json`` (the
  same CLI at embed_size 64) through the fused tier and the scan tier,
  which see identical sampled batches: their best HR@10 and NDCG@10
  within ``TIER_BAND`` of each other.  The JAX run's metrics are printed
  beside them but not held: they were taken on the real ``u.data``,
  whose time order the repo's libfm copy does not keep (see
  ``phase_d``).
- Phase E, the NCF family on the rebuilt ml-100k (kernels ``gmf_epoch``
  and ``mlp_epoch``): the same CLI with ``--model GMF``, ``MLP`` and
  ``NeuMF`` at the widths of their confs, 30 epochs each through the
  fused tier: each kernel launches once per epoch, the loss falls, and
  the best HR@10 is at least the JAX package's on the same data less
  ``JAX_BAND``.  Then each model 3 epochs through the fused and the scan
  tier on identical draws, held to each other as phase D holds BPR's;
  ``mlp_epoch`` sums in a fixed order, so MLP's and NeuMF's 3-epoch fused
  runs repeat their 30-epoch runs' first 3 epoch losses bit for bit.
- Phase F, the social-triple family (kernel ``rows_epoch``): a trust
  graph over the rebuilt ml-100k's users, generated from a seed
  (``write_trusts``), then the same CLI with ``--model SBPR`` and
  ``TBPR`` on it and ``CUNE_BPR`` (latent friends, no trust file) on
  ml-100k alone, at the widths of their confs, 25 epochs each (half the
  confs' count) through the fused tier: the kernel launches once per
  epoch, the loss falls, and the best HR@10 is at least the JAX
  package's on the same files less ``JAX_BAND``.  Then each model 3
  epochs through the fused tier, the scan tier and the fused tier with
  ``train.fused_stream=True`` (the same kernel), held to each other as
  phase D holds BPR's; CUNE_BPR's latent friends are built once, by its
  25-epoch run, and its three 3-epoch runs take them
  (``cune_friends_once``).
- Phase G, the metric-learning family (kernels ``cml_epoch`` and
  ``rows_epoch_lrml``, LRML's form of the rows kernel): the same CLI
  with ``--model CML``, ``LRML`` and ``TransCF`` at the widths of their
  confs and ``METRIC_EPOCHS`` epochs (30, 100, and TransCF 50 of its
  100): CML and LRML through the fused tier (each kernel launches once
  per epoch), TransCF, which has
  no fused tier, through the scan tier (no epoch kernel launches); the
  loss falls and the best HR@10 is at least the JAX package's on the
  same files less ``JAX_BAND``.  Then CML and LRML 3 epochs through the
  fused and the scan tier on identical draws, held to each other as
  phase D holds BPR's.  Then the distance-model trap: CML trained a few
  epochs on a random split, whose ``full_fused`` eval (``dot_scores`` on
  the negated decomposition) must equal its ``full`` eval, and whose
  fused retrieval must give the dense retrieval's answers.
- Phase I, the rest of the social family and the trainer's features (no
  new kernel): on phase F's trust graph, the same CLI with ``--model
  SAMN`` on its conf (embed 64, mem 8, atten 16, Adagrad at lr 0.05,
  batch 6144, neg_ratio 1), 50 epochs (half the conf's) through the
  grouped pairwise epoch: no epoch kernel launches, the loss falls and the best HR@10 is
  at least the JAX package's on the same files less ``JAX_BAND``; then
  SAMN_single 10 epochs, and SAMN's grouped against its flat epoch
  (``train.grouped_pairs=False``), 30 epochs each (the flat one
  converges faster at first), the two within ``JAX_BAND``.  SBPR and TBPR 3 epochs on the per-step samplers
  (``train.sbpr_epoch_tensors=False``) through ``rows_epoch``, once an
  epoch, within ``JAX_BAND`` of phase F's 3-epoch fused runs.  The lazy
  row-Adam tier (``train.sparse_rows_force=True``) for SBPR and BPR, 3
  epochs: no epoch kernel, the loss falls, best HR@10 within
  ``JAX_BAND`` of the fused tier's.  BPR 2 epochs with ``save.best``,
  then ``--resume`` to 4, its last epoch's metrics within ``TIER_BAND``
  of an uninterrupted 4-epoch run's (the largest parameter gap
  printed); GMF and MLP 3 epochs saved, then NeuMF warm-started from
  them (``gmf_pretrain``, ``mlp_pretrain``), its first epoch's loss
  below phase E's cold start's; ``--tune`` on a 2 x 1 grid of
  embed_size, 2 epochs a trial.  The ``phase I`` line gives each run's
  epoch and eval ms beside its reference's, and phase I's seconds; the
  profiles line SAMN's epoch and eval by kernel.
- Phase J, the item-similarity and graph models (kernel ``dot_scores``
  through LightGCN's decomposition): on the same files, the same CLI
  with ``--model FISM`` (embed 128), ``LightGCN`` and ``NGCF`` (embed
  64, 3 layers), ``ITEM_GRAPH_EPOCHS`` epochs each (half the confs'
  50 and 100), each on its conf through
  the scan tier: no epoch kernel, the loss falls, and the best HR@10 is
  at least the JAX package's on the same files less ``JAX_BAND``.  NAIS
  on its conf (embed 128, atten 32, Adagrad, the bucketed grouped tier)
  ``NAIS_EPOCHS`` epochs warm-started from the FISM run
  (``fism_pretrain``) and as many cold, both held to the JAX CLI's runs
  (warm from its own FISM), the warm first epoch's loss above the cold
  one's as in the JAX package; NAIS_single 2 epochs, NAIS on the flat
  tier (``train.bucketed_histories=False``) 2 epochs with the loss
  falling; LightGCN 5 epochs on its dense adjacency and on its edge list
  (``graph.dense_budget_mb=0``), within ``TIER_BAND``.  Then the
  LightGCN run's best parameters on a random split: its ``full_fused``
  eval (``dot_scores`` on the propagated item rows) equal to ``full``,
  and 4 x 256 users at k=10 through ``auto``, which must pick ``fused``,
  held against ``dense``; ``dot_scores`` must launch.  One NAIS epoch is
  profiled (the device's busy share).  The ``phase J`` line gives each
  run's epoch and eval ms, first and last loss, best HR@10 beside its
  reference, the bucket plan, and phase J's seconds.
- Phase K, the social-diffusion family and WMF, DMF, SML and EATNN
  (kernel ``dot_scores``, through LR_GCCF's and SML's decompositions):
  on phase F's files, the same CLI with ``--model DiffNet``,
  ``DiffNetPlusPlus`` and ``EATNN`` (embed 64, the trust graph),
  ``LR_GCCF`` (embed 64, 3 layers), ``WMF``, ``DMF`` (towers [64, 32])
  and ``SML`` (embed 64, learned margins), each on its conf through the
  scan tier for ``K_EPOCHS`` epochs (cut from the confs' 100): no
  epoch kernel, the loss falls, and the best
  HR@10 is at least the JAX package's on the same files less
  ``JAX_BAND``.  ``auto`` serving must pick ``fused`` for the four
  decomposable models and ``dense`` for DiffNet, DiffNet++ and DMF.
  Then LR_GCCF's and SML's
  best parameters on a random split: ``full_fused`` eval equal to
  ``full``, and 4 x 256 users at k=10 through ``auto`` (``fused``) held
  against ``dense`` (SML's scores up to each user's |u|^2);
  ``dot_scores`` must launch.  The ``phase K`` line gives each run's
  epochs, epoch and eval ms, first and last loss, best HR@10 beside its
  reference, the backends, and phase K's seconds.
- Phase L, the dual-domain models and popularity negatives (kernel
  ``bpr_epoch``): on phase F's files, the same CLI with ``--model
  RML_DGATs`` (embed 64, atten 32, att_type 2, 30-wide neighbour
  tables) and ``SoHRML`` (embed 128, 2 GAT layers, dropout 0.3, every
  neighbour, its edge attention refreshed before each epoch), 100
  ``train_batches`` an epoch each, for ``L_EPOCHS`` epochs (cut from the
  confs' 200) through the dual protocol on the scan tier: no epoch
  kernel, the loss falls, the best HR@10 at least the JAX package's on
  the same files less ``JAX_BAND``, ``auto`` serving picks ``dense``,
  one epoch of each profiled (the device's busy share).  Then BPR's conf
  with ``neg_sampling=popularity``, 30 epochs through the fused tier
  (``bpr_epoch`` once an epoch) and through the scan tier, each held to
  the JAX CLI's run with popularity negatives less ``JAX_BAND`` and to
  each other within ``TIER_BAND``; ``bpr_epoch`` held to its plain
  version on a popularity draw.  The ``phase L`` line gives each run's
  epochs, epoch and eval ms, first and last loss, best HR@10 beside its
  reference, and phase L's seconds.
- Phase M, rating (no kernel): the repo's ml-100k libFM files in
  ``build/data/ml100k/``, then the same CLI with ``--model FM`` (embed
  16) and ``FFM`` (embed 8) on their confs, 30 epochs each (batch 4096,
  Adam at 1e-3): the training RMSE falls, the best test RMSE is at most
  the JAX package's on the same files plus ``M_BAND``, and no kernel
  launches; ``--tune`` over embed_size [8, 16], 2 epochs a trial, names
  the trial of the lowest RMSE; one FM epoch profiled.  The ``phase M``
  line gives each run's epoch and eval ms, best RMSE and MAE beside the
  JAX package's, the busy share, and phase M's seconds.
- Phase N, export (kernels ``dot_scores`` and ``dot_gmax`` inside
  ``torch.export`` programs; run after phase B, its launch counts from 0
  and set aside): phase A's model as a serving bundle
  (``serving.export_bundle``, ``auto`` -> ``fused``) written to a
  temporary directory and loaded back (``load_serialized``); its
  retrieval program on phase A's 4 x 256-user calls and its rerank
  program on 128 candidates a user (8 of them padding) equal the live
  ``retrieve`` and ``rerank`` answers exactly, each retrieval call
  launching ``dot_scores`` once; then a ``fused`` retrieval program at
  phase B's catalog on its 4 x 1,024-user calls, held the same way with
  ``dot_gmax``.  The ``phase N`` line gives each program's ms a call
  beside the live call's, its bytes and its export and load seconds.
- Phase O, ``classic/`` on the card (no kernel): on the rebuilt ml-100k
  (all pairs split 7:1 at random for LFM and SLIM, the libFM split's
  rating triples for the rating models, phase F's trust graph for
  TrustSVD), ``classic_figures`` fits LFM, SLIM, FunkSVD, BiasSVD, SVD++
  and TrustSVD (``O_MODELS``) on ``cuda``: precision@10 at least the JAX
  package's on the same files less ``O_BAND``, test RMSE at most its
  plus ``O_BAND``, and no kernel launch.  The ``phase O`` line gives each
  figure beside the JAX package's and each fit's seconds.
- Phase P, the trainer's capacity tiers (after O; the variants of
  ``bpr_epoch``, ``rows_epoch`` and ``cml_epoch`` and the grouped
  launches of ``gmf_epoch`` and ``mlp_epoch``).  P-kernels: one grouped
  trainer epoch (``train.fused_groups``, ``P_GROUPS``) each of BPR at
  phase C's recipe, GMF, NeuMF (its first ``MLP_HELD_STEPS`` steps, two
  a group) and CML (the frozen partial sums) through the kernels and
  through ``ops.train.PLAIN_EPOCH_FNS`` from one state on one draw, held
  to the atomics tolerances, one launch a group.  P-scale: the
  user-heavy catalog of ``benchmarks/grouped_scale.py`` (98,304 users x
  2,048 items, ~20 pairs a user) rebuilt from its seed, BPR at embed 64,
  batch 6,144, in 32 groups of 3,072 rows: one grouped epoch held the
  same way, then ``P_SCALE_EPOCHS`` timed epochs beside the ungrouped
  fused epoch's (the ``phase P scale`` line).  P-quality: the same CLI
  with BPR (phase C's recipe) in 4 groups and with ``train.fused_bf16``,
  GMF, NeuMF and CML in 2 groups, SBPR and LRML with bf16 storage, each
  at its conf's epochs: the run takes the tier its log line names, its
  kernel launches once a group (a bf16 run: once) an epoch, and its
  best HR@10 lies within ``P_BAND`` of the same model's f32 ungrouped
  run in phases C, E, F and G.
- Phase Q, the parallel layer's data axis (after P; the fused mesh-DP
  launches of ``bpr_epoch``, ``gmf_epoch``, ``mlp_epoch``, ``rows_epoch``
  and ``cml_epoch``): this script re-executed twice (``--rank R PORT``)
  as the two ranks of a ``2 x 1`` mesh on cuda:0 over gloo (the machine
  has one card, and NCCL takes one rank a device).  Q-parity: one
  data-parallel epoch on each rank's own draw of BPR (phase C's recipe),
  GMF, NeuMF (its first ``MLP_HELD_STEPS`` steps), SBPR (phase F's
  files), CML and BPR in 2 groups: the ranks' draws (a digest) equal, and
  their replicas equal bit for bit and equal, within phase D's atomics
  tolerances, the serial oracle of ``tests/torch_dp_oracle.py`` run here
  with the same kernels.  Q-eval: ``full_sharded`` on BPR's replica equals
  the unmeshed ``full`` evaluator, and ``rank_sharded`` over a ``1 x 2``
  mesh equals ``rank_dense``.  Q-quality: the CLI with ``--mesh 2x1``,
  ``train.dp_sync_every=2`` and ``dp_delta_combine=sum`` on BPR 30
  epochs, its best HR@10 within ``JAX_BAND`` of ``JAX_Q_HR10``.
  Q-split: the scan tier's batch split over ``data``, one epoch on each
  rank of LightGCN (its conf's widths, the full-catalog eval after the
  epoch: ``full_sharded`` on the mesh), EATNN, SAMN (its flat scan tier)
  and FM (phase M's files) from the seed's state and draw, under
  ``fixed_sums``: the ranks' states and losses equal bit for bit, and the
  unmeshed epoch here within ``Q_SPLIT_*`` (twice them for the hard models); rank 0's
  LightGCN state evaluated here through ``full_fused`` (kernel
  ``dot_scores``) gives the ranks' ``full_sharded`` metrics.  Q-agree:
  one epoch of SoHRML (``dual``) and NAIS (``bucketed``), whole steps on
  every rank taking data rank 0's gradients, the atomics left as they
  are: the ranks' states and losses equal bit for bit.  Q-split quality: the CLI with ``--mesh 2x1`` on
  LightGCN's conf, ``Q_LIGHTGCN_EPOCHS`` epochs with the full-catalog
  eval, its best HR@10 within ``JAX_BAND`` of the unmeshed run of the
  same recipe here (whose ``full_fused`` eval launches ``dot_scores``).
  The ``phase Q`` line gives each run's epoch ms a rank, one combine's
  ms, phase Q's seconds and the card: a check of the mesh, not a mesh's
  speed.
- Phase R, the parallel layer's model axis (after Q; no kernel: the model
  axis declines the fused tier): this script re-executed twice
  (``--model-rank R PORT``) as the two ranks of a ``1 x 2`` mesh on cuda:0
  over gloo, each holding its half of every table that divides over 2
  (Q; ml-100k's 943-user P stays whole, as the JAX package's rule keeps
  it).  R-parity: one epoch of BPR (phase C's recipe, the epoch kernel
  asked for and declined) under each exchange, CML under the explicit
  one, SoHRML (the dual epoch and ``pre_epoch``, phase L's files) and FM
  (phase M's files), on a draw the ranks and this process share, with
  torch's deterministic algorithms on (``fixed_sums``: an unmeshed
  SoHRML epoch run twice with ``index_add``'s atomics parts from itself):
  the ranks' gathered states equal each other and the unmeshed scan or
  dual epoch here, bit for bit under gspmd and within phase D's
  ``EPOCH_*`` under explicit.  R-memory: each rank's bytes of P, Q and their moments
  against the unmeshed run's.  R-quality: the CLI with ``--mesh 1x2
  --distributed --device cuda:0`` under ``torch.distributed.run`` on BPR
  30 epochs, its best HR@10 within ``JAX_BAND`` of ``JAX_R_HR10``.
  R-trace: BPR's CLI two epochs with ``profile.dir`` in a fresh process,
  its Chrome trace holding the fused epoch's kernel.  The ``phase R``
  line gives each run's epoch ms a rank, the bytes, the seconds and the
  card.
- Kernel rows: each kernel against its plain PyTorch version at the
  shapes of its phase, timed beside the plain version, a library call
  where one computes the same function (yardstick only), and the least
  time the card needs for the same work.  The scoring rows also give the
  kernel's own device time (``device_ms``, from torch.profiler), the
  library call's (``library_device_ms``) and the host's time to issue
  one wrapper call (``wrapper_us``, over the calls ``ms`` times);
  ``dot_scores`` is held and timed at A, at phase A's eval batches (E:
  its 1,024-user ``full_fused`` batches, which take another tile), at B,
  at ``border``, 1,024 users x 4,096 items (the narrow branch's border),
  and at J (phase J's first serving call: LightGCN's 256 propagated user
  rows against its 1,682 item rows, d 64) and at K (phase K's first LR_GCCF
  serving call: 256 x 1,682, d 256, the four layers concatenated),
  ``dot_gmax`` at B and A, each timing naming the tile it took; inputs
  from the script's seeds.  The ``mlp_epoch``, ``rows_epoch`` and
  ``rows_epoch_lrml`` rows give the kernel's own device time of an epoch
  (``device_ms``, its row and Adam kernels, ``device_split``) at NeuMF's
  and MLP's, SBPR's, TBPR's and CUNE_BPR's, and LRML's shapes, with the
  plan each took; LRML's row also the share of real rows whose hinge was
  active in the timed epoch (``active_share``).  So do the ``bpr_epoch``,
  ``gmf_epoch`` and ``cml_epoch`` rows, with each kernel's launches an
  epoch (``device_launches``): the persistent BPR, GMF and CML kernels
  must take one launch an epoch, seen on the device (in a fresh process
  of this script, ``--trace``, where the smoke's own trace records no
  device kernel; ``device_trace_from``).  Phase P's variants have rows
  of their own: ``bpr_epoch_bf16`` at phase C's shape and
  ``rows_epoch_bf16`` and ``rows_epoch_lrml_bf16`` at SBPR's and LRML's
  (bf16 storage, held over their first ``BF16_HELD_STEPS`` steps by the
  one-ulp rule, the whole epoch timed; their bound counts the state at 2
  bytes an element), and ``cml_epoch_grouped`` (group 1's launch of CML
  in 2 groups, with the frozen sums); each variant's launches are its
  P-quality run's.

Launch counts are set to 0 before phase A and read after phases A, B
and H (phase N, run between B and H, counted from 0 apart and added
after), again before and after each training run (phases I's, J's and
M's included; M's must read 0), before and after phase J's LightGCN
and phase K's LR_GCCF and SML eval and serving, and around phase O (which
must read 0) (``dot_scores``' row counts A, B, H, J, K and N,
``dot_gmax``'s B and N; ``bpr_epoch``'s C, L and P's grouped runs,
``gmf_epoch``'s and ``mlp_epoch``'s E and P's, and each of the five
epoch kernels' Q: the two ranks' launches, each rank counting from 0
before each run it drives; ``dot_scores``' Q: Q-split's ``full_fused``
eval of LightGCN and the unmeshed LightGCN quality run's).  Exits
non-zero, with no result line, on any failure or without a CUDA device.  The last line of
stdout is ``{"ok": true, "device": {...}}``; the line before it lists
the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import logging
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from cleverrec_tpu_torch import classic, cli
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import STREAM_THRESHOLD, Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import build, scores
from cleverrec_tpu_torch.ops import train as train_ops
from cleverrec_tpu_torch.ops.topk import topk
from cleverrec_tpu_torch.parallel import Mesh, make_mesh, sharding
from cleverrec_tpu_torch.ranking import rank_dense, rank_sharded
from cleverrec_tpu_torch.sampling import build_member_table, rows_to_bits
from cleverrec_tpu_torch.serving import (build_rerank_fn, build_retrieval_fn,
                                         export_bundle, export_retrieval,
                                         load_serialized)
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.trainer import _dp_delta_combine, _state_leaves
from cleverrec_tpu_torch.train.checkpoint import (copy_into,
                                                  load_checkpoint,
                                                  load_params)

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "build", "data")
LOGS = os.path.join(ROOT, "build", "logs")
NEEDED = ("cleverrec_tpu_torch/csrc/dot_scores.cu",
          "cleverrec_tpu_torch/csrc/bpr_epoch.cu",
          "cleverrec_tpu_torch/csrc/gmf_epoch.cu",
          "cleverrec_tpu_torch/csrc/mlp_epoch.cu",
          "cleverrec_tpu_torch/csrc/epoch.cuh", "CleverRec.properties",
          "conf/BPR.properties", "conf/GMF.properties", "conf/MLP.properties",
          "conf/NeuMF.properties", "conf/SBPR.properties",
          "conf/TBPR.properties", "conf/CUNE_BPR.properties",
          "cleverrec_tpu_torch/csrc/rows_epoch.cu",
          "cleverrec_tpu_torch/csrc/cml_epoch.cu", "conf/CML.properties",
          "conf/LRML.properties", "conf/TransCF.properties",
          "conf/SAMN.properties", "conf/SAMN_single.properties",
          "conf/FISM.properties", "conf/NAIS.properties",
          "conf/NAIS_single.properties", "conf/LightGCN.properties",
          "conf/NGCF.properties", "conf/DiffNet.properties",
          "conf/DiffNetPlusPlus.properties", "conf/LR_GCCF.properties",
          "conf/WMF.properties", "conf/DMF.properties", "conf/SML.properties",
          "conf/EATNN.properties", "conf/RML_DGATs.properties",
          "conf/SoHRML.properties",
          "benchmarks/UIRT/ml100k.train.libfm",
          "benchmarks/UIRT/ml100k.test.libfm", "benchmarks/PARITY_BPR.json",
          "tests/torch_dp_oracle.py")

# NVIDIA H100 SXM data sheet: FP32 on the CUDA cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

SERVE_RTOL = 1e-4     # fused vs dense scores (f32 sums in another order)
METRIC_TOL = 1e-6     # full_fused vs full eval metrics
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 1e-5   # kernel vs plain, unmasked slots
# bpr_epoch vs plain, every element of P, Q and the four moments after
# one epoch, and the summed loss: f32 atomics sum duplicate ids in a
# run-dependent order (6144 x 3 slots a step land on 1,682 item rows) and
# Adam's normalisation carries that rounding into every step.
EPOCH_ATOL, EPOCH_RTOL, EPOCH_LOSS_RTOL = 1e-5, 1e-3, 1e-5
MIN_HR10 = 0.55       # phase C: best HR@10 of 30 epochs at embed 128
# Phase D, fused tier against scan tier: identical sampled batches,
# arithmetic that differs only in f32 rounding; 0.015 HR@10 is 14 of 942
# test users.
TIER_BAND = {"HR@10": 0.015, "NDCG@10": 0.01}
EPOCHS = 30
NCF = ("GMF", "MLP", "NeuMF")
NCF_KERNEL = {"GMF": "gmf_epoch", "MLP": "mlp_epoch", "NeuMF": "mlp_epoch"}
# Phase E: the JAX package's best HR@10 on the same rebuilt ml-100k, each
# conf's recipe, 30 epochs (the JAX CLI on the CPU; the command is in
# PERF.md), and how far below it the port may land: other random draws
# from the same seed.
JAX_HR10 = {"GMF": 0.5419, "MLP": 0.7964, "NeuMF": 0.8038}
JAX_BAND = 0.03
TIER_EPOCHS = 3
# mlp_epoch vs plain: the dense params (W_l, b_l, h) sum every row of a
# step in the kernel's order (per block, then the blocks' partial sums),
# against cuBLAS products in the plain version, and Adam normalises that
# rounding into each next step; the loss depends on them.
DENSE_ATOL, DENSE_RTOL, MLP_LOSS_RTOL = 1e-4, 1e-3, 1e-4
# mlp_epoch is held over the first MLP_HELD_STEPS steps of the main
# path's next epoch, not all 81: a ReLU whose input lies within rounding
# of 0 in one version and not in the other sends one row's gradient
# through that unit in one version only, and over a whole epoch the two
# trajectories of a tower then part past the tolerances above in a few
# percent of the states one epoch in (tools/mlp_states.py on the card).
MLP_HELD_STEPS = 4
SOCIAL = ("SBPR", "TBPR", "CUNE_BPR")
# Phases F and I train half their confs' epochs (SBPR, TBPR and CUNE_BPR
# 25 of 50, SAMN 50 of 100), cut as phase J's were to keep the smoke
# inside its limit on a slower host; the JAX references were re-taken.
SOCIAL_EPOCHS = 25
TRUST_SEED = 2026
LIBFM_DATASET = "ml100k"   # write_ml100k_libfm's dataset under DATA
# Phase F: the JAX package's best HR@10 on the same rebuilt ml-100k and the
# trust graph of write_trusts(TRUST_SEED), each conf's recipe, 25 epochs,
# from the JAX CLI on the CPU:
#   JAX_PLATFORMS=cpu python -m cleverrec_tpu.cli --config
#     CleverRec.properties --conf-dir conf --set data.root_dir=build/data
#     --set data.file_name=ratings.csv --set data.sep=, --model M
#     --set epoches=25
# with M SBPR, TBPR and CUNE_BPR.  (At the confs' 50: 0.7391, 0.6819,
# 0.7635.)
JAX_SOCIAL_HR10 = {"SBPR": 0.7402, "TBPR": 0.6872, "CUNE_BPR": 0.7529}
METRIC = ("CML", "LRML", "TransCF")
# The confs' epochs but TransCF's, half its 100 (its JAX curve is flat
# from epoch 15), cut as phase F's were.
METRIC_EPOCHS = {"CML": 30, "LRML": 100, "TransCF": 50}
METRIC_KERNEL = {"CML": "cml_epoch", "LRML": "rows_epoch_lrml",
                 "TransCF": None}
# Phase G: the JAX package's best HR@10 on the same rebuilt ml-100k, each
# conf's recipe at the epoch counts above (the JAX CLI on the CPU: phase
# F's command with --model M --set epoches=N).  (TransCF at 100: 0.8314.)
JAX_METRIC_HR10 = {"CML": 0.8017, "LRML": 0.8271, "TransCF": 0.8324}
TRAP_EPOCHS = 5       # CML's epochs before the distance-model trap
SAMN_EPOCHS = 50
# Phase I: the JAX package's best HR@10 for SAMN on the same rebuilt
# ml-100k and the trust graph of write_trusts(TRUST_SEED), the conf's
# recipe, 50 epochs: phase F's command with --model SAMN --set
# epoches=50.  (At the conf's 100: 0.8303.)
JAX_SAMN_HR10 = 0.8187
SAMN_SINGLE_EPOCHS = 10
# SAMN's grouped against its flat epoch: they converge at different
# rates.  On the same files the JAX CLI's flat epoch leads the grouped one
# by 0.025 HR@10 at epoch 10 and by 0.01 or less from epoch 25 on (best
# HR@10 over 100 epochs 0.8388 flat, 0.8303 grouped), so they are held to
# each other after 30 epochs.
GROUPED_FLAT_EPOCHS = 30
CKPT_EPOCHS = (2, 4)     # BPR: saved after the first, resumed to the second
PRETRAIN_EPOCHS = 3      # GMF and MLP before NeuMF's warm start
# Phase J: half the confs' epoch counts (FISM 25 of 50, LightGCN and NGCF
# 50 of 100), and NAIS's, warm and cold, 5 of the conf's 50: phases J, K
# and L are host-bound, and on one H100 machine they ran 1.5-2x slower
# than on another (the smoke 1,338 s against its 1,200 s limit), so
# their epochs were cut and the JAX references re-taken at the new
# counts.
ITEM_GRAPH_EPOCHS = {"FISM": 25, "LightGCN": 50, "NGCF": 50}
NAIS_EPOCHS = 5
NAIS_SHORT_EPOCHS = 2   # NAIS_single, and NAIS on the flat tier
EDGE_EPOCHS = 5         # LightGCN's dense against its edge-list path
# Phase J: the JAX package's best HR@10 on the same rebuilt ml-100k, each
# conf's recipe at the epoch counts above, from the JAX CLI on the CPU:
#   JAX_PLATFORMS=cpu python -m cleverrec_tpu.cli --config
#     CleverRec.properties --conf-dir conf --set data.root_dir=build/data
#     --set data.file_name=ratings.csv --set data.sep=, --model M
#     --set epoches=N
# with M FISM (and --set save.best=True --set saved_dir=DIR), LightGCN,
# NGCF, and NAIS with --set test.batch_size=256, cold and warm-started
# from that FISM (--set fism_pretrain=DIR/FISM).  (At the confs' 50 and
# 100 epochs and NAIS's 10: 0.7922, 0.7519, 0.8293, 0.6437, 0.8070.)
JAX_ITEM_GRAPH_HR10 = {"FISM": 0.7243, "LightGCN": 0.6946, "NGCF": 0.8155,
                       "NAIS_warm": 0.5907, "NAIS_cold": 0.8006}
# The JAX CLI's first-epoch NAIS loss on the same files, warm-started from
# its FISM and cold: the warm start raises it.  Phase J holds the port's
# warm first epoch above WARM_GAP times its cold one.
JAX_NAIS_FIRST_LOSS = {"warm": 982.9916, "cold": 382.5351}
WARM_GAP = 1.1
# Phase K: half the counts that kept it near 150 s on a fast host
# (LR_GCCF and WMF 50 of their confs' 100, DMF 15, DiffNet 25), for the
# reason phase J's were cut; DiffNet++, SML and EATNN halved again to 12,
# where the JAX CLI's curves flatten (DiffNet stays at 25: its curve
# leaves a plateau at epochs 10-12).
K_EPOCHS = {"DiffNet": 25, "DiffNetPlusPlus": 12, "LR_GCCF": 50,
            "WMF": 50, "DMF": 15, "SML": 12, "EATNN": 12}
# Phase K: the JAX package's best HR@10 on the same files (the rebuilt
# ml-100k and, for DiffNet, DiffNet++ and EATNN, the trust graph of
# write_trusts(TRUST_SEED)), each conf's recipe at the epoch counts
# above, from the JAX CLI on the CPU: phase J's command with --model M
# and --set epoches=N (the three confs name trusts.csv).  (At the confs'
# counts: 0.7699, 0.8388, 0.8218, 0.8197, 0.7773, 0.7709, 0.8303; at 25:
# DiffNet++ 0.8250, SML 0.7709, EATNN 0.8282.)
JAX_K_HR10 = {"DiffNet": 0.7222, "DiffNetPlusPlus": 0.8112,
              "LR_GCCF": 0.7975, "WMF": 0.8197, "DMF": 0.7741,
              "SML": 0.7709, "EATNN": 0.8144}
# The models whose decomposition phase K ranks with dot_scores, and what
# ``auto`` serving picks for each of the seven on ml-100k.
K_RANKED = ("LR_GCCF", "SML")
K_BACKEND = {"DiffNet": "dense", "DiffNetPlusPlus": "dense",
             "LR_GCCF": "fused", "WMF": "fused", "DMF": "dense",
             "SML": "fused", "EATNN": "fused"}
# Phase L: the dual-domain models on phase F's files, each conf at its full
# width, its 200 epochs cut to what keeps phase L near 40 s on a fast
# host (RML_DGATs, ~1.5-3 s an epoch on an H100, to 8: the JAX CLI's
# best HR@10 on these files over 8 epochs is 0.013 under its best, at 15;
# SoHRML, ~0.8-1.8 s, to 10), for the reason phase J's were cut; BPR's
# conf with popularity negatives at its 30 epochs, on the fused and the
# scan tier.
L_EPOCHS = {"RML_DGATs": 8, "SoHRML": 10}
POP = {"neg_sampling": "popularity"}
# Phase L: the JAX package's best HR@10 on the same files at the epochs
# above, from the JAX CLI on the CPU: phase J's command with --model M and
# --set epoches=N (both confs read trusts.csv), and with --model BPR --set
# neg_sampling=popularity (30 epochs, the conf's); the first N epochs of a
# longer run are the same run.  (At the earlier 15 and 20: 0.8261,
# 0.8112; SoHRML at 40: 0.8261.)
JAX_L_HR10 = {"RML_DGATs": 0.8134, "SoHRML": 0.8081, "BPR_pop": 0.7423}
# Phase M: the rating confs' 30 epochs, and the JAX package's best test
# RMSE (and MAE) on the repo's ml-100k libFM files, each conf's recipe at
# seed 2026 (the JAX CLI on the CPU: JAX_PLATFORMS=cpu python -m
# cleverrec_tpu.cli --config CleverRec.properties --conf-dir conf --model M
# --set data.root_dir=ROOT --set data.dataset=ml100k, the files copied to
# ROOT/ml100k/); its seeds 1 and 7 gave FM 0.9613, 0.9615 and FFM 1.0004,
# 1.0004.  The card's run may land at most M_BAND above it.
M_EPOCHS = 30
JAX_M_RMSE = {"FM": 0.9611, "FFM": 1.0063}
JAX_M_MAE = {"FM": 0.7571, "FFM": 0.8095}
M_BAND = 0.02
M_TUNE_EPOCHS = 2
N_CAND = 128          # phase N: the rerank program's candidates a user
N_PAD = 8             # ... the last of them padding (-1)
# Phase O: classic/ on ml-100k, each model's settings (the rest its
# defaults) and its figure.  LFM at examples/classic_cf_ml100k.py's; SLIM's
# default lr 0.01 diverges on ml-100k (a gradient step is stable only
# below 2 over the largest eigenvalue of the co-count gram, here in the
# tens of thousands); FunkSVD and BiasSVD take plain SGD on each batch's
# MEAN loss, so a row's step is ~lr x its count / batch, and their default
# 0.01 barely leaves the init.
O_MODELS = {"LFM": ("precision@10", {"factors": 32, "iters": 30}),
            "SLIM": ("precision@10", {"lr": 5e-5}),
            "FunkSVD": ("rmse", {"factors": 32, "lr": 10.0}),
            "BiasSVD": ("rmse", {"factors": 32, "lr": 10.0}),
            "SVDpp": ("rmse", {}),
            "TrustSVD": ("rmse", {})}
# The JAX package's figures on the same files, the mean over seeds 0-2
# (``classic_figures(cleverrec_tpu.classic, seed)`` on the CPU; PERF.md
# names the command; seeds 0, 1, 2: LFM 0.1256, 0.1307, 0.1302; SLIM,
# which draws nothing, 0.2807; FunkSVD 0.9375, 0.9391, 0.9425; BiasSVD
# 0.9330, 0.9345, 0.9362; SVD++ 1.0100, 1.0128, 1.0112; TrustSVD 1.0607,
# 1.0604, 1.0569), and the band each is held to: three times the spread
# (max - min) of those three, rounded up, at least 0.002 (SLIM's: f32
# rounding may reorder near-tied items of a top-10 list).
JAX_O = {"LFM": 0.1288, "SLIM": 0.2807, "FunkSVD": 0.9397,
         "BiasSVD": 0.9345, "SVDpp": 1.0113, "TrustSVD": 1.0593}
O_BAND = {"LFM": 0.0153, "SLIM": 0.002, "FunkSVD": 0.0152,
          "BiasSVD": 0.0096, "SVDpp": 0.0084, "TrustSVD": 0.0114}
H_IDS = 4_194_304     # phase H: the synthetic catalog's id range
H_K = 20
# Phase P: the trainer's capacity tiers.  The grouped epoch's user groups
# for each model (BPR at phase C's recipe; the others at their confs), and
# the models trained with bf16 storage; each run's best HR@10 within
# P_BAND of the same model's f32 ungrouped run in phases C, E, F and G.
P_GROUPS = {"BPR": 4, "GMF": 2, "NeuMF": 2, "CML": 2}
P_BF16 = ("BPR", "SBPR", "LRML")
P_BAND = 0.03
# bf16 storage against its plain version: every state element is a bf16
# value, and all but a share BF16_OUTLIERS of them lie within one bf16
# ulp (of the larger of the two) of the plain version's.  The two sum each
# step's row gradients in another order (f32 atomics here), so a value
# near a rounding boundary lands on the neighbouring bf16; Adam's
# normalisation then carries a flipped moment into its parameter as a
# step of up to ~lr, and over a whole epoch the two trajectories part at
# the bf16 scale (tools/bf16_drift.py measures the share step by step;
# PERF.md has its numbers).  So bf16 is held over the first
# BF16_HELD_STEPS steps of the main path's next epoch, as mlp_epoch is
# over MLP_HELD_STEPS, and the whole epoch is timed.
BF16_OUTLIERS = 2e-3
BF16_HELD_STEPS = 2
# P-scale: benchmarks/grouped_scale.py's user-heavy catalog and its 32
# groups of 3,072 rows (the JAX plan in benchmarks/GROUPED_SCALE.jsonl).
P_SCALE = {"users": 98304, "items": 2048, "per_user": 20, "groups": 32,
           "group_rows": 3072}
P_SCALE_EPOCHS = 5


# Phase Q: the parallel layer's data axis, two ranks on cuda:0 over gloo
# (the machine has one card, and NCCL takes one rank a device).  Q-parity:
# one data-parallel epoch of each case (tag, model, overrides, its tier,
# the steps held, None for all) on the ranks' own draws, held to the
# serial oracle of tests/torch_dp_oracle.py run in this process with the
# same kernels; the kernel each case launches.
Q_CASES = (("BPR", "BPR", {}, "fused", None),
           ("GMF", "GMF", {}, "fused", None),
           ("NeuMF", "NeuMF", {}, "fused", MLP_HELD_STEPS),
           ("SBPR", "SBPR", {}, "fused", None),
           ("CML", "CML", {}, "fused", None),
           ("BPR_grouped", "BPR", {"train.fused_groups": "2"},
            "fused_grouped", None))
Q_KERNEL = {"BPR": "bpr_epoch", "GMF": "gmf_epoch", "NeuMF": "mlp_epoch",
            "SBPR": "rows_epoch", "CML": "cml_epoch",
            "BPR_grouped": "bpr_epoch"}
# Q-quality: BPR at phase C's recipe, 30 epochs on the 2 x 1 mesh with
# dp_sync_every 2 and the sum combine, held within JAX_BAND of the JAX
# CLI's best HR@10 for the same recipe and mesh on the CPU, where the
# scan tier's local Adam runs the same optimizer schedule:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2
#     python -m cleverrec_tpu.cli --config CleverRec.properties --conf-dir
#     conf --set data.root_dir=build/data --set data.file_name=ratings.csv
#     --set data.sep=, --model BPR --mesh 2x1 --set train.dp_local_adam=True
#     --set train.dp_sync_every=2 --set train.dp_delta_combine=sum
JAX_Q_HR10 = 0.8293
Q_SYNC = {"train.dp_sync_every": "2", "train.dp_delta_combine": "sum"}
# Q-split: the scan tier's batch split over 'data' on the 2 x 1 mesh, one
# epoch of each case (tag, model, overrides, its tolerances' scale: 2 for
# tests/test_parallel.py's hard models) from the seed's state and draw,
# held to the unmeshed epoch here at tests/test_parallel.py's tolerances,
# both under fixed_sums.
# LightGCN at its conf's widths evaluates the full catalog (a random
# split: loo always ranks candidates) after its epoch.
Q_FULL = {"test.neg_samples": "0", "data.split_way": "rs"}
Q_SPLIT = (("LightGCN", "LightGCN", Q_FULL, 2),
           ("EATNN", "EATNN", {}, 2),
           ("SAMN", "SAMN", {"train.grouped_pairs": "False"}, 2),
           ("FM", "FM", {}, 1))
Q_SPLIT_RTOL, Q_SPLIT_ATOL, Q_SPLIT_LOSS_RTOL = 1e-4, 1e-5, 1e-4
# Q-agree: the whole-step tiers (tag, model, overrides, tier), data rank
# 0's gradients taken: the ranks equal bit for bit after an epoch.
Q_AGREE = (("SoHRML", "SoHRML", {}, "dual"),
           ("NAIS", "NAIS", {}, "bucketed"))
# Q-split quality: LightGCN's conf with the full-catalog eval, these
# epochs on the 2 x 1 mesh and unmeshed.
Q_LIGHTGCN_EPOCHS = 10
Q_USERS = 256          # Q-eval: the test users rank_sharded ranks
Q_TIMEOUT = 600        # seconds the two ranks may take together
Q_DIR = os.path.join(ROOT, "build", "phase_q")
# Phase R: the parallel layer's model axis, two ranks of a 1 x 2 mesh on
# cuda:0 over gloo, each holding half the rows of every row-shardable
# table.  R-parity: one epoch of each case (tag, model, overrides, the
# tier it must take, whether it is held bit for bit) on one draw that the
# ranks and this process's unmeshed run share, every run under
# fixed_sums: the ranks' gathered states equal bit for bit, and the
# unmeshed epoch's bit for bit under the gspmd exchange, within phase D's
# EPOCH_* under the explicit one (a row's duplicates summed through
# embedding's backward, not indexing's); BPR at phase C's recipe with the
# epoch kernel asked for (the model axis declines it), CML under the
# explicit exchange (its covariance over the whole tables), SoHRML (the
# dual epoch and pre_epoch, on phase L's files) and FM (phase M's files).
R_CASES = (("BPR_gspmd", "BPR", {"train.fused_kernel": "True"}, "scan",
            True),
           ("BPR_explicit", "BPR", {"train.fused_kernel": "True",
                                    "parallel.exchange": "explicit"}, "scan",
            False),
           ("CML_explicit", "CML", {"train.fused_kernel": "True",
                                    "parallel.exchange": "explicit"}, "scan",
            False),
           ("SoHRML", "SoHRML", {}, "dual", True),
           ("FM", "FM", {}, "rating", True))
# R-quality: the CLI with --mesh 1x2 --distributed under
# torch.distributed.run on BPR at phase C's recipe, 30 epochs, held within
# JAX_BAND of the JAX CLI's best HR@10 for the same recipe and mesh on the
# CPU:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2
#     python -m cleverrec_tpu.cli --config CleverRec.properties --conf-dir
#     conf --set data.root_dir=build/data --set data.file_name=ratings.csv
#     --set data.sep=, --model BPR --mesh 1x2
JAX_R_HR10 = 0.8441
R_TIMEOUT = 300        # seconds the two ranks may take together
R_CARD = "cuda:0"      # the card both ranks share
R_DIR = os.path.join(ROOT, "build", "phase_r")


class SmokeError(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


@contextlib.contextmanager
def fixed_sums(notes: list):
    """Torch's deterministic algorithms for a run that is held to another
    at a tolerance: ``index_add``'s, ``scatter_add``'s and indexing's
    backward sums taken in a fixed order instead of by atomics, whose
    run-dependent rounding Adam carries through an epoch (SoHRML's edge
    sums parted a model-axis run from the unmeshed one by up to 2e-3).
    The message of each op that has no deterministic form goes to
    ``notes``."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    notes.extend(sorted({str(w.message)[:200] for w in caught
                         if "determinis" in str(w.message)}))


def sync_s(fn):
    """(result, seconds) of fn(), the device synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed(fn, iters: int = 20) -> tuple[float, float]:
    """(ms, host_us) of fn() over the same ``iters`` runs: the mean device
    time in ms, CUDA events, and the host's mean time to issue one run in
    microseconds."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host / iters * 1e6


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms over ``iters`` runs, CUDA events."""
    return timed(fn, iters)[0]


def device_ms(fn, match=None, iters: int = 20):
    """Device time of one fn() call in ms, from torch.profiler over
    ``iters`` calls: the CUDA kernels whose name holds ``match`` (every
    device event when ``match`` is None), their time over the calls the
    trace holds (it may miss the first launches).  A trace that holds
    none (seen once on an H100, for a cuBLAS product) is taken again, once;
    None if that one holds none either.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and (match is None or match in e.key)]
        launches = max((e.count for e in events), default=0)
        if launches:
            return (sum(e.self_device_time_total for e in events) / 1e3
                    / launches)
    return None


def kernel_split(fn, names, calls: int = 5, counts=None) -> dict:
    """Device ms of one fn() call spent in the kernels whose name holds
    each of ``names``, from torch.profiler over ``calls`` calls; with a
    dict ``counts``, also each one's launches a call recorded on the
    device, ``api`` the host's kernel launches a call (runtime API calls,
    every kernel's) and ``device`` the device's kernel records a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    every = prof.key_averages()
    events = [e for e in every if e.device_type == DeviceType.CUDA]
    if counts is not None:
        counts.update({n: sum(e.count for e in events if n in e.key) / calls
                       for n in names})
        counts["api"] = sum(e.count for e in every
                            if e.key in LAUNCH_APIS) / calls
        counts["device"] = sum(e.count for e in events
                               if not e.key.startswith(("Memcpy",
                                                        "Memset"))) / calls
    return {n: sum(e.self_device_time_total for e in events if n in e.key)
            / 1e3 / calls for n in names}


# The runtime calls that launch a kernel, as torch.profiler names them.
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
               "cudaLaunchCooperativeKernel", "cuLaunchKernel",
               "cuLaunchKernelEx")


def epoch_split(one_launch, args, opts, names) -> dict:
    """The device time of one call of a persistent epoch kernel, whose
    epoch must be one launch of its single kernel: ``one_launch`` the
    kernel's tag (its wrapper ``train_ops.fused_<tag>``, called with
    ``args`` and ``opts``), ``names[0]`` its device name.  ``device_ms``
    and ``device_split``: CUDA events around single calls queued behind
    a spin (``single_call_ms``: the launch, and its counters' memset and
    bias-correction copy).  ``device_launches``: kernel_split's counts
    from one trace, which must show one host launch call a call and that
    kernel's device records, and no other kernel's.  In a long process a
    trace may record no device kernel at all (seen on an H100); then the
    trace is taken in a fresh process (``--trace``), and
    ``device_trace_from`` says which trace the counts are."""
    fn = getattr(train_ops, f"fused_{one_launch}")

    def epoch():
        return fn(*args, **opts)
    counts, where = {}, "this process"
    kernel_split(epoch, names, counts=counts)
    if counts["device"] == 0:
        counts, where = fresh_trace(one_launch, args, opts, names), \
            "a fresh process"
    check(counts["api"] == 1 and 0 < counts["device"] <= 1
          and counts[names[0]] == counts["device"],
          f"{one_launch}: an epoch launched {counts} (profiled in {where}), "
          "not one kernel")
    ms = single_call_ms(epoch)
    return {"device_ms": ms, "device_split": {names[0]: ms},
            "device_launches": counts, "device_trace_from": where,
            "device_ms_from": "CUDA events around queued single calls"}


def fresh_trace(one_launch, args, opts, names) -> dict:
    """kernel_split's counts of ``train_ops.fused_<one_launch>(*args,
    **opts)`` traced in a new process of this script (``--trace``), on a
    copy of the inputs saved under build/."""
    path = os.path.join(ROOT, "build", "trace", f"{one_launch}.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"tag": one_launch, "names": list(names), "opts": opts,
                "args": [a.cpu() if torch.is_tensor(a) else a
                         for a in args]}, path)
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--trace", path], capture_output=True, text=True,
                         timeout=600)
    check(run.returncode == 0 and run.stdout.strip(),
          f"{one_launch}: the fresh process's trace failed: "
          f"{run.stderr[-2000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def trace_main(path: str) -> int:
    """``--trace PATH``: fresh_trace's child; prints the counts."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    rec = torch.load(path)
    args = [a.cuda() if torch.is_tensor(a) else a for a in rec["args"]]
    fn = getattr(train_ops, f"fused_{rec['tag']}")
    counts = {}
    kernel_split(lambda: fn(*args, **rec["opts"]), rec["names"],
                 counts=counts)
    print(json.dumps(counts))
    return 0


def single_call_ms(fn, calls: int = 5) -> float:
    """Mean device ms of one fn() call: CUDA events around it, queued
    behind a spin kernel, so that the host has queued the whole call
    before the device reaches the first event and the events hold the
    device's time of the call, not the host's.  The spin doubles until
    the first event is still pending when the call returns."""
    fn()
    torch.cuda.synchronize()
    total, spin = 0.0, 1 << 22          # cycles, ~2 ms at 1.98 GHz
    for _ in range(calls):
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            fn()
            end.record()
            covered = not start.query()
            torch.cuda.synchronize()
            if covered:
                break
            spin *= 2
        check(covered, "single_call_ms: the host did not queue the call "
              "before the device reached it")
        total += start.elapsed_time(end)
    return total / calls


def bound(moved, flops):
    """The least time of a function that moves ``moved`` bytes and does
    ``flops`` FP32 operations: the larger of the two at the peak rates."""
    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def config(dataset: str, **overrides) -> Config:
    values = {"data.root_dir": DATA, "data.dataset": dataset,
              "data.file_name": "ratings.csv", "data.sep": ","}
    values.update(overrides)
    return Config.from_properties(os.path.join(ROOT, "CleverRec.properties"),
                                  os.path.join(ROOT, "conf"), values)


def libfm_rows(part: str) -> np.ndarray:
    """[n, 3] (user, item, rating) of the repo's ml-100k libfm ``part``
    (`rating,<u>:1,<943+i>:1` lines): ids dense from 0, ratings 1-5."""
    rows = []
    path = os.path.join(ROOT, "benchmarks", "UIRT", f"ml100k.{part}.libfm")
    with open(path) as f:
        for line in f:
            r, u, i = line.strip().split(",")
            rows.append((int(u.split(":")[0]), int(i.split(":")[0]) - 943,
                         float(r)))
    return np.asarray(rows)


def write_ml100k() -> None:
    """ml-100k as UIRT csv from the repo's libfm copy, train then test;
    the time is the row's position."""
    table = np.concatenate([libfm_rows("train"),
                            libfm_rows("test")]).astype(np.int64)
    table = np.column_stack([table, np.arange(len(table))])
    os.makedirs(os.path.join(DATA, "ml-100k"), exist_ok=True)
    np.savetxt(os.path.join(DATA, "ml-100k", "ratings.csv"), table,
               fmt="%d", delimiter=",", header="u_id,i_id,rating,time",
               comments="")


def write_trusts(seed: int = TRUST_SEED) -> int:
    """A trust graph over the raw user ids of the rebuilt ml-100k (call
    ``write_ml100k`` first), written beside its ratings as
    ``trusts.csv`` (``u_id,v_id``, comma-separated like the ratings);
    returns the edge count.  Each user gets 1 + min(Geometric(0.15), 39)
    out-edges: each, with probability 0.8, to one of its 50 highest
    co-consumption users, else to any user; no self edges, no
    duplicates.  Friends so drawn share tastes (homophily) and, drawn
    from overlapping top-50 lists, friends (shared neighbourhoods)."""
    path = os.path.join(DATA, "ml-100k")
    table = np.loadtxt(os.path.join(path, "ratings.csv"), delimiter=",",
                       skiprows=1, dtype=np.int64)
    users, u_idx = np.unique(table[:, 0], return_inverse=True)
    _, i_idx = np.unique(table[:, 1], return_inverse=True)
    seen = np.zeros((len(users), i_idx.max() + 1), np.float32)
    seen[u_idx, i_idx] = 1.0
    co = seen @ seen.T
    np.fill_diagonal(co, -1.0)
    top = np.argsort(-co, axis=1, kind="stable")[:, :50]
    rng = np.random.default_rng(seed)
    lines = ["u_id,v_id"]
    for u in range(len(users)):
        want = 1 + min(int(rng.geometric(0.15)), 39)
        chosen: list[int] = []
        while len(chosen) < want:
            v = int(top[u, rng.integers(50)] if rng.random() < 0.8
                    else rng.integers(len(users)))
            if v != u and v not in chosen:
                chosen.append(v)
        lines += [f"{users[u]},{users[v]}" for v in chosen]
    with open(os.path.join(path, "trusts.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines) - 1


def write_catalog(n_items: int, n_users: int = 49152,
                  per_user: int = 40) -> str:
    """The synthetic catalog of benchmarks/catalog_scale.py: Pareto(1.2)
    popularity over the head, two uniform tail items per user, seed 7."""
    name = f"catalog-{n_items}"
    rng = np.random.default_rng(7)
    n_head = n_users * (per_user - 2)
    head = (rng.pareto(1.2, n_head) * n_items / 50).astype(np.int64)
    head = np.clip(head, 0, n_items - 1)
    tail = rng.integers(0, n_items, n_users * 2)
    items = np.concatenate([head, tail])
    users = np.concatenate([np.repeat(np.arange(n_users), per_user - 2),
                            np.repeat(np.arange(n_users), 2)])
    t = rng.integers(1_000_000, 2_000_000, items.shape[0])
    order = rng.permutation(items.shape[0])
    table = np.column_stack([users[order], items[order],
                             np.full(len(order), 5), t[order]])
    os.makedirs(os.path.join(DATA, name), exist_ok=True)
    np.savetxt(os.path.join(DATA, name, "ratings.csv"), table, fmt="%d",
               delimiter=",", header="u,i,r,t", comments="")
    return name


def seen_in(bits: np.ndarray, items: np.ndarray) -> np.ndarray:
    """Is items[r, j] (>= 0) set in row r of the int32 bitmaps?"""
    safe = np.maximum(items, 0)
    words = np.take_along_axis(bits.view(np.uint32), safe >> 5, axis=1)
    return ((words >> (safe & 31).astype(np.uint32)) & 1).astype(bool)


def check_answer(tag, got, want, bits, k, item_nums, offset=None):
    """Fused answer vs dense answer: same shape, scores within SERVE_RTOL
    (of the largest score, for a distance model, whose fused scores leave
    out each user's ``offset`` |u|^2), ids equal except among near-tied
    scores, no seen or out-of-range id."""
    (gi, gv), (wi, wv) = [(i.cpu().numpy(), v.cpu().numpy())
                          for i, v in (got, want)]
    atol = 0.0
    if offset is not None:
        wv = wv + offset[:, None]
        atol = SERVE_RTOL * np.abs(wv[np.isfinite(wv)]).max(initial=0.0)
    check(gi.shape == wi.shape == gv.shape == (bits.shape[0], k),
          f"{tag}: shape {gi.shape}")
    check(bool(np.isfinite(gv[gi >= 0]).all()), f"{tag}: non-finite score")
    check(bool(((gi >= -1) & (gi < item_nums)).all()), f"{tag}: id range")
    check(not seen_in(bits, gi)[gi >= 0].any(), f"{tag}: seen item served")
    check(bool(np.allclose(gv, wv, rtol=SERVE_RTOL, atol=atol)),
          f"{tag}: scores differ by {np.nanmax(np.abs(gv - wv))}")
    tol = SERVE_RTOL * np.abs(wv[np.isfinite(wv)]).max(initial=0.0)
    for r, j in zip(*np.nonzero(gi != wi)):
        others = np.delete(gv[r], j)
        tied = (np.abs(others - gv[r, j]) <= tol).any() or (
            abs(gv[r, j] - gv[r, -1]) <= tol)
        check(bool(tied), f"{tag}: row {r} rank {j}: id {gi[r, j]} vs "
              f"{wi[r, j]} at untied score {gv[r, j]}")
    return int((gi != wi).sum())


def breakdown(fn, top: int = 8) -> dict:
    """Device time of one fn() call by kernel, after one warm-up call:
    the top kernels, their sum, and the call's wall time.  Summed from
    torch.profiler's raw device records (kernels, copies), which every
    profile reads the same way; its per-op event tree, ``key_averages``,
    took more than a minute to build for one NAIS epoch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = sync_s(fn)
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = by_name.get(e.name()[:70], (0.0, 0))
            by_name[e.name()[:70]] = (ms + e.duration_ns() / 1e6, n + 1)
    kernels = sorted(by_name.items(), key=lambda x: -x[1][0])
    return {"wall_ms": wall * 1e3,
            "device_ms": sum(ms for ms, _ in by_name.values()),
            "top": [{"kernel": name, "ms": ms, "count": n}
                    for name, (ms, n) in kernels[:top]]}


def seen_bits(dd, users):
    """The users' packed seen bitmaps, int32 numpy: rows of the global
    table, or built from their sorted rows past its budget."""
    if dd.seen.bits is not None:
        return dd.seen.bits[users]
    return rows_to_bits(torch.as_tensor(dd.seen.rows[users]),
                        dd.item_nums).numpy()


def serve(tag, model, dd, k, users_per_call, backend, expect, rng,
          profiles, aux=None, offset=None):
    """Serve 4 calls through ``backend``, which must resolve to
    ``expect``, and hold each to dense; time both backends and add a
    kernel breakdown of one call of each to ``profiles``.  ``aux``: the
    model's (default none); ``offset``: a distance model's |u|^2 of every
    user, which its fused scores leave out.  Returns the calls' users,
    the times and the dense answers."""
    fast = build_retrieval_fn(model, aux, dd, k=k, backend=backend)
    check(fast.backend == expect, f"{tag}: {backend} picked {fast.backend}")
    dense = build_retrieval_fn(model, aux, dd, k=k, backend="dense")
    calls = [np.sort(rng.choice(dd.user_nums, users_per_call, replace=False))
             for _ in range(4)]
    swaps, fast_s, answers = 0, [], []
    for u in calls:
        got, s = sync_s(lambda: fast(u))
        fast_s.append(s)
        answers.append(dense(u))
        swaps += check_answer(tag, got, answers[-1], seen_bits(dd, u), k,
                              dd.item_nums,
                              offset=None if offset is None else offset[u])
    u = calls[0]

    def per_call_ms(fn):
        return sync_s(lambda: [fn(u) for _ in range(10)])[1] * 100

    times = {f"{tag}_serve_first_call_s": fast_s[0],
             f"{tag}_serve_{expect}_ms": per_call_ms(fast),
             f"{tag}_serve_dense_ms": per_call_ms(dense),
             f"{tag}_tied_id_swaps": swaps}
    profiles[f"{tag}_{expect}"] = breakdown(lambda: fast(u))
    profiles[f"{tag}_dense"] = breakdown(lambda: dense(u))
    return calls, times, answers


def evaluate(tag, evaluator, aux=None):
    evaluator.evaluate(aux)               # first use loads CUDA modules
    res, s = sync_s(lambda: evaluator.evaluate(aux))
    host = evaluator.evaluate_host(aux)
    for k, vals in res.items():
        check(all(np.isfinite(x) and 0.0 <= x for x in vals),
              f"{tag}: metrics {vals}")
        check(bool(np.allclose(vals, host[k], atol=METRIC_TOL, rtol=0)),
              f"{tag}: device {vals} vs host {host[k]} metrics")
    return res, s


def phase_a(rng, profiles):
    write_ml100k()
    t0 = time.perf_counter()
    cfg = config("ml-100k", **{"test.neg_samples": "0",
                               "data.split_way": "rs"})
    data = load_ranking_data(cfg)
    dd = build_device_data(data)
    load_s = time.perf_counter() - t0
    check((data.user_nums, data.item_nums) == (943, 1682),
          f"ml-100k: {data.stats_line()}")
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    calls, times, _ = serve("A", model, dd, 10, 256, "auto", "fused", rng,
                            profiles)
    times["A_load_s"] = load_s

    fused_ev = Evaluator(model, dd, cfg)
    full_ev = Evaluator(model, dd, cfg.with_overrides(
        **{"eval.fused_kernel": "False"}))
    check((fused_ev.mode, full_ev.mode) == ("full_fused", "full"),
          f"eval modes {fused_ev.mode}, {full_ev.mode}")
    got, times["A_eval_full_fused_s"] = evaluate("full_fused", fused_ev)
    want, times["A_eval_full_s"] = evaluate("full", full_ev)
    for k in cfg.topk:
        check(bool(np.allclose(got[k], want[k], atol=METRIC_TOL, rtol=0)),
              f"@{k}: full_fused {got[k]} vs full {want[k]}")
    # Past the global bitmap budget (a member table with budget 0): the
    # test users' bitmaps are built once from their sorted rows.
    dd0 = dataclasses.replace(dd, seen=build_member_table(
        data.ui_train, data.user_nums, data.item_nums, bitmap_budget=0))
    check(dd0.seen.bits is None, "budget 0: a bitmap table was built")
    past_ev = Evaluator(model, dd0, cfg)
    check(past_ev.mode == "full_fused" and "bits" in past_ev._batches,
          f"past the budget: mode {past_ev.mode}, test bitmaps built once "
          f"{'bits' in past_ev._batches}")
    before = scores.launches["dot_scores"]
    past, times["A_eval_full_fused_past_budget_s"] = evaluate(
        "full_fused past the budget", past_ev)
    times["A_past_budget_dot_scores_launches"] = (
        scores.launches["dot_scores"] - before)
    for k in cfg.topk:
        check(bool(np.allclose(past[k], want[k], atol=METRIC_TOL, rtol=0)),
              f"@{k}: full_fused past the budget {past[k]} vs full "
              f"{want[k]}")

    cand_cfg = config("ml-100k")                  # loo, 99 negatives
    cand_data = load_ranking_data(cand_cfg)
    cand_ev = Evaluator(model, build_device_data(cand_data), cand_cfg)
    check(cand_ev.mode == "candidate", f"eval mode {cand_ev.mode}")
    cand, times["A_eval_candidate_s"] = evaluate("candidate", cand_ev)
    metrics = {"full_fused": got, "full": want, "candidate": cand,
               "full_fused_past_budget": past}
    # The users of the full_fused eval's first batch: the test users
    # wrapped to a whole batch of test.batch_size, as the Evaluator pads.
    eval_users = dd.test_users[np.arange(cfg.test_batch_size)
                               % len(dd.test_users)]
    return model, dd, calls, eval_users, times, metrics


def phase_b(rng, profiles):
    t0 = time.perf_counter()
    name = write_catalog(131072)
    cfg = config(name, **{"data.split_way": "rs",
                          "data.split_ratio": "[0.8,0.0,0.2]",
                          "test.neg_samples": "0"})
    data = load_ranking_data(cfg)
    dd = build_device_data(data)
    load_s = time.perf_counter() - t0
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    calls, times, _ = serve("B", model, dd, 20, 1024, "fused", "fused", rng,
                            profiles)
    times["B_data_s"] = load_s
    times["B_items"] = data.item_nums
    times.update(serve_approx("B", model, dd, 20, calls))
    return model, dd, calls, times


@contextlib.contextmanager
def plain_gmax():
    """``rank_fused`` with ``dot_gmax``'s plain version in place of the
    kernel: the plain version of the fused path, on the same device."""
    from cleverrec_tpu_torch import ranking
    kernel = ranking.dot_gmax
    ranking.dot_gmax = scores.dot_gmax_ref
    try:
        yield
    finally:
        ranking.dot_gmax = kernel


def serve_approx(tag, model, dd, k, calls):
    """``approx`` on the ``fused`` backend (the bf16 rescue copy) on the
    serving calls' users: each answer held to the same path with
    ``dot_gmax``'s plain version (scores within SERVE_RTOL of each other,
    ids equal but among near-ties, no seen item), its top-k id agreement
    with the exact fused answer, and the ms of a call of both."""
    approx = build_retrieval_fn(model, None, dd, k=k, backend="fused",
                                approx=True)
    exact = build_retrieval_fn(model, None, dd, k=k, backend="fused")
    before = scores.launches["dot_gmax"]
    swaps, same, err = 0, 0, 0.0
    for u in calls:
        got = approx(u)
        with plain_gmax():
            want = approx(u)
        bits = seen_bits(dd, u)
        swaps += check_answer(f"{tag} approx", got, want, bits, k,
                              dd.item_nums)
        err = max(err, float((got[1] - want[1]).abs().max()))
        gi, ei = got[0].cpu().numpy(), exact(u)[0].cpu().numpy()
        same += sum(len(np.intersect1d(a, b)) for a, b in zip(gi, ei))
    u = calls[0]

    def per_call_ms(fn):
        return sync_s(lambda: [fn(u) for _ in range(10)])[1] * 100

    return {f"{tag}_approx_ms": per_call_ms(approx),
            f"{tag}_exact_fused_ms": per_call_ms(exact),
            # approx's calls and the exact calls beside them.
            f"{tag}_approx_dot_gmax_launches": (scores.launches["dot_gmax"]
                                                - before),
            f"{tag}_approx_topk_id_agreement": same / (len(calls)
                                                       * len(u) * k),
            f"{tag}_approx_vs_plain_max_abs_err": err,
            f"{tag}_approx_tied_id_swaps": swaps}


def phase_h(rng, profiles):
    """Catalog-scale ranking: serving through ``auto`` (``stream``), the
    Evaluator's default ``full_stream`` mode, and kernel 2.9 ranking the
    serving calls' users."""
    t0 = time.perf_counter()
    name = write_catalog(H_IDS)
    cfg = config(name, **{"data.split_way": "rs",
                          "data.split_ratio": "[0.8,0.0,0.2]",
                          "test.neg_samples": "0"})
    data = load_ranking_data(cfg)
    dd = build_device_data(data)
    load_s = time.perf_counter() - t0
    check(data.item_nums > STREAM_THRESHOLD and dd.seen.bits is None,
          f"H: {data.item_nums} items, global bitmaps "
          f"{'built' if dd.seen.bits is not None else 'past the budget'}")
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    calls, times, answers = serve("H", model, dd, H_K, 1024, "auto",
                                  "stream", rng, profiles)
    times.update({"H_data_s": load_s, "H_items": data.item_nums,
                  "H_users": data.user_nums})

    # Kernel 2.9 on each call's users: rank its masked scores with topk
    # and translate through its item_map, held against dense.
    swaps = 0
    for u, want in zip(calls, answers):
        u_idx = torch.as_tensor(u, device="cuda")
        with torch.no_grad():
            uv = model.P[u_idx].contiguous()
            q = model.Q.detach().contiguous()
        bits = rows_to_bits(torch.as_tensor(dd.seen.rows[u], device="cuda"),
                            data.item_nums)
        sc, _, item_map = scores.dot_topk_scores(uv, q, bits)
        v, idx = topk(sc, H_K)
        items = torch.where(v > -1e37, item_map[idx], -1)
        v = torch.where(v > -1e37, v, -torch.inf)
        swaps += check_answer("H dot_topk_scores", (items, v), want,
                              bits.cpu().numpy(), H_K, data.item_nums)
        del sc, v, idx
    times["H_dot_topk_tied_id_swaps"] = swaps

    stream_ev = Evaluator(model, dd, cfg)
    check(stream_ev.mode == "full_stream" and stream_ev.stream_chunk == 16384,
          f"H: eval mode {stream_ev.mode}, chunk {stream_ev.stream_chunk}")
    got, times["H_eval_full_stream_s"] = evaluate("H full_stream", stream_ev)
    others = {}
    for tag, mode, over in (
            ("full", "full", {"eval.stream": "False",
                              "eval.fused_kernel": "False"}),
            ("full_stream_4096", "full_stream",
             {"eval.stream_chunk": "4096"})):
        ev = Evaluator(model, dd, cfg.with_overrides(**over))
        check(ev.mode == mode, f"H: {tag} mode {ev.mode}")
        ev.evaluate()                     # first use, as evaluate() does
        others[tag], times[f"H_eval_{tag}_s"] = sync_s(ev.evaluate)
        for k in cfg.topk:
            check(bool(np.allclose(got[k], others[tag][k], atol=METRIC_TOL,
                                   rtol=0)),
                  f"H @{k}: full_stream {got[k]} vs {tag} {others[tag][k]}")
        del ev
    metrics = {"full_stream": got, **others}
    return model, dd, calls[0], times, metrics


def kernel_rows(name, shapes, launches, ref, kernel, replaces, out_elems):
    """Hold ``kernel`` to ``ref`` on each phase's inputs, with and without
    bias, and time it; one row of the kernels line.  ``out_elems(B, I)``:
    the floats the kernel writes."""
    row = {"name": name, "route": "cuda",
           "source": "cleverrec_tpu_torch/csrc/dot_scores.cu",
           "replaces": replaces, "launches": launches, "max_abs_err": 0.0}
    timings = []
    for tag, (u, q, bits, bias) in shapes.items():
        for b in (None, bias):
            got, want = kernel(u, q, bits, b), ref(u, q, bits, b)
            torch.cuda.synchronize()
            if isinstance(got, tuple):          # dot_topk_scores
                check(bool(torch.equal(got[2], want[2])),
                      f"{name} {tag}: item_map differs")
                parts = zip(("scores", "gmax"), got[:2], want[:2])
            else:
                parts = [(name, got, want)]
            for part, g, w in parts:
                masked = w == scores.NEG
                check(bool(torch.equal(g == scores.NEG, masked)),
                      f"{name} {tag} {part}: masked slots differ")
                err = (g[~masked] - w[~masked]).abs()
                check(bool(torch.isfinite(g[~masked]).all()),
                      f"{name} {tag} {part}: non-finite")
                check(bool((err <= KERNEL_ATOL
                            + KERNEL_RTOL * w[~masked].abs()).all()),
                      f"{name} {tag} {part}: max error {err.max().item()}")
                row["max_abs_err"] = max(row["max_abs_err"],
                                         err.max().item())
            del got, want
        bsz, d = u.shape
        n_items = q.shape[0]
        # Each input read once and each output written once; FP32
        # operations of the product.
        moved = 4 * (u.numel() + q.numel() + bits.numel()
                     + out_elems(bsz, n_items))
        flops = 2 * bsz * n_items * d
        # ms is what a caller pays a call; wrapper_us is the host's time to
        # issue one of the same calls (the Python wrapper and the launch),
        # device_ms the kernel's own time (every scoring kernel's name
        # starts dot_).
        ms, wrapper_us = timed(lambda: kernel(u, q, bits))
        t = {"shape": tag, "B": bsz, "I": n_items, "d": d,
             "ms": ms, "wrapper_us": wrapper_us,
             "device_ms": device_ms(lambda: kernel(u, q, bits), "dot_"),
             "ms_bias": time_ms(lambda: kernel(u, q, bits, bias)),
             "plain_ms": time_ms(lambda: ref(u, q, bits), iters=5),
             "library_ms": time_ms(lambda: torch.matmul(u, q.T)),
             "library_device_ms": device_ms(lambda: torch.matmul(u, q.T)),
             "bytes": moved, "flops": flops, **bound(moved, flops)}
        if kernel in (scores.dot_scores, scores.dot_gmax):
            t["tile"] = scores.SCORE_TILES[scores._tiling(u, q)[0]]
        timings.append(t)
    main = timings[0]
    row.update({key: main[key] for key in (
        "ms", "device_ms", "wrapper_us", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "library_device_ms")})
    row["timings"] = timings
    return row


def kernel_inputs(model, dd, users, gen):
    u_idx = torch.as_tensor(users, device="cuda").long()
    with torch.no_grad():
        u = model.P[u_idx].contiguous()
        q = model.Q.detach().contiguous()
    bits = torch.as_tensor(seen_bits(dd, users), device="cuda")
    bias = torch.randn(q.shape[0], generator=gen).cuda()
    return u, q, bits, bias


def border_inputs(rng, gen, b=1024, n_items=4096, d=128):
    """``dot_scores`` at the narrow branch's border (the widest catalog
    ``rank_fused`` scores in full): u, q and bias from ``gen``, seen bitmaps
    with a 5% fill from ``rng``."""
    u, q = (torch.randn(n, d, generator=gen).cuda() for n in (b, n_items))
    seen = rng.random((b, n_items)) < 0.05
    bits = np.packbits(seen, axis=1, bitorder="little").view(np.int32)
    bias = torch.randn(n_items, generator=gen).cuda()
    return u, q, torch.as_tensor(bits, device="cuda"), bias


class Records(logging.Handler):
    """Collects the numbers the trainer's log records carry."""

    def __init__(self):
        super().__init__()
        self.train, self.eval, self.bests, self.buckets = [], [], [], []
        self.forms, self.meshes = [], []

    @property
    def best(self):
        return self.bests[-1] if self.bests else None

    def emit(self, record):
        if hasattr(record, "train"):
            self.train.append(record.train)
        if hasattr(record, "eval"):
            self.eval.append(record.eval)
        if hasattr(record, "best"):
            self.bests.append(record.best)
        if hasattr(record, "buckets"):
            self.buckets.append(record.buckets)
        if hasattr(record, "fused_form"):
            self.forms.append(record.fused_form)
        if hasattr(record, "mesh_tier"):
            self.meshes.append(record.mesh_tier)


def cli_argv(model, flags, values):
    argv = ["--config", os.path.join(ROOT, "CleverRec.properties"),
            "--conf-dir", os.path.join(ROOT, "conf"), "--model", model,
            *flags]
    for k, v in values.items():
        argv += ["--set", f"{k}={v}"]
    return argv


def cli_values(epochs, **overrides):
    """drive_cli's settings: the rebuilt ml-100k, the logs, ``epochs``."""
    return {"data.root_dir": DATA, "data.file_name": "ratings.csv",
            "data.sep": ",", "log.dir": LOGS, "epoches": epochs,
            **overrides}


def run_cli(tag, model, flags, values):
    """Run the port's CLI on ``model``'s recipe (CleverRec.properties and
    its conf) with the ``values`` set and the further ``flags``; its log
    goes to build/logs/<tag>.log.  Returns (wall seconds, the log's
    records, the kernel launches, counts set to 0 first)."""
    argv = cli_argv(model, flags, values)
    os.makedirs(LOGS, exist_ok=True)
    records = Records()
    log_file = logging.FileHandler(os.path.join(LOGS, f"{tag}.log"))
    log_file.setFormatter(logging.Formatter("%(asctime)s  %(message)s"))
    # Handlers set before the CLI's get_logger keep its log off stdout.
    logger = logging.getLogger(f"cleverrec_tpu_torch.{model}"
                               + ("_tune" if "--tune" in flags else ""))
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in (records, log_file):
        logger.addHandler(h)
    scores.reset_launches()
    train_ops.reset_launches()
    try:
        rc, wall = sync_s(lambda: cli.main(argv))
    finally:
        for h in (records, log_file):
            logger.removeHandler(h)
        log_file.close()
    check(rc == 0, f"{tag}: cli exit code {rc}")
    return wall, records, {**scores.launches, **train_ops.launches}


def drive_cli(tag, model="BPR", epochs=EPOCHS, flags=(), runs=None,
              trials=1, **overrides):
    """Run the port's CLI (``run_cli``) on ``model``'s recipe, on the
    rebuilt ml-100k, for ``epochs`` epochs with ``overrides`` and the
    further ``flags``.  ``runs`` is the epochs a run trains (all of them
    unless it resumes), ``trials`` the runs (``--tune``'s grid).  Returns
    the (last) run's numbers and all the kernel launches."""
    wall, records, launches = run_cli(tag, model, flags,
                                      cli_values(epochs, **overrides))
    runs = (epochs if runs is None else runs) * trials
    check(len(records.train) == runs == len(records.eval)
          and len(records.bests) == trials,
          f"{tag}: {len(records.train)} epochs, {len(records.eval)} evals, "
          f"{len(records.bests)} runs")
    losses = [r["losses"][-1] for r in records.train]
    check(all(np.isfinite(losses)), f"{tag}: losses {losses}")
    train_ms = [r["seconds"] * 1e3 for r in records.train]
    eval_ms = [r["seconds"] * 1e3 for r in records.eval]
    best = {f"{name}@{k}": v for k, vals in records.best["metrics"].items()
            for name, v in zip(("HR", "MRR", "NDCG"), vals)}
    check(all(np.isfinite(v) and 0 <= v <= 1 for v in best.values()),
          f"{tag}: best metrics {best}")
    last = {f"{name}@{k}": v
            for k, vals in records.eval[-1]["metrics"].items()
            for name, v in zip(("HR", "MRR", "NDCG"), vals)}
    return {"wall_s": wall, "launches": launches,
            "epoch_first_ms": train_ms[0],
            "epoch_ms_median": statistics.median(train_ms[1:] or train_ms),
            "eval_ms_median": statistics.median(eval_ms),
            "loss_first": losses[0], "loss_last": losses[-1],
            "best_epoch": records.best["epoch"], "best": best,
            "last": last, "bests": [b["ndcg"] for b in records.bests],
            "epoch_ms": train_ms, "losses": losses,
            "buckets": records.buckets[-1] if records.buckets else None,
            "fused_form": records.forms[-1] if records.forms else None,
            "mesh_tier": records.meshes[-1] if records.meshes else None}


def phase_c():
    """The default recipe (embed 128) through the fused tier."""
    res = drive_cli("C")
    check(res["launches"]["bpr_epoch"] == EPOCHS,
          f"C: bpr_epoch launched {res['launches']['bpr_epoch']} times")
    check(res["loss_last"] < res["loss_first"],
          f"C: loss {res['loss_first']} -> {res['loss_last']}")
    check(res["best"]["HR@10"] >= MIN_HR10,
          f"C: best HR@10 {res['best']['HR@10']} < {MIN_HR10}")
    return res


def phase_d():
    """The JAX parity recipe (embed 64) through both tiers, held to each
    other.  The JAX package's best metrics for this recipe were taken on
    the real ``u.data``, where leave-one-out holds out each user's latest
    rating.  ``benchmarks/UIRT/ml100k.*.libfm`` holds the same ratings
    shuffled (``u.data``'s second and third rows are train lines 13696
    and 62849), so here the time is a row's position and the held-out
    rating is a random one, an easier test: they are reported beside the
    port's, not held to a band."""
    with open(os.path.join(ROOT, "benchmarks", "PARITY_BPR.json")) as f:
        jax_best = json.load(f)["best_ours"]["10"]
    runs = {"fused": drive_cli("D_fused", embed_size=64),
            "scan": drive_cli("D_scan", embed_size=64,
                              **{"train.fused_kernel": "False"})}
    check(runs["fused"]["launches"]["bpr_epoch"] == EPOCHS
          and runs["scan"]["launches"]["bpr_epoch"] == 0,
          f"D: launches {runs['fused']['launches']}, "
          f"{runs['scan']['launches']}")
    for key, band in TIER_BAND.items():
        a, b = runs["fused"]["best"][key], runs["scan"]["best"][key]
        check(abs(a - b) <= band, f"D: {key} fused {a} vs scan {b}")
    return {"jax_on_u_data": {"HR@10": jax_best[0], "NDCG@10": jax_best[2]},
            **runs}


def phase_e():
    """The NCF family at its confs' widths, 30 epochs each through the
    fused tier; then 3 epochs of each through both tiers on identical
    draws."""
    runs, tiers = {}, {}
    for name in NCF:
        res = runs[name] = drive_cli(f"E_{name}", model=name)
        kernel = NCF_KERNEL[name]
        check(res["launches"][kernel] == EPOCHS
              and sum(res["launches"].values()) == EPOCHS,
              f"E {name}: launches {res['launches']}")
        check(res["loss_last"] < res["loss_first"],
              f"E {name}: loss {res['loss_first']} -> {res['loss_last']}")
        floor = JAX_HR10[name] - JAX_BAND
        check(res["best"]["HR@10"] >= floor,
              f"E {name}: best HR@10 {res['best']['HR@10']} < {floor}")
        pair = {"fused": drive_cli(f"E_{name}_fused", model=name,
                                   epochs=TIER_EPOCHS),
                "scan": drive_cli(f"E_{name}_scan", model=name,
                                  epochs=TIER_EPOCHS,
                                  **{"train.fused_kernel": "False"})}
        check(pair["fused"]["launches"][kernel] == TIER_EPOCHS
              and sum(pair["scan"]["launches"].values()) == 0,
              f"E {name}: tier launches {pair['fused']['launches']}, "
              f"{pair['scan']['launches']}")
        for key, band in TIER_BAND.items():
            a, b = pair["fused"]["best"][key], pair["scan"]["best"][key]
            check(abs(a - b) <= band, f"E {name}: {key} fused {a} vs scan {b}")
        if kernel == "mlp_epoch":
            head = res["losses"][:TIER_EPOCHS]
            check(head == pair["fused"]["losses"],
                  f"E {name}: the run's first losses {head}, again "
                  f"{pair['fused']['losses']}")
        tiers[name] = pair
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("gmf_epoch", "mlp_epoch")}
    check(launches == {"gmf_epoch": EPOCHS, "mlp_epoch": 2 * EPOCHS},
          f"E: launches {launches}")
    return {"runs": runs, "tiers": tiers, "launches": launches}


def social_stats(edges):
    """The trust graph's edge count and how many users have SPu, and both
    tie classes, in the split SBPR and TBPR train on."""
    from cleverrec_tpu_torch.data.social import (build_spu,
                                                 build_tie_partitioned_spu)
    cfg = config("ml-100k", recommender="TBPR")
    data = load_ranking_data(cfg)
    spu, _ = build_spu(data.ui_train, data.user_friends)
    strong, weak = build_tie_partitioned_spu(
        data.ui_train, data.user_friends, cfg.float("strong_ratio", 0.5))
    return {"edges": edges, "users": data.user_nums,
            "users_with_friends": len(data.user_friends),
            "users_with_spu": len(spu),
            "users_with_both_tie_classes": len(set(strong) & set(weak))}


def phase_f():
    """The social-triple family at its confs' widths, SOCIAL_EPOCHS each
    through the fused tier; then 3 epochs of each through the fused tier,
    the scan tier and the streamed option, on identical draws (CUNE_BPR's
    on its conf run's latent friends)."""
    stats = social_stats(write_trusts())
    print("phase F trust graph: " + json.dumps(stats), flush=True)
    runs, tiers = {}, {}
    with cune_friends_once():
        for name in SOCIAL:
            res = runs[name] = drive_cli(f"F_{name}", model=name,
                                         epochs=SOCIAL_EPOCHS)
            check(res["launches"]["rows_epoch"] == SOCIAL_EPOCHS
                  and sum(res["launches"].values()) == SOCIAL_EPOCHS,
                  f"F {name}: launches {res['launches']}")
            check(res["loss_last"] < res["loss_first"],
                  f"F {name}: loss {res['loss_first']} -> "
                  f"{res['loss_last']}")
            floor = JAX_SOCIAL_HR10[name] - JAX_BAND
            check(res["best"]["HR@10"] >= floor,
                  f"F {name}: best HR@10 {res['best']['HR@10']} < {floor}")
            trio = {"fused": drive_cli(f"F_{name}_fused", model=name,
                                       epochs=TIER_EPOCHS),
                    "scan": drive_cli(f"F_{name}_scan", model=name,
                                      epochs=TIER_EPOCHS,
                                      **{"train.fused_kernel": "False"}),
                    "stream": drive_cli(f"F_{name}_stream", model=name,
                                        epochs=TIER_EPOCHS,
                                        **{"train.fused_stream": "True"})}
            got = {t: r["launches"]["rows_epoch"] for t, r in trio.items()}
            check(got == {"fused": TIER_EPOCHS, "scan": 0,
                          "stream": TIER_EPOCHS}
                  and sum(trio["scan"]["launches"].values()) == 0,
                  f"F {name}: tier launches {got}")
            for other in ("scan", "stream"):
                for key, band in TIER_BAND.items():
                    a, b = trio["fused"]["best"][key], trio[other]["best"][key]
                    check(abs(a - b) <= band,
                          f"F {name}: {key} fused {a} vs {other} {b}")
            tiers[name] = trio
    launches = sum(r["launches"]["rows_epoch"] for r in runs.values())
    check(launches == len(SOCIAL) * SOCIAL_EPOCHS,
          f"F: rows_epoch launched {launches} times in the conf runs")
    return {"trust_graph": stats, "runs": runs, "tiers": tiers,
            "launches": {"rows_epoch": launches}}


@contextlib.contextmanager
def cune_friends_once():
    """A context in which CUNE_BPR's latent friends (``build_cune_friends``:
    the random walks, the skip-gram and the top-K, ~13 s a run on the
    card) are built by the first run and handed as they are to each later
    run on the same arguments and ``ui_train``, which would rebuild them
    from the same seed."""
    from cleverrec_tpu_torch.data import social
    build, memo = social.build_cune_friends, {}

    def once(ui_train, *args, **kwargs):
        key = repr((args, sorted(kwargs.items())))
        if key not in memo or memo[key][0] != ui_train:
            memo[key] = (ui_train, build(ui_train, *args, **kwargs))
        return memo[key][1]
    social.build_cune_friends = once
    try:
        yield
    finally:
        social.build_cune_friends = build


def one_epoch_in(name, **overrides):
    """The main path's trainer for ``name`` on ml-100k (its conf with
    ``overrides``), its state after one trained epoch, and the next
    epoch's draw."""
    cfg = config("ml-100k", recommender=name, **overrides)
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    trainer = Trainer(model, data, cfg)
    check(trainer.fused, f"{name}: the recipe must take the fused tier")
    params, state = trainer.init_state()
    params, state, _ = trainer.train_epoch(params, state)
    return cfg, data, model, trainer, params, state, trainer.sample_epoch()


def sentinel_ids(data, tensors, names):
    u_sent, i_sent = (n - 1 for n in train_ops.sentinel_dims(
        data.user_nums, data.item_nums))
    inval = tensors["w"] == 0
    return [torch.where(inval, u_sent if k == "u" else i_sent, tensors[k])
            .to(torch.int32).contiguous() for k in names]


def hold(tag, pairs, atol, rtol):
    """Each (name, got, want) within atol + rtol |want|; the max errors."""
    errors = {}
    for name, g, w in pairs:
        check(bool(torch.isfinite(g).all()), f"{tag} {name}: non-finite")
        errors[name] = (g - w).abs().max().item()
        check(bool(((g - w).abs() <= atol + rtol * w.abs()).all()),
              f"{tag} {name}: max error {errors[name]}")
    return errors


def gmf_row(launches, profiles):
    """gmf_epoch against its plain version at GMF's main shape (ml-100k,
    embed 64, B 6144) on the state one epoch in and the next draw."""
    cfg, data, model, trainer, params, state, tensors = one_epoch_in("GMF")
    ids = sentinel_ids(data, tensors, ("u", "i"))
    y = tensors["y"].contiguous()
    names = ("P", "Q", "h_gmf")
    base = [params[n].detach() for n in names] + [
        t[n] for n in names for t in (state.mu, state.nu)]
    opts = {"lr": cfg.lr, "reg": model.reg}
    got, want = [x.clone() for x in base], [x.clone() for x in base]
    loss = train_ops.fused_gmf_epoch(*got, *ids, y, state.count, **opts)
    ref = train_ops.fused_gmf_epoch_ref(*want, *ids, y, state.count, **opts)
    torch.cuda.synchronize()
    labels = ("P", "Q", "h", "mP", "vP", "mQ", "vQ", "mh", "vh")
    errors = hold("gmf_epoch", zip(labels, got, want), EPOCH_ATOL,
                  EPOCH_RTOL)
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL, f"gmf_epoch loss: rel error {loss_rel}")
    k_state, r_state = [x.clone() for x in base], [x.clone() for x in base]
    steps, b = ids[0].shape
    u_n, i_n, d = data.user_nums, data.item_nums, model.embed_size
    n_real = int((tensors["w"] != 0).sum())
    n_state = (u_n + i_n + 1) * d
    # Each input read once and each output written once: nine state
    # tensors in and out, the u, i and y planes, the per-step loss.
    moved = 4 * (18 * n_state + 3 * steps * b + steps)
    # FP32 operations: 19 d per real slot (the product, the dot with h,
    # two squared norms, two row grads, dh, two scatter-adds) and 14 per
    # element of P, Q and h per step for Adam.
    flops = 19 * d * n_real + 14 * n_state * steps
    args = (*k_state, *ids, y, state.count)

    def epoch():
        return train_ops.fused_gmf_epoch(*args, **opts)
    row = {"name": "gmf_epoch", "route": "cuda",
           "source": "cleverrec_tpu_torch/csrc/gmf_epoch.cu",
           "replaces": "cleverrec_tpu/ops/pallas_train.py:440",
           "launches": launches, "max_abs_err": max(errors.values()),
           "ms": time_ms(epoch),
           # The kernel's own device time in one epoch: one launch.
           **epoch_split("gmf_epoch", args, opts, ("gmf_persist",)),
           "variant": "float4" if train_ops.rows_vec(k_state) else "scalar",
           "plain_ms": time_ms(lambda: train_ops.fused_gmf_epoch_ref(
               *r_state, *ids, y, state.count, **opts), iters=5),
           **bound(moved, flops),
           # No single PyTorch call trains an epoch.
           "library_ms": None,
           "errors": errors, "loss_rel_err": loss_rel,
           "shape": {"U": u_n, "I": i_n, "d": d, "B": b, "steps": steps,
                     "real_slots": n_real, "bytes": moved, "flops": flops}}
    profiles["E_GMF_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    return row


def mlp_run(cfg, spec, params, state, ids, cols):
    """mlp_epoch and its plain version from one state on one draw: (the
    kernel's state, the plain version's, their losses, a function that
    makes fresh copies of the starting state)."""
    def groups():
        out = []
        for t in (params, state.mu, state.nu):
            out += [torch.cat([t[n].detach() for n in spec["u"]], 1),
                    torch.cat([t[n].detach() for n in spec["i"]], 1),
                    [t[n].detach().clone() for n in spec["dense"]]]
        return out

    got, want = groups(), groups()
    loss = train_ops.fused_mlp_epoch(*got, *ids, *cols, state.count,
                                     spec=spec, lr=cfg.lr)
    ref = train_ops.fused_mlp_epoch_ref(*want, *ids, *cols, state.count,
                                        row_loss=spec["row_loss"], lr=cfg.lr)
    torch.cuda.synchronize()
    return got, want, loss, ref, groups


def mlp_hold(spec, got, want, loss, ref):
    """``mlp_run``'s two results held to each other: (max errors, loss
    relative error)."""
    errors = {}
    for k, part in enumerate(("", "m_", "v_")):
        errors.update(hold("mlp_epoch", ((part + n, got[3 * k + j],
                                          want[3 * k + j])
                                         for j, n in enumerate(("PU", "QI"))),
                           EPOCH_ATOL, EPOCH_RTOL))
        errors.update(hold("mlp_epoch", zip((part + n for n in spec["dense"]),
                                            got[3 * k + 2], want[3 * k + 2]),
                           DENSE_ATOL, DENSE_RTOL))
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= MLP_LOSS_RTOL, f"mlp_epoch loss: rel error {loss_rel}")
    return errors, loss_rel


def mlp_timing(name, profiles):
    """mlp_epoch against its plain version at ``name``'s main shape on the
    state one epoch in and the next draw: errors, times, bound."""
    cfg, data, model, trainer, params, state, tensors = one_epoch_in(name)
    spec = model.fused_mlp_spec()
    ids = sentinel_ids(data, tensors, ("u", "i"))
    cols = [tensors[k].to(torch.float32).contiguous() for k in ("y", "w")]
    got, want, loss, ref, groups = mlp_run(
        cfg, spec, params, state, [x[:MLP_HELD_STEPS] for x in ids],
        [x[:MLP_HELD_STEPS] for x in cols])
    errors, loss_rel = mlp_hold(spec, got, want, loss, ref)
    k_state, r_state = groups(), groups()
    steps, b = ids[0].shape
    n_layers = (len(spec["dense"]) - 1) // 2
    shapes = [tuple(getattr(model, n).shape) for n in spec["dense"][:n_layers]]
    macs = sum(i * o for i, o in shapes)
    n_real = int((tensors["w"] != 0).sum())
    n_state = sum(x.numel() for x in k_state[0:2]) + sum(
        x.numel() for x in k_state[2])
    # Each input read once and each output written once: the params and
    # both moments in and out, the u, i, y and w planes, the loss.
    moved = 4 * (6 * n_state + 4 * steps * b + steps)
    # FP32 operations: the tower's products, 2 sum(in out) a real row
    # forward and 4 sum(in out) backward (dW and dx), and 14 per element
    # of every param per step for Adam; the O(width) terms of a row
    # (gather, GMF product, logit, regularisers, scatter) are left out,
    # so the bound is lower than the work.
    flops = 6 * macs * n_real + 14 * n_state * steps
    lay = train_ops.mlp_epoch_plan(spec["gmf_width"], shapes, b,
                                   scores._sms(k_state[0].device.index))

    def epoch():
        return train_ops.fused_mlp_epoch(*k_state, *ids, *cols, state.count,
                                         spec=spec, lr=cfg.lr)
    # The kernel's own device time in one epoch: its row and Adam kernels.
    split = kernel_split(epoch, ("mlp_rows", "mlp_adam"))
    out = {"shape": name, "U": data.user_nums, "I": data.item_nums,
           "tw": k_state[0].shape[1], "layers": shapes, "B": b,
           "steps": steps, "real_rows": n_real, "tile_rows": lay["rows"],
           "blocks": lay["blocks"], "bytes": moved, "flops": flops,
           "errors": errors, "loss_rel_err": loss_rel,
           "ms": time_ms(epoch), "device_ms": sum(split.values()),
           "device_split": split,
           "plain_ms": time_ms(lambda: train_ops.fused_mlp_epoch_ref(
               *r_state, *ids, *cols, state.count,
               row_loss=spec["row_loss"], lr=cfg.lr), iters=3),
           **bound(moved, flops), "library_ms": None}
    profiles[f"E_{name}_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    return out


def mlp_row(launches, profiles):
    """The mlp_epoch row: NeuMF's shape first (the main one), MLP's."""
    timings = [mlp_timing(name, profiles) for name in ("NeuMF", "MLP")]
    main = timings[0]
    return {"name": "mlp_epoch", "route": "cuda",
            "source": "cleverrec_tpu_torch/csrc/mlp_epoch.cu",
            "replaces": "cleverrec_tpu/ops/pallas_train.py:631",
            "launches": launches,
            "max_abs_err": max(max(t["errors"].values()) for t in timings),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "timings": timings}


def rows_timing(name, profiles):
    """rows_epoch against its plain version at ``name``'s main shape on
    the state one epoch in and the next draw: errors, times, bound."""
    cfg, data, model, trainer, params, state, tensors = one_epoch_in(name)
    spec = model.fused_rows_spec()
    names = [n for n, _ in spec["planes"]]
    planes = sentinel_ids(data, tensors, names)
    floats = [tensors[n].to(torch.float32).contiguous()
              for n in spec["floats"]]
    opts = {"sides": [sd for _, sd in spec["planes"]], "lr": cfg.lr}

    def packed():
        return [tuple(x.clone() for x in group)
                for t in (params, state.mu, state.nu)
                for group in spec["pack"](t)]

    got, want = packed(), packed()
    loss = train_ops.fused_rows_epoch(*got, planes, floats, state.count,
                                      spec=spec, **opts)
    ref = train_ops.fused_rows_epoch_ref(*want, planes, floats, state.count,
                                         row_loss=spec["row_loss"], **opts)
    torch.cuda.synchronize()
    labels = [f"{part}{n}" for part in ("", "m_", "v_")
              for n in ("P", "Q", "bias") + spec["dense"]]
    errors = hold(f"rows_epoch {name}",
                  zip(labels, (x for g in got for x in g),
                      (x for g in want for x in g)), EPOCH_ATOL, EPOCH_RTOL)
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL,
          f"rows_epoch {name} loss: rel error {loss_rel}")
    k_state, r_state = packed(), packed()
    steps, b = planes[0].shape
    u_n, i_n, d = data.user_nums, data.item_nums, model.embed_size
    items = len(planes) - 1
    n_real = int((tensors["w"] != 0).sum())
    n_state = (u_n + i_n) * d + i_n + len(spec["dense"])
    # Each input read once and each output written once: the params and
    # both moments in and out, the id planes and float columns, the loss.
    moved = 4 * (6 * n_state + (len(planes) + len(floats)) * steps * b
                 + steps)
    # FP32 operations per real row and element of d: |P[u]|^2 (2), each
    # item's dot and |Q|^2 (4 L), P's grad (1 + 2 L), each item's grad
    # (3 L) and the scatter-adds (L + 1); and 14 per element of P, Q,
    # bias and s per step for Adam.  The O(L) terms of a row (biases,
    # links, loss) are left out, so the bound is below the work.
    flops = (10 * items + 4) * d * n_real + 14 * n_state * steps
    plan = train_ops.rows_epoch_plan(spec, b,
                                     scores._sms(k_state[0][0].device.index))

    def epoch():
        return train_ops.fused_rows_epoch(*k_state, planes, floats,
                                          state.count, spec=spec, **opts)
    # The kernel's own device time in one epoch: its row and Adam kernels.
    split = kernel_split(epoch, ("rows_chain", "adam_slices"))
    out = {"shape": name, "U": u_n, "I": i_n, "d": d, "items": items,
           "B": b, "steps": steps, "real_rows": n_real, "bytes": moved,
           "flops": flops, "errors": errors, "loss_rel_err": loss_rel,
           "variant": "float4" if train_ops.rows_vec(
               k_state[0] + k_state[1][:1]) else "scalar",
           "block_rows": plan["rows"], "blocks": plan["blocks"],
           "ms": time_ms(epoch), "device_ms": sum(split.values()),
           "device_split": split,
           "plain_ms": time_ms(lambda: train_ops.fused_rows_epoch_ref(
               *r_state, planes, floats, state.count,
               row_loss=spec["row_loss"], **opts), iters=3),
           **bound(moved, flops), "library_ms": None}
    profiles[f"F_{name}_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    return out


def rows_row(launches, profiles):
    """The rows_epoch row: SBPR's shape first (the main one), TBPR's and
    CUNE_BPR's."""
    timings = [rows_timing(name, profiles) for name in SOCIAL]
    main = timings[0]
    return {"name": "rows_epoch", "route": "cuda",
            "source": "cleverrec_tpu_torch/csrc/rows_epoch.cu",
            "replaces": "cleverrec_tpu/ops/pallas_train.py:847",
            "also_replaces": "cleverrec_tpu/ops/pallas_train.py:1153",
            "launches": launches,
            "max_abs_err": max(max(t["errors"].values()) for t in timings),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "timings": timings}


def counting_hinge(spec, margin):
    """LRML's row_loss, counting as it goes the real rows whose hinge is
    active (dist_i - dist_j + margin > 0) and the real rows: (the
    wrapped row_loss, [active, real])."""
    from cleverrec_tpu_torch.models.metric import LRML
    counts = [0, 0]

    def row_loss(rows, floats, dense, w):
        ue, ie, je = rows
        z = (LRML._dist(ue, ie, *dense) - LRML._dist(ue, je, *dense)
             + margin)
        real = w[:, 0] > 0
        counts[0] += int((real & (z > 0)).sum())
        counts[1] += int(real.sum())
        return spec["row_loss"](rows, floats, dense, w)
    return row_loss, counts


def distance_trap():
    """CML trained TRAP_EPOCHS epochs on a random split: its full_fused
    eval (dot_scores on the negated decomposition) equals its full eval,
    and fused retrieval gives the dense retrieval's answers (scores up to
    each user's |u|^2, which the fused path leaves out)."""
    from cleverrec_tpu_torch.common import clip_rows_by_norm
    cfg = config("ml-100k", recommender="CML",
                 **{"test.neg_samples": "0", "data.split_way": "rs"})
    data = load_ranking_data(cfg)
    dd = build_device_data(data)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    trainer = Trainer(model, data, cfg)
    params, state = trainer.init_state()
    trainer.train_epochs(params, state, TRAP_EPOCHS)
    fused_ev = Evaluator(model, dd, cfg)
    full_ev = Evaluator(model, dd, cfg.with_overrides(
        **{"eval.fused_kernel": "False"}))
    check((fused_ev.mode, full_ev.mode) == ("full_fused", "full"),
          f"G trap: eval modes {fused_ev.mode}, {full_ev.mode}")
    before = scores.launches["dot_scores"]
    got, _ = evaluate("G full_fused", fused_ev)
    want, _ = evaluate("G full", full_ev)
    check(scores.launches["dot_scores"] > before,
          "G trap: full_fused eval never launched dot_scores")
    for k in cfg.topk:
        check(bool(np.allclose(got[k], want[k], atol=METRIC_TOL, rtol=0)),
              f"G trap @{k}: full_fused {got[k]} vs full {want[k]}")
    fused = build_retrieval_fn(model, {}, dd, k=10, backend="fused")
    dense = build_retrieval_fn(model, {}, dd, k=10, backend="dense")
    with torch.no_grad():
        offset = (clip_rows_by_norm(model.P) ** 2).sum(dim=1).cpu().numpy()
    rng = np.random.default_rng(3)
    swaps = 0
    for _ in range(4):
        u = np.sort(rng.choice(dd.user_nums, 256, replace=False))
        swaps += check_answer("G trap", fused(u), dense(u), dd.seen.bits[u],
                              10, dd.item_nums, offset=offset[u])
    return {"full_fused": got, "full": want, "tied_id_swaps": swaps}


def phase_g(profiles):
    """The metric-learning family at its confs' widths and epoch counts
    (CML and LRML fused, TransCF scan); then CML and LRML 3 epochs
    through both tiers on identical draws; then the distance-model
    trap."""
    runs, tiers = {}, {}
    for name in METRIC:
        epochs, kernel = METRIC_EPOCHS[name], METRIC_KERNEL[name]
        res = runs[name] = drive_cli(f"G_{name}", model=name, epochs=epochs)
        want = {kernel: epochs} if kernel else {}
        got = {k: n for k, n in res["launches"].items() if n}
        got.pop("dot_scores", None)                 # no full-catalog eval
        check(got == want, f"G {name}: launches {res['launches']}")
        check(res["loss_last"] < res["loss_first"],
              f"G {name}: loss {res['loss_first']} -> {res['loss_last']}")
        floor = JAX_METRIC_HR10[name] - JAX_BAND
        check(res["best"]["HR@10"] >= floor,
              f"G {name}: best HR@10 {res['best']['HR@10']} < {floor}")
        if kernel is None:
            continue
        pair = {"fused": drive_cli(f"G_{name}_fused", model=name,
                                   epochs=TIER_EPOCHS),
                "scan": drive_cli(f"G_{name}_scan", model=name,
                                  epochs=TIER_EPOCHS,
                                  **{"train.fused_kernel": "False"})}
        check(pair["fused"]["launches"][kernel] == TIER_EPOCHS
              and sum(pair["scan"]["launches"].values()) == 0,
              f"G {name}: tier launches {pair['fused']['launches']}, "
              f"{pair['scan']['launches']}")
        for key, band in TIER_BAND.items():
            a, b = pair["fused"]["best"][key], pair["scan"]["best"][key]
            check(abs(a - b) <= band, f"G {name}: {key} fused {a} vs scan {b}")
        tiers[name] = pair
    trap = distance_trap()
    print("phase G trap: " + json.dumps(trap), flush=True)
    cfg = config("ml-100k", recommender="TransCF")
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    trainer = Trainer(model, data, cfg)
    params, state = trainer.init_state()
    trainer.train_epoch(params, state)
    profiles["G_TransCF_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    launches = {k: runs[name]["launches"][k] for name, k in
                METRIC_KERNEL.items() if k}
    return {"runs": runs, "tiers": tiers, "trap": trap,
            "launches": launches}


SAVED = os.path.join(ROOT, "build", "saved")


def epoch_kernels(res):
    """The epoch kernels a run launched, with their counts."""
    return {k: n for k, n in res["launches"].items()
            if k in train_ops.launches and n}


def within(tag, a, b, band, keys=("HR@10", "NDCG@10")):
    for key in keys:
        check(abs(a[key] - b[key]) <= band,
              f"{tag}: {key} {a[key]} vs {b[key]} (band {band})")


def summary(res, ref=None):
    out = {k: res[k] for k in ("best", "loss_first", "loss_last",
                               "epoch_ms_median", "eval_ms_median",
                               "wall_s")}
    if ref is not None:
        out["reference"] = {k: ref[k] for k in ("best", "epoch_ms_median")}
    return out


def param_gap(a: str, b: str):
    """The largest gap between two checkpoints' parameters, or None when
    they hold different epochs."""
    ca, cb = load_checkpoint(a), load_checkpoint(b)
    if ca["epoch"] != cb["epoch"]:
        return None
    return max((ca["params"][k] - cb["params"][k]).abs().max().item()
               for k in ca["params"])


def phase_i(train, profiles):
    """SAMN on its conf (the grouped epoch, no epoch kernel), SAMN_single
    and the flat epoch; SBPR and TBPR on the per-step samplers through
    the rows kernel; the lazy row-Adam tier for SBPR and BPR; BPR saved
    and resumed, NeuMF warm-started from saved GMF and MLP runs, and
    --tune on a 2 x 1 grid."""
    t0 = time.perf_counter()
    out = {}
    samn = drive_cli("I_SAMN", model="SAMN", epochs=SAMN_EPOCHS)
    check(not epoch_kernels(samn), f"I SAMN: launches {samn['launches']}")
    check(samn["loss_last"] < samn["loss_first"],
          f"I SAMN: loss {samn['loss_first']} -> {samn['loss_last']}")
    floor = JAX_SAMN_HR10 - JAX_BAND
    check(samn["best"]["HR@10"] >= floor,
          f"I SAMN: best HR@10 {samn['best']['HR@10']} < {floor}")
    out["SAMN"] = {**summary(samn), "jax_hr10": JAX_SAMN_HR10}
    print("phase I SAMN: " + json.dumps(out["SAMN"]), flush=True)
    short = {}
    for tag, name, epochs, opts in (
            ("single", "SAMN_single", SAMN_SINGLE_EPOCHS, {}),
            ("grouped", "SAMN", GROUPED_FLAT_EPOCHS, {}),
            ("flat", "SAMN", GROUPED_FLAT_EPOCHS,
             {"train.grouped_pairs": "False"})):
        res = short[tag] = drive_cli(f"I_SAMN_{tag}", model=name,
                                     epochs=epochs, **opts)
        check(not epoch_kernels(res) and res["loss_last"] < res["loss_first"],
              f"I SAMN {tag}: launches {res['launches']}, loss "
              f"{res['loss_first']} -> {res['loss_last']}")
    print("phase I SAMN_short: " + json.dumps(
        {t: summary(r) for t, r in short.items()}), flush=True)
    # Grouped and flat epochs draw differently: JAX_BAND, not TIER_BAND.
    within("I SAMN grouped vs flat", short["grouped"]["best"],
           short["flat"]["best"], JAX_BAND)
    out["SAMN_short"] = {t: summary(r) for t, r in short.items()}

    steps = {}
    for name in ("SBPR", "TBPR"):
        res = drive_cli(f"I_{name}_steps", model=name, epochs=TIER_EPOCHS,
                        **{"train.sbpr_epoch_tensors": "False"})
        check(epoch_kernels(res) == {"rows_epoch": TIER_EPOCHS},
              f"I {name} per-step: launches {res['launches']}")
        ref = train["F"]["tiers"][name]["fused"]
        within(f"I {name} per-step vs epoch tensors", res["best"],
               ref["best"], JAX_BAND)
        steps[name] = summary(res, ref)
    out["per_step"] = steps
    print("phase I per_step: " + json.dumps(steps), flush=True)

    lazy = {}
    refs = {"SBPR": train["F"]["tiers"]["SBPR"]["fused"],
            "BPR": drive_cli("I_BPR_fused", epochs=TIER_EPOCHS)}
    check(epoch_kernels(refs["BPR"]) == {"bpr_epoch": TIER_EPOCHS},
          f"I BPR fused: launches {refs['BPR']['launches']}")
    for name, ref in refs.items():
        res = drive_cli(f"I_{name}_lazy", model=name, epochs=TIER_EPOCHS,
                        **{"train.sparse_rows_force": "True"})
        check(not epoch_kernels(res), f"I {name} lazy: {res['launches']}")
        check(res["loss_last"] < res["loss_first"],
              f"I {name} lazy: loss {res['loss_first']} -> "
              f"{res['loss_last']}")
        # LazyAdam is not dense Adam: a metric-level band.
        within(f"I {name} lazy vs fused", res["best"], ref["best"], JAX_BAND,
               keys=("HR@10",))
        lazy[name] = summary(res, ref)
    out["lazy"] = lazy
    print("phase I lazy: " + json.dumps(lazy), flush=True)

    first_dir, whole_dir, resumed_dir, pre_dir = (
        os.path.join(SAVED, d) for d in ("first", "whole", "resumed", "pre"))
    for d in (first_dir, whole_dir, resumed_dir, pre_dir):
        shutil.rmtree(d, ignore_errors=True)
    first = drive_cli("I_BPR_first", epochs=CKPT_EPOCHS[0],
                      **{"save.best": "True", "saved_dir": first_dir})
    ckpt = os.path.join(first_dir, "BPR")
    done = load_checkpoint(ckpt)["epoch"]
    check(done == first["best_epoch"], f"I: saved epoch {done}, best "
          f"{first['best_epoch']}")
    resumed = drive_cli("I_BPR_resumed", epochs=CKPT_EPOCHS[1],
                        flags=("--resume", ckpt),
                        runs=CKPT_EPOCHS[1] - done,
                        **{"save.best": "True", "saved_dir": resumed_dir})
    whole = drive_cli("I_BPR_whole", epochs=CKPT_EPOCHS[1],
                      **{"save.best": "True", "saved_dir": whole_dir})
    check(epoch_kernels(resumed) == {"bpr_epoch": CKPT_EPOCHS[1] - done},
          f"I resumed: launches {resumed['launches']}")
    # The fused kernel's f32 atomics sum in a run-dependent order: the
    # resumed run is held to the whole one by TIER_BAND, not bit for bit.
    within("I resumed vs whole (last epoch)", resumed["last"],
           whole["last"], TIER_BAND["HR@10"], keys=("HR@10",))
    within("I resumed vs whole (last epoch)", resumed["last"],
           whole["last"], TIER_BAND["NDCG@10"], keys=("NDCG@10",))
    out["resume"] = {
        "saved_epoch": done, "resumed": summary(resumed),
        "whole": summary(whole), "last": {"resumed": resumed["last"],
                                          "whole": whole["last"]},
        "max_param_gap": param_gap(os.path.join(resumed_dir, "BPR"),
                                   os.path.join(whole_dir, "BPR"))}

    pre = {name: drive_cli(f"I_{name}_pre", model=name,
                           epochs=PRETRAIN_EPOCHS,
                           **{"save.best": "True", "saved_dir": pre_dir})
           for name in ("GMF", "MLP")}
    warm = drive_cli("I_NeuMF_warm", model="NeuMF", epochs=TIER_EPOCHS,
                     gmf_pretrain=os.path.join(pre_dir, "GMF"),
                     mlp_pretrain=os.path.join(pre_dir, "MLP"))
    cold = train["E"]["tiers"]["NeuMF"]["fused"]
    check(epoch_kernels(warm) == {"mlp_epoch": TIER_EPOCHS},
          f"I NeuMF warm: launches {warm['launches']}")
    check(warm["losses"][0] < cold["losses"][0],
          f"I NeuMF warm: first loss {warm['losses'][0]} not below the cold "
          f"start's {cold['losses'][0]}")
    out["warm_start"] = {"pretrain": {n: summary(r) for n, r in pre.items()},
                         "warm": summary(warm), "cold": summary(cold)}

    tune = drive_cli("I_tune", epochs=2, flags=("--tune",), trials=2,
                     embed_size="[64,128]")
    check(epoch_kernels(tune) == {"bpr_epoch": 4},
          f"I tune: launches {tune['launches']}")
    out["tune"] = {"ndcg_by_trial": tune["bests"], "wall_s": tune["wall_s"]}

    cfg = config("ml-100k", recommender="SAMN")
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    trainer = Trainer(model, data, cfg)
    params, state = trainer.init_state()
    trainer.train_epoch(params, state)
    profiles["I_SAMN_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    profiles["I_SAMN_eval"] = breakdown(trainer.evaluate)
    out["seconds"] = time.perf_counter() - t0
    return out


def gate(tag, res, ref):
    """The run's best HR@10 at least the JAX package's ``ref`` less
    ``JAX_BAND``."""
    floor = ref - JAX_BAND
    check(res["best"]["HR@10"] >= floor,
          f"{tag}: best HR@10 {res['best']['HR@10']} < {floor}")


def split_ranking(tag, name, ckpt, rng, gen, profiles):
    """``name``'s trained parameters (the checkpoint ``ckpt``) on a random
    split with the full-catalog eval: ``full_fused`` against ``full``,
    and 4 x 256 users at k=10 through ``auto`` (which must pick
    ``fused``) against ``dense``.  Returns the numbers and dot_scores'
    inputs at the first call's users: the decomposition's user rows and
    item table (for the graph models a row slice of the propagated
    matrix) and the seen bitmaps."""
    cfg = config("ml-100k", recommender=name,
                 **{"test.neg_samples": "0", "data.split_way": "rs"})
    data = load_ranking_data(cfg)
    dd = build_device_data(data)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    copy_into({k: p.detach() for k, p in model.named_parameters()},
              load_params(ckpt), "parameter")
    aux = {k: torch.as_tensor(v, device="cuda")
           for k, v in model.build_aux(dd, data).items()}
    fused_ev = Evaluator(model, dd, cfg)
    full_ev = Evaluator(model, dd, cfg.with_overrides(
        **{"eval.fused_kernel": "False"}))
    check((fused_ev.mode, full_ev.mode) == ("full_fused", "full"),
          f"{tag} eval modes {fused_ev.mode}, {full_ev.mode}")
    out = {}
    got, out["eval_full_fused_s"] = evaluate(f"{tag} full_fused", fused_ev,
                                             aux)
    want, out["eval_full_s"] = evaluate(f"{tag} full", full_ev, aux)
    for k in cfg.topk:
        check(bool(np.allclose(got[k], want[k], atol=METRIC_TOL, rtol=0)),
              f"{tag} @{k}: full_fused {got[k]} vs full {want[k]}")
    offset = None
    if model.cml_like:
        with torch.no_grad():
            offset = (model.P ** 2).sum(dim=1).cpu().numpy()
    calls, times, _ = serve(tag, model, dd, 10, 256, "auto", "fused", rng,
                            profiles, aux=aux, offset=offset)
    out.update(times)
    out["metrics"] = {"full_fused": got, "full": want}
    with torch.no_grad():
        uv, table, _ = model.dot_decomposition(
            torch.as_tensor(calls[0], device="cuda").long(), aux)
    if hasattr(model, "_propagate"):
        check(table.storage_offset() == data.user_nums * table.shape[1],
              f"{tag}: the item table is not the propagated matrix's item "
              "rows")
    bits = torch.as_tensor(seen_bits(dd, calls[0]), device="cuda")
    bias = torch.randn(table.shape[0], generator=gen).cuda()
    return out, (uv.contiguous(), table, bits, bias)


def phase_j(rng, gen, profiles):
    """FISM, LightGCN and NGCF on their confs (the scan tier, no epoch
    kernel); NAIS warm-started from the FISM run and cold, NAIS_single,
    NAIS on the flat tier, one NAIS epoch profiled; LightGCN's dense
    against its edge-list path; LightGCN's fused eval and serving (kernel
    ``dot_scores``).  Returns the numbers and dot_scores' inputs at
    phase J's serving shape."""
    t0 = time.perf_counter()
    saved = os.path.join(SAVED, "J")
    shutil.rmtree(saved, ignore_errors=True)
    runs = {}
    for name, epochs in ITEM_GRAPH_EPOCHS.items():
        res = runs[name] = drive_cli(f"J_{name}", model=name, epochs=epochs,
                                     **{"save.best": "True",
                                        "saved_dir": saved})
        check(res["loss_last"] < res["loss_first"],
              f"J {name}: loss {res['loss_first']} -> {res['loss_last']}")
        gate(f"J {name}", res, JAX_ITEM_GRAPH_HR10[name])
    runs["NAIS_warm"] = drive_cli(
        "J_NAIS_warm", model="NAIS", epochs=NAIS_EPOCHS,
        fism_pretrain=os.path.join(saved, "FISM"))
    runs["NAIS_cold"] = drive_cli("J_NAIS_cold", model="NAIS",
                                  epochs=NAIS_EPOCHS)
    warm, cold = runs["NAIS_warm"], runs["NAIS_cold"]
    check(warm["buckets"] is not None and cold["buckets"] == warm["buckets"],
          f"J NAIS: bucket plans {warm['buckets']}, {cold['buckets']}")
    # The warm start takes effect, the way it does in the JAX package:
    # FISM's tables, trained for its |I_u|^-alpha-scaled mean, put NAIS's
    # (sum e)^-beta-scaled logits far from 0, so the warm first epoch's
    # loss is the higher (JAX_NAIS_FIRST_LOSS).
    check(warm["losses"][0] > WARM_GAP * cold["losses"][0],
          f"J NAIS warm: first loss {warm['losses'][0]} not above "
          f"{WARM_GAP} x the cold start's {cold['losses'][0]}")
    for tag in ("NAIS_warm", "NAIS_cold"):
        gate(f"J {tag}", runs[tag], JAX_ITEM_GRAPH_HR10[tag])
    runs["NAIS_single"] = drive_cli("J_NAIS_single", model="NAIS_single",
                                    epochs=NAIS_SHORT_EPOCHS)
    runs["NAIS_flat"] = flat = drive_cli(
        "J_NAIS_flat", model="NAIS", epochs=NAIS_SHORT_EPOCHS,
        **{"train.bucketed_histories": "False"})
    check(flat["buckets"] is None and flat["loss_last"] < flat["loss_first"],
          f"J NAIS flat: buckets {flat['buckets']}, loss "
          f"{flat['loss_first']} -> {flat['loss_last']}")
    runs["LightGCN_dense"] = drive_cli("J_LightGCN_dense", model="LightGCN",
                                       epochs=EDGE_EPOCHS)
    runs["LightGCN_edge"] = drive_cli(
        "J_LightGCN_edge", model="LightGCN", epochs=EDGE_EPOCHS,
        **{"graph.dense_budget_mb": "0"})
    for key, band in TIER_BAND.items():
        within("J LightGCN edge vs dense", runs["LightGCN_edge"]["best"],
               runs["LightGCN_dense"]["best"], band, keys=(key,))
    for tag, res in runs.items():
        check(not epoch_kernels(res), f"J {tag}: launches {res['launches']}")

    parts = {"runs": time.perf_counter() - t0}
    scores.reset_launches()
    ranked, inputs = split_ranking("J", "LightGCN",
                                   os.path.join(saved, "LightGCN"), rng,
                                   gen, profiles)
    ranked["launches"] = {"dot_scores": scores.launches["dot_scores"]}
    check(ranked["launches"]["dot_scores"] > 0,
          "phase J never launched dot_scores")
    parts["ranking"] = time.perf_counter() - t0 - parts["runs"]
    # The warm start as the CLI's run took it: NAIS's P, Q and bias are
    # the FISM save's P, Q and b, bit for bit; then that NAIS's epoch is
    # profiled.
    fism = os.path.join(saved, "FISM")
    cfg = config("ml-100k", recommender="NAIS", fism_pretrain=fism)
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    trainer = Trainer(model, data, cfg)
    params, state = trainer.init_state()
    fism_params = load_params(fism)
    for mine, theirs in (("P", "P"), ("Q", "Q"), ("bias", "b")):
        check(torch.equal(params[mine].detach().cpu(), fism_params[theirs]),
              f"J NAIS warm start: {mine} is not FISM's {theirs}")
    prof = profiles["J_NAIS_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    del trainer, model, params, state
    parts["profile"] = (time.perf_counter() - t0 - parts["runs"]
                        - parts["ranking"])
    out = {tag: {**summary(res), "loss_first": res["losses"][0],
                 "jax_hr10": JAX_ITEM_GRAPH_HR10.get(tag),
                 "buckets": res["buckets"]}
           for tag, res in runs.items()}
    # The device's share of the profiled epoch, and of the cold run's
    # median epoch on the host clock (the profiler slows the host).
    out.update(ranking=ranked, launches=ranked.pop("launches"),
               nais_epoch_device_busy=prof["device_ms"] / prof["wall_ms"],
               nais_epoch_device_busy_unprofiled=(
                   prof["device_ms"] / cold["epoch_ms_median"]),
               nais_jax_first_loss=JAX_NAIS_FIRST_LOSS,
               seconds_by_part=parts, seconds=time.perf_counter() - t0)
    return out, inputs


def phase_k(rng, gen, profiles):
    """DiffNet, DiffNet++, LR_GCCF, WMF, DMF, SML and EATNN on their confs
    (the scan tier, no epoch kernel), each held to the JAX CLI; what
    ``auto`` serving picks for each; LR_GCCF's and SML's fused eval and
    serving (kernel ``dot_scores``).  Returns the numbers and dot_scores'
    inputs at LR_GCCF's first serving call (d 256)."""
    t0 = time.perf_counter()
    saved = os.path.join(SAVED, "K")
    shutil.rmtree(saved, ignore_errors=True)
    runs = {}
    for name, epochs in K_EPOCHS.items():
        res = runs[name] = drive_cli(f"K_{name}", model=name, epochs=epochs,
                                     **{"save.best": "True",
                                        "saved_dir": saved})
        check(res["loss_last"] < res["loss_first"],
              f"K {name}: loss {res['loss_first']} -> {res['loss_last']}")
        check(not epoch_kernels(res), f"K {name}: launches {res['launches']}")
        gate(f"K {name}", res, JAX_K_HR10[name])
    parts = {"runs": time.perf_counter() - t0}
    backends = {}
    for name, expect in K_BACKEND.items():
        cfg = config("ml-100k", recommender=name)
        data = load_ranking_data(cfg)
        dd = build_device_data(data)
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
        aux = {k: torch.as_tensor(v, device="cuda")
               for k, v in model.build_aux(dd, data).items()}
        fn = build_retrieval_fn(model, aux, dd, k=10, backend="auto")
        backends[name] = fn.backend
        check(fn.backend == expect, f"K {name}: auto picked {fn.backend}")
    scores.reset_launches()
    ranked, inputs = {}, None
    for name in K_RANKED:
        ranked[name], got = split_ranking(f"K_{name}", name,
                                          os.path.join(saved, name), rng,
                                          gen, profiles)
        inputs = inputs or got
    launches = {"dot_scores": scores.launches["dot_scores"]}
    check(launches["dot_scores"] > 0, "phase K never launched dot_scores")
    check(inputs[0].shape[1] == 4 * 64,
          f"K: LR_GCCF's decomposition width {inputs[0].shape[1]}")
    parts["ranking"] = time.perf_counter() - t0 - parts["runs"]
    out = {tag: {**summary(res), "epochs": K_EPOCHS[tag],
                 "jax_hr10": JAX_K_HR10[tag]}
           for tag, res in runs.items()}
    out.update(backends=backends, ranking=ranked, launches=launches,
               seconds_by_part=parts, seconds=time.perf_counter() - t0)
    return out, inputs


def phase_l(profiles):
    """RML_DGATs and SoHRML on their confs (the dual protocol on the scan
    tier, SoHRML's attention refreshed before each epoch; no epoch
    kernel), each held to the JAX CLI, ``auto`` serving picking ``dense``
    for both, one epoch of each profiled; BPR's conf with popularity
    negatives through the fused tier (kernel ``bpr_epoch``) and the scan
    tier, each held to the JAX CLI and to each other, and ``bpr_epoch``
    held to its plain version on a popularity draw."""
    t0 = time.perf_counter()
    runs = {}
    for name, epochs in L_EPOCHS.items():
        res = runs[name] = drive_cli(f"L_{name}", model=name, epochs=epochs)
        check(res["loss_last"] < res["loss_first"],
              f"L {name}: loss {res['loss_first']} -> {res['loss_last']}")
        check(not epoch_kernels(res), f"L {name}: launches {res['launches']}")
        gate(f"L {name}", res, JAX_L_HR10[name])
    fused = runs["BPR_pop_fused"] = drive_cli("L_BPR_pop_fused", **POP)
    scan = runs["BPR_pop_scan"] = drive_cli(
        "L_BPR_pop_scan", **POP, **{"train.fused_kernel": "False"})
    check(epoch_kernels(fused) == {"bpr_epoch": EPOCHS},
          f"L BPR popularity fused: launches {fused['launches']}")
    check(not epoch_kernels(scan),
          f"L BPR popularity scan: launches {scan['launches']}")
    for tag, res in (("fused", fused), ("scan", scan)):
        check(res["loss_last"] < res["loss_first"],
              f"L BPR popularity {tag}: loss {res['loss_first']} -> "
              f"{res['loss_last']}")
        gate(f"L BPR popularity {tag}", res, JAX_L_HR10["BPR_pop"])
    for key, band in TIER_BAND.items():
        within("L BPR popularity fused vs scan", fused["best"], scan["best"],
               band, keys=(key,))
    parts = {"runs": time.perf_counter() - t0}
    _, _, _, errors, loss_rel = bpr_hold(
        "L bpr_epoch popularity", one_epoch_in("BPR", **POP))
    backends, busy = {}, {}
    for name in L_EPOCHS:
        cfg = config("ml-100k", recommender=name)
        data = load_ranking_data(cfg)
        dd = build_device_data(data)
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
        trainer = Trainer(model, data, cfg)
        fn = build_retrieval_fn(model, trainer.aux, dd, k=10, backend="auto")
        backends[name] = fn.backend
        check(fn.backend == "dense", f"L {name}: auto picked {fn.backend}")
        params, state = trainer.init_state()
        prof = profiles[f"L_{name}_epoch"] = breakdown(
            lambda: trainer.train_epoch(params, state))
        # The device's share of the profiled epoch, and of the run's
        # median epoch on the host clock (the profiler slows the host).
        busy[name] = {"profiled": prof["device_ms"] / prof["wall_ms"],
                      "unprofiled": (prof["device_ms"]
                                     / runs[name]["epoch_ms_median"])}
        del trainer, model, params, state
    parts["checks"] = time.perf_counter() - t0 - parts["runs"]
    refs = {**JAX_L_HR10, "BPR_pop_fused": JAX_L_HR10["BPR_pop"],
            "BPR_pop_scan": JAX_L_HR10["BPR_pop"]}
    out = {tag: {**summary(res), "epochs": len(res["losses"]),
                 "epoch_first_ms": res["epoch_first_ms"],
                 "jax_hr10": refs[tag]}
           for tag, res in runs.items()}
    out.update(backends=backends, device_busy=busy,
               launches={"bpr_epoch": fused["launches"]["bpr_epoch"]},
               bpr_epoch_popularity_hold={"errors": errors,
                                          "loss_rel_err": loss_rel},
               seconds_by_part=parts, seconds=time.perf_counter() - t0)
    return out


def write_ml100k_libfm() -> str:
    """The repo's ml-100k libFM files in build/data/ml100k/, the layout
    ``<root>/<dataset>/<dataset>.{train,test}.libfm`` the rating loader
    reads, each replaced whole; returns the dataset's name."""
    path = os.path.join(DATA, LIBFM_DATASET)
    os.makedirs(path, exist_ok=True)
    for part in ("train", "test"):
        name = f"{LIBFM_DATASET}.{part}.libfm"
        tmp = os.path.join(path, f"{name}.{os.getpid()}.tmp")
        shutil.copy(os.path.join(ROOT, "benchmarks", "UIRT", name), tmp)
        os.replace(tmp, os.path.join(path, name))   # no reader sees half
    return LIBFM_DATASET


def drive_rating(tag, model, epochs=M_EPOCHS, flags=(), trials=1,
                 **overrides):
    """The port's CLI (``run_cli``) on a rating conf, on the repo's
    ml-100k libFM files: the epochs' training RMSE and loss, the tests'
    RMSE and MAE, the times, the best epoch(s) and the launches."""
    values = {"data.root_dir": DATA, "data.dataset": "ml100k",
              "log.dir": LOGS, "epoches": epochs}
    values.update(overrides)
    wall, records, launches = run_cli(tag, model, flags, values)
    check(len(records.train) == epochs * trials == len(records.eval)
          and len(records.bests) == trials,
          f"{tag}: {len(records.train)} epochs, {len(records.eval)} tests, "
          f"{len(records.bests)} runs")
    rmse = [r["rmse"] for r in records.train]
    test = [r["rmse"] for r in records.eval]
    check(all(np.isfinite(rmse + test)), f"{tag}: RMSE {rmse} {test}")
    train_ms = [r["seconds"] * 1e3 for r in records.train]
    return {"wall_s": wall, "launches": launches,
            "epoch_first_ms": train_ms[0],
            "epoch_ms_median": statistics.median(train_ms[1:] or train_ms),
            "eval_ms_median": statistics.median(
                [r["seconds"] * 1e3 for r in records.eval]),
            "train_rmse_first": rmse[0], "train_rmse_last": rmse[-1],
            "loss_first": records.train[0]["loss"],
            "loss_last": records.train[-1]["loss"],
            "best": records.best, "bests": records.bests}


def phase_m(profiles):
    """FM and FFM on their confs (30 epochs, embed 16 and 8, batch 4096) on
    the repo's ml-100k libFM files through the port's CLI on the card:
    the training RMSE falls, the best test RMSE is at most the JAX
    package's plus M_BAND, and no kernel launches (the rating path has
    none); ``--tune`` over embed_size [8, 16], 2 epochs a trial, names the
    trial of the lowest RMSE; one FM epoch profiled (the device's busy
    share)."""
    from cleverrec_tpu_torch.data.libfm import load_rating_data
    from cleverrec_tpu_torch.rating import FMTrainer, make_rating_model
    t0 = time.perf_counter()
    write_ml100k_libfm()
    runs = {}
    for name in JAX_M_RMSE:
        res = runs[name] = drive_rating(f"M_{name}", name)
        check(res["train_rmse_last"] < res["train_rmse_first"],
              f"M {name}: training RMSE {res['train_rmse_first']} -> "
              f"{res['train_rmse_last']}")
        check(res["best"]["rmse"] <= JAX_M_RMSE[name] + M_BAND,
              f"M {name}: best RMSE {res['best']['rmse']} against the JAX "
              f"package's {JAX_M_RMSE[name]} + {M_BAND}")
        check(not any(res["launches"].values()),
              f"M {name}: launches {res['launches']}")
    tune = drive_rating("M_FM_tune", "FM", epochs=M_TUNE_EPOCHS,
                        flags=("--tune",), trials=2, embed_size="[8,16]")
    with open(os.path.join(LOGS, "M_FM_tune.log")) as f:
        named = [ln for ln in f if "== best trial: " in ln]
    top = min(range(2), key=lambda t: tune["bests"][t]["rmse"])
    check(len(named) == 1 and f"'embed_size': {(8, 16)[top]}}}" in named[0],
          f"M tune: best trial {named}, bests {tune['bests']}")
    cfg = config("ml100k", recommender="FM")
    data = load_rating_data(cfg)
    trainer = FMTrainer(make_rating_model(cfg, data), data, cfg)
    params, state = trainer.init_state()
    prof = profiles["M_FM_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    out = {name: {"epoch_ms_median": res["epoch_ms_median"],
                  "epoch_first_ms": res["epoch_first_ms"],
                  "eval_ms_median": res["eval_ms_median"],
                  "best_rmse": res["best"]["rmse"],
                  "best_mae": res["best"]["mae"],
                  "best_epoch": res["best"]["epoch"],
                  "jax_rmse": JAX_M_RMSE[name], "jax_mae": JAX_M_MAE[name],
                  "train_rmse_first": res["train_rmse_first"],
                  "train_rmse_last": res["train_rmse_last"],
                  "wall_s": res["wall_s"]}
           for name, res in runs.items()}
    out.update(tune={"bests": tune["bests"], "best_trial": (8, 16)[top],
                     "wall_s": tune["wall_s"]},
               device_busy={"FM_profiled": prof["device_ms"]
                            / prof["wall_ms"],
                            "FM_unprofiled": prof["device_ms"]
                            / runs["FM"]["epoch_ms_median"]},
               seconds=time.perf_counter() - t0)
    return out


def hold_artifact(tag, served, live, calls, op):
    """A loaded retrieval program against the live ``retrieve`` on each
    call's users: ids and scores equal, one launch of kernel ``op`` a
    program call; the ms of a call of both."""
    for u in calls:
        before = scores.launches[op]
        got = served(u)
        torch.cuda.synchronize()
        check(scores.launches[op] == before + 1,
              f"{tag}: {scores.launches[op] - before} {op} launches a call")
        want = live(u)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{tag}: the program's answers differ from live retrieve's")
    u = calls[0]

    def per_call_ms(fn):
        return sync_s(lambda: [fn(u) for _ in range(10)])[1] * 100

    return {f"{tag}_program_ms": per_call_ms(served),
            f"{tag}_live_ms": per_call_ms(live),
            f"{tag}_program_{op}_launches": len(calls)}


def phase_n(rng, model_a, dd_a, calls_a, model_b, dd_b, calls_b):
    """Export: phase A's model as a serving bundle in a temporary
    directory, loaded back: its retrieval program (``auto`` -> ``fused``)
    held to live ``retrieve`` on phase A's calls, its rerank program to
    live ``rerank``; a ``fused`` retrieval program at phase B's catalog
    held the same way."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        manifest = export_bundle(model_a, None, dd_a, tmp,
                                 batch=len(calls_a[0]), n_cand=N_CAND, k=10)
        out["N_A_bundle_export_s"] = time.perf_counter() - t
        check(manifest["backend"] == "fused" and manifest["cuda_only"],
              f"N: bundle manifest {manifest}")
        blobs = {}
        for name, file in manifest["artifacts"].items():
            with open(os.path.join(tmp, file), "rb") as f:
                blobs[name] = f.read()
    t = time.perf_counter()
    served = {name: load_serialized(blob) for name, blob in blobs.items()}
    out["N_A_bundle_load_s"] = time.perf_counter() - t
    out.update({f"N_A_{name}_bytes": len(blob)
                for name, blob in blobs.items()})
    out.update(hold_artifact("N_A", served["retrieval"],
                             build_retrieval_fn(model_a, None, dd_a, k=10),
                             calls_a, "dot_scores"))
    live_rerank = build_rerank_fn(model_a, None, k=10)
    cands = []
    for u in calls_a:
        cand = rng.integers(0, dd_a.item_nums, (len(u), N_CAND))
        cand[:, -N_PAD:] = -1
        got, want = served["rerank"](u, cand), live_rerank(u, cand)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and bool((got[0] >= 0).all()),
              "N: the rerank program's answers differ from live rerank's")
        cands.append(cand)
    out["N_A_rerank_program_ms"] = sync_s(lambda: [
        served["rerank"](calls_a[0], cands[0]) for _ in range(10)])[1] * 100
    out["N_A_rerank_live_ms"] = sync_s(lambda: [
        live_rerank(calls_a[0], cands[0]) for _ in range(10)])[1] * 100

    t = time.perf_counter()
    blob = export_retrieval(model_b, None, dd_b, len(calls_b[0]), k=20,
                            backend="fused")
    out["N_B_export_s"] = time.perf_counter() - t
    t = time.perf_counter()
    served_b = load_serialized(blob)
    out.update(N_B_load_s=time.perf_counter() - t, N_B_bytes=len(blob))
    del blob
    out.update(hold_artifact("N_B", served_b, build_retrieval_fn(
        model_b, None, dd_b, k=20, backend="fused"), calls_b, "dot_gmax"))
    out["seconds"] = time.perf_counter() - t0
    return out


def classic_data(module):
    """ml-100k for ``module`` (the port's ``classic`` or the JAX
    package's): the rebuilt ratings' 99,999 pairs split 7:1 at random
    (seed 0) as ``module.InteractionData``; the libFM split's rating
    triples, train and test; phase F's trust graph as (truster, trustee)
    pairs (``write_ml100k`` and ``write_trusts`` first)."""
    train, test = libfm_rows("train"), libfm_rows("test")
    both = np.concatenate([train, test])
    n_users, n_items = (int(both[:, c].max()) + 1 for c in (0, 1))
    data = module.InteractionData.random_split(
        both[:, :2].astype(np.int64), n_users, n_items, test_size=0.125,
        rng=np.random.default_rng(0))
    trust = np.loadtxt(os.path.join(DATA, "ml-100k", "trusts.csv"),
                       delimiter=",", skiprows=1, dtype=np.int64)
    return data, (train, test), [tuple(e) for e in trust.tolist()]


def classic_figures(module, seed: int = 0, device=None) -> dict:
    """Each model of ``O_MODELS`` fitted from ``module`` on
    ``classic_data`` (with ``seed``, and on ``device`` where given):
    precision@10 of LFM and SLIM on the random split, test RMSE of the
    rating models on the libFM test triples, and each fit's seconds."""
    data, (train, test), trust = classic_data(module)
    out = {}
    for name, (metric, settings) in O_MODELS.items():
        kw = dict(settings)
        if name != "SLIM":                      # SLIM draws nothing
            kw["seed"] = seed
        if device is not None:
            kw["device"] = device
        model = getattr(module, name)(**kw)
        t = time.perf_counter()
        if metric == "precision@10":
            model.fit(data)
            fit_s = time.perf_counter() - t
            figure = module.evaluate_topn(model, data, n=10)["precision"]
        else:
            extra = {"trust_pairs": trust} if name == "TrustSVD" else {}
            model.fit(train, data.user_nums, data.item_nums, **extra)
            fit_s = time.perf_counter() - t
            pred = model.predict(test[:, 0].astype(np.int64),
                                 test[:, 1].astype(np.int64))
            figure = float(np.sqrt(np.mean((test[:, 2] - pred) ** 2)))
        out[name] = {metric: float(figure), "fit_s": fit_s}
    return out


def phase_o():
    """``classic/`` on the card: ``classic_figures`` on ``cuda``, each
    figure held to the JAX package's on the same files (precision@10 at
    least ``JAX_O`` less ``O_BAND``, RMSE at most ``JAX_O`` plus it);
    the classic path launches no kernel."""
    t0 = time.perf_counter()
    before = dict(scores.launches)
    figures = classic_figures(classic, device="cuda")
    check(scores.launches == before, f"O: launches {scores.launches}")
    for name, res in figures.items():
        metric = O_MODELS[name][0]
        got, ref, band = res[metric], JAX_O[name], O_BAND[name]
        check(np.isfinite(got) and (got >= ref - band
                                    if metric == "precision@10"
                                    else got <= ref + band),
              f"O {name}: {metric} {got} against the JAX package's {ref} "
              f"(band {band})")
        res["jax"] = ref
    return {**figures, "seconds": time.perf_counter() - t0}


def cml_row(launches, profiles):
    """cml_epoch against its plain version at CML's main shape (ml-100k,
    embed 128, K 20, B 6144) on the state one epoch in and the next draw:
    errors, times, bound."""
    cfg, data, model, trainer, params, state, tensors = one_epoch_in("CML")
    u, i = sentinel_ids(data, tensors, ("u", "i"))
    i_sent = train_ops.sentinel_dims(data.user_nums, data.item_nums)[1] - 1
    negs = torch.where(tensors["w"][..., None] == 0, i_sent,
                       tensors["negs"]).to(torch.int32).contiguous()
    names = ("P", "Q")
    base = [params[n].detach() for n in names] + [
        t[n] for n in names for t in (state.mu, state.nu)]
    opts = {"lr": cfg.lr, "reg": model.reg, "margin": model.margin,
            "item_nums": data.item_nums}
    got, want = [x.clone() for x in base], [x.clone() for x in base]
    loss = train_ops.fused_cml_epoch(*got, u, i, negs, state.count, **opts)
    ref = train_ops.fused_cml_epoch_ref(*want, u, i, negs, state.count,
                                        **opts)
    torch.cuda.synchronize()
    labels = ("P", "Q", "mP", "vP", "mQ", "vQ")
    errors = hold("cml_epoch", zip(labels, got, want), EPOCH_ATOL,
                  EPOCH_RTOL)
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL, f"cml_epoch loss: rel error {loss_rel}")
    k_state, r_state = [x.clone() for x in base], [x.clone() for x in base]
    steps, b, k = negs.shape
    u_n, i_n, d = data.user_nums, data.item_nums, model.embed_size
    n_real = int((tensors["w"] != 0).sum())
    n_state = (u_n + i_n) * d
    # Each input read once and each output written once: six state
    # tensors in and out, the u, i and K negative planes, the loss.
    moved = 4 * (12 * n_state + (2 + k) * steps * b + steps)
    # FP32 operations: (K + 1) distances of 3 d a real row (difference,
    # square, sum), and per state element per step 8 for the regulariser
    # (column sum, centring, row sum, squares, its gradient) and 14 for
    # Adam.  The hinge's row grads (9 d an active row) are left out, so
    # the bound is below the work.
    flops = (k + 1) * 3 * d * n_real + 22 * n_state * steps
    args = (*k_state, u, i, negs, state.count)

    def epoch():
        return train_ops.fused_cml_epoch(*args, **opts)
    row = {"name": "cml_epoch", "route": "cuda",
           "source": "cleverrec_tpu_torch/csrc/cml_epoch.cu",
           "replaces": "cleverrec_tpu/ops/pallas_train.py:1610",
           "launches": launches, "max_abs_err": max(errors.values()),
           "ms": time_ms(epoch),
           # The kernel's own device time in one epoch: one launch.
           **epoch_split("cml_epoch", args, opts, ("cml_persist",)),
           "variant": "float4" if train_ops.cml_width(*k_state) == 4
           else "scalar",
           "plain_ms": time_ms(lambda: train_ops.fused_cml_epoch_ref(
               *r_state, u, i, negs, state.count, **opts), iters=3),
           **bound(moved, flops),
           # No single PyTorch call trains an epoch.
           "library_ms": None,
           "errors": errors, "loss_rel_err": loss_rel,
           "shape": {"U": u_n, "I": i_n, "d": d, "K": k, "B": b,
                     "steps": steps, "real_rows": n_real, "bytes": moved,
                     "flops": flops}}
    profiles["G_CML_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    return row


def lrml_row(launches, profiles):
    """rows_epoch_lrml (LRML's form of the rows kernel) against the plain
    rows epoch at LRML's main shape (ml-100k, embed 128, mem 50, B 6144)
    on the state one epoch in and the next draw."""
    cfg, data, model, trainer, params, state, tensors = one_epoch_in("LRML")
    spec = model.fused_rows_spec()
    planes = sentinel_ids(data, tensors, [n for n, _ in spec["planes"]])
    opts = {"sides": [sd for _, sd in spec["planes"]], "lr": cfg.lr}

    def packed():
        return [tuple(x.clone() for x in group)
                for t in (params, state.mu, state.nu)
                for group in spec["pack"](t)]

    got, want = packed(), packed()
    loss = train_ops.fused_rows_epoch(*got, planes, [], state.count,
                                      spec=spec, **opts)
    counting, active = counting_hinge(spec, model.margin)
    ref = train_ops.fused_rows_epoch_ref(*want, planes, [], state.count,
                                         row_loss=counting, **opts)
    torch.cuda.synchronize()
    labels = [f"{part}{n}" for part in ("", "m_", "v_")
              for n in ("P", "Q", "K", "M")]
    errors = hold("rows_epoch_lrml", zip(labels, (x for g in got for x in g),
                                         (x for g in want for x in g)),
                  EPOCH_ATOL, EPOCH_RTOL)
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL,
          f"rows_epoch_lrml loss: rel error {loss_rel}")
    k_state, r_state = packed(), packed()
    steps, b = planes[0].shape
    u_n, i_n, d, mem = (data.user_nums, data.item_nums, model.embed_size,
                        model.mem_size)
    n_real = int((tensors["w"] != 0).sum())
    n_state = (u_n + i_n) * d + 2 * d * mem
    # Each input read once and each output written once: P, Q, K, M and
    # their moments in and out, the u, i, j planes, the loss.
    moved = 4 * (6 * n_state + 3 * steps * b + steps)
    # FP32 operations of the forward every real row needs, for each of
    # its two items: the logits and r (4 d mem), a, e and |e|^2 (5 d);
    # the L2 norms (6 d); and 14 per state element per step for Adam.  The
    # backward of the rows whose hinge is active (~12 d mem more) is left
    # out, so the bound is below the work.
    flops = (8 * d * mem + 16 * d) * n_real + 14 * n_state * steps
    plan = train_ops.rows_epoch_plan(spec, b,
                                     scores._sms(k_state[0][0].device.index))

    def epoch():
        return train_ops.fused_rows_epoch(*k_state, planes, [], state.count,
                                          spec=spec, **opts)
    # The kernel's own device time in one epoch: its tile and Adam kernels.
    split = kernel_split(epoch, ("lrml_tiles", "adam_slices"))
    row = {"name": "rows_epoch_lrml", "route": "cuda",
           "source": "cleverrec_tpu_torch/csrc/rows_epoch.cu",
           "replaces": "cleverrec_tpu/ops/pallas_train.py:847",
           "also_replaces": "cleverrec_tpu/ops/pallas_train.py:1153",
           "launches": launches, "max_abs_err": max(errors.values()),
           "ms": time_ms(epoch), "device_ms": sum(split.values()),
           "device_split": split,
           "plain_ms": time_ms(lambda: train_ops.fused_rows_epoch_ref(
               *r_state, planes, [], state.count,
               row_loss=spec["row_loss"], **opts), iters=3),
           **bound(moved, flops), "library_ms": None,
           "errors": errors, "loss_rel_err": loss_rel,
           "active_share": active[0] / active[1],
           "shape": {"U": u_n, "I": i_n, "d": d, "mem": mem, "B": b,
                     "steps": steps, "real_rows": n_real, "bytes": moved,
                     "flops": flops,
                     "variant": "float4" if train_ops.rows_vec(
                         k_state[0] + k_state[1] + k_state[2])
                     else "scalar",
                     **{k: plan[k] for k in ("rows", "tiles", "blocks",
                                             "mem_pad", "smem_bytes")}}}
    profiles["G_LRML_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    return row


def bpr_hold(tag, run):
    """bpr_epoch against its plain version on ``one_epoch_in``'s state and
    draw (``run``): every table and moment after the epoch, and its loss.
    Returns the ids, the state, the options, the errors and the loss's
    relative error."""
    cfg, data, model, _, params, state, tensors = run
    ids = sentinel_ids(data, tensors, ("u", "i", "j"))
    names = ("P", "Q", "mP", "vP", "mQ", "vQ")
    base = (params["P"].detach(), params["Q"].detach(), state.mu["P"],
            state.nu["P"], state.mu["Q"], state.nu["Q"])
    opts = {"lr": cfg.lr, "reg": model.reg}
    got, want = [x.clone() for x in base], [x.clone() for x in base]
    loss = train_ops.fused_bpr_epoch(*got, *ids, state.count, **opts)
    ref = train_ops.fused_bpr_epoch_ref(*want, *ids, state.count, **opts)
    torch.cuda.synchronize()
    errors = hold(tag, zip(names, got, want), EPOCH_ATOL, EPOCH_RTOL)
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL, f"{tag} loss: rel error {loss_rel}")
    return ids, base, opts, errors, loss_rel


def epoch_row(launches, profiles):
    """bpr_epoch against its plain version on one state and one sampled
    epoch at the main shape (ml-100k, embed 128, B 6144): the state after
    one trained epoch, the next epoch's draw.  Times both and the card's
    least time for the same work."""
    run = one_epoch_in("BPR")
    cfg, data, model, trainer, params, state, tensors = run
    ids, base, opts, errors, loss_rel = bpr_hold("bpr_epoch", run)

    k_state, r_state = [x.clone() for x in base], [x.clone() for x in base]
    steps, b = ids[0].shape
    u_n, i_n, d = data.user_nums, data.item_nums, model.embed_size
    n_real = int((tensors["w"] != 0).sum())
    # Each input read once and each output written once: six state
    # tables in and out, the three id planes, the per-step loss.
    moved = 4 * (12 * (u_n + i_n) * d + 3 * steps * b + steps)
    # FP32 operations: 21 d per real slot (qi - qj, the dot, three
    # squared norms, three row grads, three scatter-adds) and 14 per
    # element of P and Q per step for Adam.
    flops = 21 * d * n_real + 14 * (u_n + i_n) * d * steps
    args = (*k_state, *ids, state.count)

    def epoch():
        return train_ops.fused_bpr_epoch(*args, **opts)
    vec = train_ops.rows_vec(k_state)
    plan = train_ops.bpr_epoch_plan(
        u_n, i_n, d, steps,
        torch.cuda.get_device_properties(0).multi_processor_count,
        *train_ops._persist_blocks(build.load("bpr_epoch"), "bpr_epoch",
                                   k_state[0].device, d, int(vec)))
    row = {"name": "bpr_epoch", "route": "cuda",
           "source": "cleverrec_tpu_torch/csrc/bpr_epoch.cu",
           "replaces": "cleverrec_tpu/ops/pallas_train.py:276",
           "launches": launches, "max_abs_err": max(errors.values()),
           "ms": time_ms(epoch),
           # The kernel's own device time in one epoch: one launch.
           **epoch_split("bpr_epoch", args, opts, ("bpr_persist",)),
           "plain_ms": time_ms(lambda: train_ops.fused_bpr_epoch_ref(
               *r_state, *ids, state.count, **opts), iters=5),
           **bound(moved, flops),
           # No single PyTorch call trains an epoch.
           "library_ms": None,
           "errors": errors, "loss_rel_err": loss_rel,
           "shape": {"U": u_n, "I": i_n, "d": d, "B": b, "steps": steps,
                     "real_slots": n_real, "bytes": moved, "flops": flops,
                     "blocks": plan["blocks"], "threads": plan["threads"],
                     "pieces": "float4" if vec else "scalar"}}
    profiles["C_epoch"] = breakdown(
        lambda: trainer.train_epoch(params, state))
    return row


# -- phase P: the trainer's capacity tiers --------------------------------

def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def bf16_hold(tag, pairs):
    """Each (name, got, want) of bf16 storage: got equals its own bf16
    rounding, and all but a share BF16_OUTLIERS of its elements lie
    within one bf16 ulp of want's.  Returns each one's largest error and
    its share of elements that differ at all and by more than an ulp."""
    out = {}
    for name, g, w in pairs:
        check(bool(torch.isfinite(g).all()), f"{tag} {name}: non-finite")
        check(torch.equal(g, g.to(torch.bfloat16).float()),
              f"{tag} {name}: a value that bf16 does not hold")
        err = (g - w).abs()
        far = err > bf16_ulp(torch.maximum(g.abs(), w.abs()))
        out[name] = {"max_abs": err.max().item(),
                     "differ": (g != w).float().mean().item(),
                     "past_one_ulp": far.float().mean().item()}
        check(out[name]["past_one_ulp"] <= BF16_OUTLIERS,
              f"{tag} {name}: {out[name]['past_one_ulp']} of the elements "
              "past one bf16 ulp")
    return out


def bpr_bf16_row(launches):
    """bpr_epoch with bf16 storage against its plain version at phase C's
    shape, on the state one bf16 epoch in and the next draw."""
    run = one_epoch_in("BPR", **{"train.fused_bf16": "True"})
    cfg, data, model, trainer, params, state, tensors = run
    check(trainer.table_dtype == torch.bfloat16,
          "P: BPR's trainer does not store bf16")
    ids = sentinel_ids(data, tensors, ("u", "i", "j"))
    names = ("P", "Q", "mP", "vP", "mQ", "vQ")
    base = (params["P"].detach(), params["Q"].detach(), state.mu["P"],
            state.nu["P"], state.mu["Q"], state.nu["Q"])
    opts = {"lr": cfg.lr, "reg": model.reg, "table_dtype": torch.bfloat16}
    got, want = [x.clone() for x in base], [x.clone() for x in base]
    held = [x[:BF16_HELD_STEPS] for x in ids]
    loss = train_ops.fused_bpr_epoch(*got, *held, state.count, **opts)
    ref = train_ops.fused_bpr_epoch_ref(*want, *held, state.count, **opts)
    torch.cuda.synchronize()
    errors = bf16_hold("bpr_epoch_bf16", zip(names, got, want))
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL, f"bpr_epoch_bf16 loss: rel {loss_rel}")
    k_state, r_state = [x.clone() for x in base], [x.clone() for x in base]
    steps, b = ids[0].shape
    u_n, i_n, d = data.user_nums, data.item_nums, model.embed_size
    n_real = int((tensors["w"] != 0).sum())
    # bf16 storage halves the state's bytes: six state tables in and out
    # at 2 bytes an element; the three id planes and the loss at 4.
    moved = 2 * 12 * (u_n + i_n) * d + 4 * (3 * steps * b + steps)
    flops = 21 * d * n_real + 14 * (u_n + i_n) * d * steps
    args = (*k_state, *ids, state.count)
    return {"name": "bpr_epoch_bf16", "route": "cuda",
            "source": "cleverrec_tpu_torch/csrc/bpr_epoch.cu",
            "replaces": "cleverrec_tpu/ops/pallas_train.py:276",
            "variant_of": "bpr_epoch (table_dtype=bfloat16)",
            "storage": "bf16 values in f32 buffers",
            "launches": launches,
            "max_abs_err": max(e["max_abs"] for e in errors.values()),
            "ms": time_ms(lambda: train_ops.fused_bpr_epoch(*args, **opts)),
            **epoch_split("bpr_epoch", args, opts, ("bpr_persist",)),
            "plain_ms": time_ms(lambda: train_ops.fused_bpr_epoch_ref(
                *r_state, *ids, state.count, **opts), iters=5),
            **bound(moved, flops), "library_ms": None,
            "errors": errors, "loss_rel_err": loss_rel,
            "held_steps": BF16_HELD_STEPS,
            "shape": {"U": u_n, "I": i_n, "d": d, "B": b, "steps": steps,
                      "real_slots": n_real, "bytes": moved, "flops": flops}}


def rows_bf16_row(name, kernel, launches):
    """rows_epoch (``kernel``: the chain's or LRML's form) with bf16
    storage against its plain version at ``name``'s main shape, on the
    state one bf16 epoch in and the next draw."""
    cfg, data, model, trainer, params, state, tensors = one_epoch_in(
        name, **{"train.fused_bf16": "True"})
    check(trainer.table_dtype == torch.bfloat16,
          f"P: {name}'s trainer does not store bf16")
    spec = model.fused_rows_spec()
    planes = sentinel_ids(data, tensors, [n for n, _ in spec["planes"]])
    floats = [tensors[n].to(torch.float32).contiguous()
              for n in spec["floats"]]
    opts = {"sides": [sd for _, sd in spec["planes"]], "lr": cfg.lr,
            "table_dtype": torch.bfloat16}

    def packed():
        return [tuple(x.clone() for x in group)
                for t in (params, state.mu, state.nu)
                for group in spec["pack"](t)]

    got, want = packed(), packed()
    held = [x[:BF16_HELD_STEPS] for x in planes]
    held_f = [x[:BF16_HELD_STEPS] for x in floats]
    loss = train_ops.fused_rows_epoch(*got, held, held_f, state.count,
                                      spec=spec, **opts)
    ref = train_ops.fused_rows_epoch_ref(*want, held, held_f, state.count,
                                         row_loss=spec["row_loss"], **opts)
    torch.cuda.synchronize()
    parts = ("P", "Q") + (("bias",) if kernel == "rows_epoch" else ()) \
        + tuple(spec["dense"])
    labels = [f"{pre}{n}" for pre in ("", "m_", "v_") for n in parts]
    errors = bf16_hold(f"{kernel}_bf16", zip(
        labels, (x for g in got for x in g), (x for g in want for x in g)))
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL,
          f"{kernel}_bf16 loss: rel error {loss_rel}")
    k_state, r_state = packed(), packed()
    steps, b = planes[0].shape
    u_n, i_n, d = data.user_nums, data.item_nums, model.embed_size
    n_real = int((tensors["w"] != 0).sum())
    n_state = sum(x.numel() for g in k_state[:3] for x in g)
    # bf16 storage: the params and both moments in and out at 2 bytes an
    # element; the id planes, float columns and loss at 4.
    moved = 2 * 6 * n_state + 4 * ((len(planes) + len(floats)) * steps * b
                                   + steps)
    if kernel == "rows_epoch":
        # rows_timing's count: the chain's per-row work and Adam.
        flops = (10 * (len(planes) - 1) + 4) * d * n_real \
            + 14 * n_state * steps
        names = ("rows_chain", "adam_slices", "round_tables")
    else:
        # lrml_row's count: the forward of every real row and Adam.
        flops = (8 * d * model.mem_size + 16 * d) * n_real \
            + 14 * n_state * steps
        names = ("lrml_tiles", "adam_slices", "round_tables")

    def epoch():
        return train_ops.fused_rows_epoch(*k_state, planes, floats,
                                          state.count, spec=spec, **opts)
    split = kernel_split(epoch, names)
    return {"name": f"{kernel}_bf16", "route": "cuda",
            "source": "cleverrec_tpu_torch/csrc/rows_epoch.cu",
            "replaces": "cleverrec_tpu/ops/pallas_train.py:847",
            "variant_of": f"{kernel} (table_dtype=bfloat16), {name}",
            "storage": "bf16 values in f32 buffers",
            "launches": launches,
            "max_abs_err": max(e["max_abs"] for e in errors.values()),
            "ms": time_ms(epoch), "device_ms": sum(split.values()),
            "device_split": split,
            "plain_ms": time_ms(lambda: train_ops.fused_rows_epoch_ref(
                *r_state, planes, floats, state.count,
                row_loss=spec["row_loss"], **opts), iters=3),
            **bound(moved, flops), "library_ms": None,
            "errors": errors, "loss_rel_err": loss_rel,
            "held_steps": BF16_HELD_STEPS,
            "shape": {"model": name, "U": u_n, "I": i_n, "d": d, "B": b,
                      "steps": steps, "real_rows": n_real, "bytes": moved,
                      "flops": flops}}


def grouped_trainer(name, groups, **overrides):
    """``name``'s main-path trainer on ml-100k with ``groups`` user groups,
    its state one grouped epoch in and the next draw."""
    cfg = config("ml-100k", recommender=name,
                 **{"train.fused_groups": str(groups), **overrides})
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    trainer = Trainer(model, data, cfg)
    check(trainer.fused and trainer._groups == groups,
          f"P {name}: the grouped epoch of {groups} groups is not planned")
    params, state = trainer.init_state()
    params, state, _ = trainer.train_epoch(params, state)
    return cfg, data, model, trainer, params, state, trainer.sample_epoch()


def snapshot(params, state):
    return ({n: p.detach().clone() for n, p in params.items()},
            {n: m.clone() for n, m in state.mu.items()},
            {n: v.clone() for n, v in state.nu.items()}, state.count)


def restore(params, state, snap):
    for t, saved in zip((params, state.mu, state.nu), snap[:3]):
        for n, x in saved.items():
            t[n].detach().copy_(x)
    state.count = snap[3]


def grouped_hold(tag, trainer, params, state, draw, kernel, dense=()):
    """One grouped trainer epoch on ``draw`` through the kernels and
    through their plain versions (``train_ops.PLAIN_EPOCH_FNS``) from one
    state: one launch of ``kernel`` a group, the loss and every parameter
    and moment within the atomics tolerances (``dense`` names: the
    tower's)."""
    snap = snapshot(params, state)
    before = train_ops.launches[kernel]
    _, state, loss = trainer._run_epoch(params, state, draw)
    torch.cuda.synchronize()
    launched = train_ops.launches[kernel] - before
    check(launched == trainer._groups,
          f"{tag}: {launched} launches of {kernel} for "
          f"{trainer._groups} groups")
    got = snapshot(params, state)
    restore(params, state, snap)
    trainer.epoch_fns = dict(train_ops.PLAIN_EPOCH_FNS)
    try:
        _, state, ref = trainer._run_epoch(params, state, draw)
    finally:
        trainer.epoch_fns = dict(train_ops.EPOCH_FNS)
    torch.cuda.synchronize()
    errors = {}
    for part, g_t, w_t in zip(("", "m_", "v_"), got[:3],
                              (params, state.mu, state.nu)):
        for n, g in g_t.items():
            tol = (DENSE_ATOL, DENSE_RTOL) if n in dense else (EPOCH_ATOL,
                                                               EPOCH_RTOL)
            errors.update(hold(tag, [(part + n, g, w_t[n].detach())], *tol))
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= (MLP_LOSS_RTOL if dense else EPOCH_LOSS_RTOL),
          f"{tag} loss: rel error {loss_rel}")
    restore(params, state, got)
    return {"errors": errors, "max_abs_err": max(errors.values()),
            "loss_rel_err": loss_rel, "launches": launched,
            "steps": trainer.steps_per_epoch}


def grouped_holds():
    """P-kernels, the grouped epoch: one grouped trainer epoch each of
    bpr_epoch (phase C's recipe, 4 groups), gmf_epoch, mlp_epoch (NeuMF,
    the first MLP_HELD_STEPS // 2 steps of each of its 2 groups: the
    ReLU-kink trap) and cml_epoch with the frozen sums (2 groups), held
    to their plain versions."""
    out = {}
    for name, kernel in (("BPR", "bpr_epoch"), ("GMF", "gmf_epoch"),
                         ("NeuMF", "mlp_epoch"), ("CML", "cml_epoch")):
        run = grouped_trainer(name, P_GROUPS[name])
        _, _, model, trainer, params, state, draw = run
        dense = ()
        if kernel == "mlp_epoch":
            draw = {"groups": [{k: v[:MLP_HELD_STEPS // 2]
                                for k, v in g.items()}
                               for g in draw["groups"]]}
            dense = tuple(model.fused_mlp_spec()["dense"])
        out[name] = grouped_hold(f"P grouped {name}", trainer, params,
                                 state, draw, kernel, dense)
    return out


def cml_grouped_row(launches):
    """cml_epoch with the frozen partial sums (a grouped launch) against
    its plain version at CML's main shape in 2 groups: group 1's slice
    of the permuted user state one grouped epoch in, its draw, and the
    partial sums of the rows outside it, as the trainer's grouped epoch
    launches it."""
    from cleverrec_tpu_torch.train.trainer import _p_stats
    cfg, data, model, trainer, params, state, draw = grouped_trainer(
        "CML", P_GROUPS["CML"])
    plan, g = trainer._group_plan, 1
    rows, old = plan["rows"], plan["dev"]["old"]
    user = [torch.cat([x.detach(), torch.zeros_like(x[:1])])[old]
            for x in (params["P"], state.mu["P"], state.nu["P"])]
    item = [params["Q"].detach(), state.mu["Q"], state.nu["Q"]]
    u_sent, i_sent = (n - 1 for n in train_ops.sentinel_dims(
        rows, data.item_nums))
    grp = draw["groups"][g]
    inval = grp["w"] == 0
    u = torch.where(inval, u_sent, grp["u"] - g * rows).to(
        torch.int32).contiguous()
    i = torch.where(inval, i_sent, grp["i"]).to(torch.int32).contiguous()
    negs = torch.where(inval[..., None], i_sent, grp["negs"]).to(
        torch.int32).contiguous()
    steps, b, k = negs.shape
    p_g = [x[g * rows:(g + 1) * rows] for x in user]
    fro = tuple(a - r for a, r in zip(_p_stats(user[0]), _p_stats(p_g[0])))
    ur = int(plan["grp_counts"][g])
    frozen = (ur, data.user_nums - ur, *fro)
    base = (p_g[0], item[0], p_g[1], p_g[2], item[1], item[2])
    t0 = state.count + g * steps
    opts = {"lr": cfg.lr, "reg": model.reg, "margin": model.margin,
            "item_nums": data.item_nums, "frozen": frozen}
    got, want = [x.clone() for x in base], [x.clone() for x in base]
    loss = train_ops.fused_cml_epoch(*got, u, i, negs, t0, **opts)
    ref = train_ops.fused_cml_epoch_ref(*want, u, i, negs, t0, **opts)
    torch.cuda.synchronize()
    errors = hold("cml_epoch_grouped", zip(
        ("P", "Q", "mP", "vP", "mQ", "vQ"), got, want), EPOCH_ATOL,
        EPOCH_RTOL)
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL,
          f"cml_epoch_grouped loss: rel error {loss_rel}")
    k_state, r_state = [x.clone() for x in base], [x.clone() for x in base]
    d = model.embed_size
    n_real = int((grp["w"] != 0).sum())
    n_state = (rows + data.item_nums) * d
    # cml_row's counts on the slice: six state tensors in and out, the
    # u, i and K negative planes, the loss, the frozen sums (d + 3).
    moved = 4 * (12 * n_state + (2 + k) * steps * b + steps + d + 3)
    flops = (k + 1) * 3 * d * n_real + 22 * n_state * steps
    args = (*k_state, u, i, negs, t0)
    return {"name": "cml_epoch_grouped", "route": "cuda",
            "source": "cleverrec_tpu_torch/csrc/cml_epoch.cu",
            "replaces": "cleverrec_tpu/ops/pallas_train.py:1610",
            "variant_of": "cml_epoch (frozen partial sums)",
            "launches": launches, "max_abs_err": max(errors.values()),
            "ms": time_ms(lambda: train_ops.fused_cml_epoch(*args, **opts)),
            **epoch_split("cml_epoch", args, opts, ("cml_persist",)),
            "plain_ms": time_ms(lambda: train_ops.fused_cml_epoch_ref(
                *r_state, u, i, negs, t0, **opts), iters=3),
            **bound(moved, flops), "library_ms": None,
            "errors": errors, "loss_rel_err": loss_rel,
            "shape": {"rows": rows, "ur": ur, "n_out": data.user_nums - ur,
                      "I": data.item_nums, "d": d, "K": k, "B": b,
                      "steps": steps, "real_rows": n_real, "bytes": moved,
                      "flops": flops}}


def write_grouped_synth() -> str:
    """benchmarks/grouped_scale.py's synthetic catalog, rebuilt here from
    its seed: P_SCALE's users, each with the smallest ``per_user`` of 2
    ``per_user`` Zipf(0.8)-popular draws that are distinct, a random time
    each; as UIRT csv under build/data.  Returns the dataset's name."""
    n_users, n_items, per_user = (P_SCALE[k] for k in ("users", "items",
                                                       "per_user"))
    name = f"grouped-synth-{n_users}x{n_items}"
    path = os.path.join(DATA, name, "ratings.csv")
    if os.path.exists(path):
        return name
    rng = np.random.default_rng(7)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    pop /= pop.sum()
    draws = np.sort(rng.choice(n_items, size=(n_users, per_user * 2),
                               p=pop), axis=1)
    ts = rng.integers(1e8, 2e8, size=(n_users, per_user))
    first = np.ones_like(draws, bool)
    first[:, 1:] = draws[:, 1:] != draws[:, :-1]
    rank = np.cumsum(first, axis=1) - 1
    keep = first & (rank < per_user)
    users, _ = np.nonzero(keep)
    table = np.column_stack([users, draws[keep], np.full(len(users), 5),
                             ts[users, rank[keep]]])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, table, fmt="%d", delimiter=",",
               header="u_id,i_id,rating,time", comments="")
    return name


def scale_epochs(trainer, n):
    """(params, state, per-epoch ms) of ``n`` timed epochs of ``trainer``
    after one untimed, each timed from its draw to its last kernel."""
    params, state = trainer.init_state()
    params, state, _ = trainer.train_epoch(params, state)
    times = []
    for _ in range(n):
        (params, state, _), s = sync_s(
            lambda: trainer.train_epoch(params, state))
        times.append(s * 1e3)
    return params, state, times


def phase_p_scale():
    """P-scale: grouped_scale.py's user-heavy catalog (98,304 users x
    2,048 items, ~20 pairs a user; BPR at embed 64, batch 6,144,
    neg_ratio 4) in P_SCALE's 32 groups: one grouped epoch held against
    its plain version, then timed epochs, and the ungrouped fused epoch
    timed beside it."""
    t0 = time.perf_counter()
    name = write_grouped_synth()
    values = {"recommender": "BPR", "embed_size": "64", "batch_size": "6144",
              "lr": "0.001", "neg_ratio": "4", "reg": "0.01",
              "test.neg_samples": "0", "data.user_min": "0",
              "data.item_min": "0", "topk": "[10]"}
    out = {"dataset": name, "write_s": time.perf_counter() - t0}
    cfg = config(name, **values,
                 **{"train.fused_groups": str(P_SCALE["groups"])})
    data = load_ranking_data(cfg)
    out.update(users=data.user_nums, items=data.item_nums)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    trainer = Trainer(model, data, cfg)
    out["pairs"] = trainer.n_pairs
    plan = trainer._group_plan
    check(trainer._groups == P_SCALE["groups"]
          and plan["rows"] == P_SCALE["group_rows"],
          f"P-scale: plan {trainer._groups} x {plan['rows']}")
    out["plan"] = {"groups": trainer._groups, "rows": plan["rows"],
                   "steps_eq": plan["steps_eq"],
                   "steps": trainer.steps_per_epoch}
    params, state = trainer.init_state()
    params, state, _ = trainer.train_epoch(params, state)
    out["hold"] = grouped_hold("P-scale", trainer, params, state,
                               trainer.sample_epoch(), "bpr_epoch")
    train_ops.reset_launches()
    _, _, times = scale_epochs(trainer, P_SCALE_EPOCHS)
    out["launches"] = train_ops.launches["bpr_epoch"]
    check(out["launches"] == (P_SCALE_EPOCHS + 1) * P_SCALE["groups"],
          f"P-scale: bpr_epoch launched {out['launches']} times")
    out["grouped_epoch_ms"] = times
    del trainer, params, state
    cfg = config(name, **values)
    flat = Trainer(make_model(cfg, DataMeta(data.user_nums, data.item_nums)),
                   data, cfg)
    check(flat.fused and flat._group_plan is None,
          "P-scale: the ungrouped trainer")
    _, _, flat_times = scale_epochs(flat, P_SCALE_EPOCHS)
    out["ungrouped_epoch_ms"] = flat_times
    out["grouped_ms_median"] = statistics.median(times)
    out["ungrouped_ms_median"] = statistics.median(flat_times)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_p(train):
    """The capacity tiers: P-kernels (each variant against its plain
    version), P-scale, and P-quality: each tier's run of a model held to
    that model's f32 ungrouped run in phases C, E, F and G (best HR@10
    within P_BAND)."""
    t0 = time.perf_counter()
    out = {"grouped_holds": grouped_holds()}
    out["scale"] = phase_p_scale()
    print("phase P scale: " + json.dumps(out["scale"]), flush=True)
    base = {"BPR": train["C"], "GMF": train["E"]["runs"]["GMF"],
            "NeuMF": train["E"]["runs"]["NeuMF"],
            "CML": train["G"]["runs"]["CML"],
            "SBPR": train["F"]["runs"]["SBPR"],
            "LRML": train["G"]["runs"]["LRML"]}
    epochs = {"BPR": EPOCHS, "GMF": EPOCHS, "NeuMF": EPOCHS,
              "CML": METRIC_EPOCHS["CML"], "SBPR": SOCIAL_EPOCHS,
              "LRML": METRIC_EPOCHS["LRML"]}
    kernels = {"BPR": "bpr_epoch", "GMF": "gmf_epoch", "NeuMF": "mlp_epoch",
               "CML": "cml_epoch", "SBPR": "rows_epoch",
               "LRML": "rows_epoch_lrml"}
    runs = {}
    for tier, models in (("grouped", P_GROUPS), ("bf16", P_BF16)):
        for name in models:
            if tier == "grouped":
                opt = {"train.fused_groups": str(P_GROUPS[name])}
                want = {"groups": P_GROUPS[name], "storage": "torch.float32"}
                per_epoch = P_GROUPS[name]
            else:
                opt = {"train.fused_bf16": "True"}
                want = {"groups": 0, "storage": "torch.bfloat16"}
                per_epoch = 1
            res = drive_cli(f"P_{name}_{tier}", model=name,
                            epochs=epochs[name], **opt)
            kernel = kernels[name]
            check(res["fused_form"] == want,
                  f"P {name} {tier}: the trainer ran {res['fused_form']}")
            check(res["launches"][kernel] == per_epoch * epochs[name],
                  f"P {name} {tier}: launches {res['launches']}")
            ref = base[name]["best"]["HR@10"]
            check(abs(res["best"]["HR@10"] - ref) <= P_BAND,
                  f"P {name} {tier}: best HR@10 {res['best']['HR@10']} "
                  f"against the f32 ungrouped run's {ref}")
            runs[f"{name}_{tier}"] = {
                "best": res["best"], "ref_hr10": ref,
                "loss_first": res["loss_first"],
                "loss_last": res["loss_last"],
                "epoch_ms_median": res["epoch_ms_median"],
                "ref_epoch_ms_median": base[name]["epoch_ms_median"],
                "launches": {kernel: res["launches"][kernel]}}
    out["runs"] = runs
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase Q: the parallel layer's data axis ---------------------------------

def dp_oracle():
    """tests/torch_dp_oracle.py, the serial oracle of the data-parallel
    tiers (loaded from its path: the checkout's tests/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "torch_dp_oracle", os.path.join(ROOT, "tests", "torch_dp_oracle.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def q_draw(trainer, held):
    """The trainer's next draw, its first ``held`` steps if given."""
    draw = trainer.sample_epoch()
    return draw if held is None else {k: v[:held] for k, v in draw.items()}


def q_digest(draw) -> str:
    """sha256 of every tensor of a draw (the grouped epoch's per group,
    the bucketed tier's per bucket)."""
    h = hashlib.sha256()
    for part in draw.get("groups", draw.get("buckets", [draw])):
        for name in sorted(part):
            h.update(name.encode())
            h.update(part[name].cpu().numpy().tobytes())
    return h.hexdigest()


def q_trainer(name, overrides, mesh):
    cfg = config("ml-100k", recommender=name, **overrides)
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device=mesh.device)
    return cfg, data, model, Trainer(model, data, cfg, mesh=mesh)


def q_state(params, state):
    return {"p": {n: p.detach().cpu() for n, p in params.items()},
            "mu": {n: m.cpu() for n, m in state.mu.items()},
            "nu": {n: v.cpu() for n, v in state.nu.items()},
            "count": state.count}


def q_rank(rank: int, port: int) -> int:
    """``--rank R PORT``: one of phase Q's two ranks, on cuda:0 with gloo.
    Q-parity: one data-parallel epoch of each ``Q_CASES`` case on its own
    draw (its digest, the epoch's ms, the launches, the state saved under
    build/phase_q/), then one combine timed; Q-eval: full_sharded on
    BPR's replica and rank_sharded on a 1 x 2 mesh; Q-split and Q-agree:
    one epoch of each ``Q_SPLIT`` and ``Q_AGREE`` case (``r_run``), the
    state saved; Q-quality: the CLI with --mesh 2x1 on BPR, then on
    LightGCN.  Writes build/phase_q/rank<R>.json."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    mesh = make_mesh(2, 1, "cuda:0")
    check(mesh.device == torch.device("cuda", 0), f"rank {rank}: device "
          f"{mesh.device}")
    out = {"device": str(mesh.device), "runs": {}}
    for tag, name, overrides, tier, held in Q_CASES:
        _, _, model, trainer = q_trainer(name, overrides, mesh)
        check(trainer.tier == tier and trainer._dp == 2,
              f"Q {tag}: rank {rank} took {trainer.tier} x {trainer._dp}")
        params, state = trainer.init_state()
        draw = q_draw(trainer, held)
        train_ops.reset_launches()
        (_, state, loss), sec = sync_s(
            lambda: trainer._run_epoch(params, state, draw))
        launched = {k: v for k, v in train_ops.launches.items() if v}
        check(launched.get(Q_KERNEL[tag], 0) > 0 and sum(launched.values())
              == launched[Q_KERNEL[tag]],
              f"Q {tag}: rank {rank} launched {launched}")
        torch.save({**q_state(params, state), "loss": float(loss)},
                   os.path.join(Q_DIR, f"{tag}_rank{rank}.pt"))
        out["runs"][tag] = {"digest": q_digest(draw), "epoch_ms": sec * 1e3,
                            "steps": trainer.steps_per_epoch,
                            "launches": launched}
        if tag == "BPR":
            bpr = (model, params, state)
    # One combine of BPR's state at phase C's shape (the deltas are 0, so
    # the state stays as it is).
    leaves = _state_leaves(bpr[1], bpr[2])
    olds = [x.clone() for x in leaves]
    combine_ms = [sync_s(lambda: _dp_delta_combine(mesh, "mean", leaves,
                                                   olds))[1] * 1e3
                  for _ in range(5)]
    out["combine_ms"] = statistics.median(combine_ms)
    out["combine_bytes"] = 4 * sum(x.numel() for x in leaves)
    # Q-eval on BPR's replica: a random split's full catalog.
    cfg = config("ml-100k", **{"data.split_way": "rs",
                               "test.neg_samples": "0"})
    data = load_ranking_data(cfg)
    dd = build_device_data(data)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device=mesh.device)
    copy_into({n: p.detach() for n, p in model.named_parameters()},
              {n: p.detach() for n, p in bpr[0].named_parameters()},
              "parameter")
    ev = Evaluator(model, dd, cfg, device=mesh.device, mesh=mesh)
    check(ev.mode == "full_sharded", f"Q eval: mode {ev.mode}")
    (metrics, sec) = sync_s(ev.evaluate)
    users = torch.as_tensor(dd.test_users[:Q_USERS], device=mesh.device)
    rows = torch.as_tensor(dd.seen.rows[dd.test_users[:Q_USERS]],
                           device=mesh.device).long()
    v, ids = rank_sharded(model, {}, users.long(), rows, 10,
                          make_mesh(1, 2, "cuda:0"))
    torch.save({"metrics": metrics, "values": v.cpu(), "ids": ids.cpu(),
                "p": {n: p.detach().cpu()
                      for n, p in model.named_parameters()}},
               os.path.join(Q_DIR, f"eval_rank{rank}.pt"))
    out["eval_ms"] = sec * 1e3
    # Q-split and Q-agree: one epoch of each case on the seed's draw;
    # Q-split's sums fixed, as the unmeshed epoch's that it is held to,
    # Q-agree's left to the atomics that the agreement must overcome.
    out["split"] = {}
    for cases, fixed in ((Q_SPLIT, True), (Q_AGREE, False)):
        for tag, name, overrides, _ in cases:
            res = r_run(name, overrides, mesh, evaluate=tag == "LightGCN",
                        fixed=fixed)
            torch.save({"state": res.pop("state"), "loss": res["loss"]},
                       os.path.join(Q_DIR, f"split_{tag}_rank{rank}.pt"))
            out["split"][tag] = res
    # Q-quality through the CLI on the 2 x 1 mesh, BPR then LightGCN;
    # rank 0 logs.
    for tag, model, epochs, over in (
            ("quality", "BPR", EPOCHS, Q_SYNC),
            ("split_quality", "LightGCN", Q_LIGHTGCN_EPOCHS, Q_FULL)):
        if rank == 0:
            res = drive_cli(f"Q_{tag}", model=model, epochs=epochs,
                            flags=("--mesh", "2x1"), **over)
            out[tag] = {k: res[k] for k in (
                "wall_s", "launches", "epoch_ms_median", "loss_first",
                "loss_last", "best_epoch", "best", "mesh_tier")}
        else:
            scores.reset_launches()
            train_ops.reset_launches()
            rc, wall = sync_s(lambda: cli.main(cli_argv(
                model, ("--mesh", "2x1"), cli_values(epochs, **over))))
            check(rc == 0, f"Q {tag}: rank 1's cli exit code {rc}")
            out[tag] = {"wall_s": wall, "launches": {
                **scores.launches, **train_ops.launches}}
    if rank == 0:
        check(out["quality"]["mesh_tier"] == {
            "tier": "fused", "data": 2, "sync_every": 2, "combine": "sum"},
              f"Q quality: the trainer ran {out['quality']['mesh_tier']}")
        tier = out["split_quality"]["mesh_tier"]
        check(tier["tier"] == "scan" and tier.get("split") == "batch",
              f"Q split quality: the trainer ran {tier}")
    with open(os.path.join(Q_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def q_hold(tag, name, overrides, held, ranks):
    """Q-parity of one case: the ranks' draws and replicas equal each
    other, and the serial oracle's here (the same kernels launched chunk
    by chunk from the same state on the same draw, then combined) within
    phase D's atomics tolerances (the tower's dense leaves within
    DENSE_*)."""
    oracle = dp_oracle()
    mesh = Mesh(2, 1, "cuda:0")           # shapes only: no process group
    _, _, model, trainer = q_trainer(name, overrides, mesh)
    params, state = trainer.init_state()
    draw = q_draw(trainer, held)
    digest = q_digest(draw)
    check(all(r["runs"][tag]["digest"] == digest for r in ranks),
          f"Q {tag}: the ranks' draws differ from each other or from this "
          "process's")
    if trainer.tier == "fused_grouped":
        loss = oracle.grouped_oracle(trainer, params, state, draw["groups"],
                                     2, trainer._combine)
    else:
        loss = oracle.fused_oracle(trainer, params, state, draw, 2, 0,
                                   trainer._combine)
    torch.cuda.synchronize()
    got = [torch.load(os.path.join(Q_DIR, f"{tag}_rank{r}.pt"))
           for r in range(2)]
    for part in ("p", "mu", "nu"):
        for n, x in got[0][part].items():
            check(torch.equal(x, got[1][part][n]),
                  f"Q {tag}: the ranks' {part} {n} differ")
    check(got[0]["count"] == got[1]["count"] == state.count
          and got[0]["loss"] == got[1]["loss"],
          f"Q {tag}: counts {got[0]['count']}, {got[1]['count']}, "
          f"{state.count}; losses {got[0]['loss']}, {got[1]['loss']}")
    dense = (model.fused_mlp_spec()["dense"]
             if model.fused_protocol == "pointwise_mlp" else ())
    errors = {}
    for part, want in (("p", params), ("mu", state.mu), ("nu", state.nu)):
        for n, x in got[0][part].items():
            tol = (DENSE_ATOL, DENSE_RTOL) if n in dense else (EPOCH_ATOL,
                                                               EPOCH_RTOL)
            errors.update(hold(f"Q {tag}", [(f"{part}_{n}", x.cuda(),
                                             want[n].detach())], *tol))
    loss_rel = abs(got[0]["loss"] - loss) / abs(loss)
    check(loss_rel <= (MLP_LOSS_RTOL if dense else EPOCH_LOSS_RTOL),
          f"Q {tag} loss: rel error {loss_rel}")
    return {"max_abs_err": max(errors.values()), "loss_rel_err": loss_rel,
            "epoch_ms": [r["runs"][tag]["epoch_ms"] for r in ranks],
            "steps": ranks[0]["runs"][tag]["steps"],
            "launches": [r["runs"][tag]["launches"] for r in ranks]}


def q_eval_hold():
    """Q-eval: the ranks' full_sharded metrics equal the unmeshed full
    evaluator's on the same replica, and rank_sharded over a 1 x 2 mesh
    equals rank_dense (values, and ids wherever a value is finite)."""
    got = [torch.load(os.path.join(Q_DIR, f"eval_rank{r}.pt"))
           for r in range(2)]
    cfg = config("ml-100k", **{"data.split_way": "rs",
                               "test.neg_samples": "0",
                               "eval.fused_kernel": "False"})
    data = load_ranking_data(cfg)
    dd = build_device_data(data)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    copy_into({n: p.detach() for n, p in model.named_parameters()},
              got[0]["p"], "parameter")
    ev = Evaluator(model, dd, cfg)
    check(ev.mode == "full", f"Q eval: the unmeshed mode {ev.mode}")
    want = ev.evaluate()
    gap = 0.0
    for g in got:
        for k, vals in want.items():
            for a, b in zip(g["metrics"][k], vals):
                gap = max(gap, abs(a - b))
    check(gap <= METRIC_TOL, f"Q eval: full_sharded against full {gap}")
    users = torch.as_tensor(dd.test_users[:Q_USERS]).cuda().long()
    rows = torch.as_tensor(dd.seen.rows[dd.test_users[:Q_USERS]]).cuda()
    v, ids = rank_dense(model, {}, users, rows.long(), 10)
    finite = torch.isfinite(v).cpu()
    for g in got:
        check(torch.equal(g["values"], v.cpu())
              and torch.equal(g["ids"][finite], ids.cpu()[finite]),
              "Q eval: rank_sharded over 1 x 2 differs from rank_dense")
    return {"metrics_gap": gap, "metrics": {str(k): v
                                            for k, v in want.items()}}


def q_split_hold(tag, name, overrides, scale, ranks):
    """Q-split or Q-agree (``scale`` None) of one case: the ranks' draws
    equal this process's, their states and losses equal each other bit
    for bit, and a split case's the unmeshed epoch here within
    ``Q_SPLIT_*`` times ``scale``.  LightGCN's rank-0 state is evaluated
    here through ``full_fused`` (``dot_scores``), which must give the
    ranks' ``full_sharded`` metrics."""
    runs = [r["split"][tag] for r in ranks]
    got = [torch.load(os.path.join(Q_DIR, f"split_{tag}_rank{r}.pt"))
           for r in range(2)]
    mode = "agree" if scale is None else "split"
    check(all(r["data_mode"] == mode for r in runs) or name == "FM",
          f"Q {tag}: data modes {[r['data_mode'] for r in runs]}")
    for part, tensors in got[0]["state"].items():
        for n, x in tensors.items():
            check(torch.equal(x, got[1]["state"][part][n]),
                  f"Q {tag}: the ranks' {part} {n} differ")
    check(got[0]["loss"] == got[1]["loss"],
          f"Q {tag}: losses {got[0]['loss']}, {got[1]['loss']}")
    out = {"epoch_ms": [r["epoch_ms"] for r in runs], "tier": runs[0]["tier"],
           "loss": got[0]["loss"]}
    if scale is None:
        return out
    want = r_run(name, overrides, None, fixed=True)
    check(all(r["digest"] == want["digest"] for r in runs),
          f"Q {tag}: the ranks' draws differ from this process's")
    errors = {}
    for part, tensors in want["state"].items():
        for n, x in tensors.items():
            errors.update(hold(f"Q {tag}", [(f"{part}_{n}",
                                             got[0]["state"][part][n].cuda(),
                                             x.cuda())],
                               Q_SPLIT_ATOL * scale, Q_SPLIT_RTOL * scale))
    loss_rel = abs(got[0]["loss"] - want["loss"]) / abs(want["loss"])
    check(loss_rel <= Q_SPLIT_LOSS_RTOL * scale,
          f"Q {tag} loss: rel error {loss_rel} against the unmeshed epoch")
    unfixed = sorted({*want["unfixed"],
                      *(n for r in runs for n in r["unfixed"])})
    check(not unfixed, f"Q {tag}: ops without a fixed order {unfixed}")
    out.update(max_abs_err=max(errors.values()),
               max_err_at=max(errors, key=errors.get), loss_rel_err=loss_rel,
               unmeshed_epoch_ms=want["epoch_ms"])
    if runs[0]["metrics"] is not None:
        cfg = config("ml-100k", recommender=name, **overrides)
        data = load_ranking_data(cfg)
        dd = build_device_data(data)
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
        copy_into({n: p.detach() for n, p in model.named_parameters()},
                  got[0]["state"]["p"], "parameter")
        aux = {k: torch.as_tensor(v, device="cuda")
               for k, v in model.build_aux(dd, data).items()}
        ev = Evaluator(model, dd, cfg)
        check(ev.mode == "full_fused", f"Q {tag}: eval mode {ev.mode}")
        scores.reset_launches()
        fused, _ = evaluate(f"Q {tag} full_fused", ev, aux)
        out["dot_scores"] = scores.launches["dot_scores"]
        check(out["dot_scores"] > 0, f"Q {tag}: no dot_scores launch")
        gap = max(abs(a - b) for k, vals in fused.items()
                  for r in runs for a, b in zip(r["metrics"][str(k)], vals))
        check(gap <= METRIC_TOL, f"Q {tag}: full_fused against the ranks' "
              f"full_sharded {gap}")
        out["metrics_gap"] = gap
    return out


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(flag: str, out_dir: str, timeout: float, tag: str):
    """This script re-executed as the two ranks of a mesh on cuda:0
    (``flag R PORT``), ``out_dir`` emptied first; every process is
    stopped by the deadline.  Returns each rank's rank<R>.json."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    port = free_port()
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(2)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, str(r),
                 str(port)], stdout=f, stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            check(p.returncode == 0, f"{tag}: rank {r} exited "
                  f"{p.returncode}:\n{f.read()[-4000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def phase_q(card: str):
    """The parallel layer's data axis: two ranks of this script on cuda:0
    (``--rank``), then Q-parity, Q-eval and Q-quality held here.  Two
    ranks on one card over gloo say whether the mesh is right, not how
    fast a mesh is."""
    t0 = time.perf_counter()
    # FM's files, written before the ranks start (r_run).
    write_ml100k_libfm()
    ranks = spawn_ranks("--rank", Q_DIR, Q_TIMEOUT, "Q")
    ranks_s = time.perf_counter() - t0
    out = {"card": card, "ranks": "2 on cuda:0, gloo: a check of the "
           "mesh, not a mesh's speed", "devices": [r["device"]
                                                  for r in ranks]}
    out["parity"] = {tag: q_hold(tag, name, over, held, ranks)
                     for tag, name, over, _, held in Q_CASES}
    out["eval"] = q_eval_hold()
    out["eval"]["ms"] = [r["eval_ms"] for r in ranks]
    quality = ranks[0]["quality"]
    check(abs(quality["best"]["HR@10"] - JAX_Q_HR10) <= JAX_BAND,
          f"Q quality: best HR@10 {quality['best']['HR@10']} against the "
          f"JAX CLI's {JAX_Q_HR10}")
    for r in ranks:
        check(r["quality"]["launches"]["bpr_epoch"] > 0,
              f"Q quality: launches {r['quality']['launches']}")
    out["quality"] = {**quality, "jax_hr10": JAX_Q_HR10,
                      "rank1_wall_s": ranks[1]["quality"]["wall_s"]}
    out["combine_ms"] = [r["combine_ms"] for r in ranks]
    out["combine_bytes"] = ranks[0]["combine_bytes"]
    t1 = time.perf_counter()
    out["split"] = {tag: q_split_hold(tag, name, over, scale, ranks)
                    for tag, name, over, scale in Q_SPLIT}
    out["agree"] = {tag: q_split_hold(tag, name, over, None, ranks)
                    for tag, name, over, _ in Q_AGREE}
    for tag, _, _, tier in Q_AGREE:
        check(out["agree"][tag]["tier"] == tier,
              f"Q {tag}: tier {out['agree'][tag]['tier']}")
    split_q = ranks[0]["split_quality"]
    flat = drive_cli("Q_split_quality_flat", model="LightGCN",
                     epochs=Q_LIGHTGCN_EPOCHS, **Q_FULL)
    check(flat["launches"]["dot_scores"] > 0,
          f"Q split quality: the unmeshed run launched {flat['launches']}")
    check(abs(split_q["best"]["HR@10"] - flat["best"]["HR@10"]) <= JAX_BAND,
          f"Q split quality: best HR@10 {split_q['best']['HR@10']} on 2 x 1 "
          f"against {flat['best']['HR@10']} unmeshed")
    out["split_quality"] = {
        "mesh": {k: split_q[k] for k in ("best", "best_epoch",
                                         "epoch_ms_median", "loss_first",
                                         "loss_last", "wall_s")},
        "unmeshed": {k: flat[k] for k in ("best", "best_epoch",
                                          "epoch_ms_median", "loss_first",
                                          "loss_last", "wall_s")},
        "rank1_wall_s": ranks[1]["split_quality"]["wall_s"]}
    out["split_s"] = time.perf_counter() - t1
    launches = {"dot_scores": out["split"]["LightGCN"]["dot_scores"]
                + flat["launches"]["dot_scores"]}
    for r in ranks:
        for run in [*r["runs"].values(), *r["split"].values(), r["quality"],
                    r["split_quality"]]:
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["ranks_s"] = ranks_s
    out["seconds"] = time.perf_counter() - t0
    return out

# -- phase R: the parallel layer's model axis --------------------------------

def moment_parts(state) -> dict:
    """{part: {name: tensor}} of an optimizer state's moments."""
    if hasattr(state, "sum_of_squares"):
        return {"acc": state.sum_of_squares}
    return {"mu": state.mu, "nu": state.nu}


def r_run(name, overrides, mesh, evaluate=False, fixed=False):
    """One epoch of an R (or Q-split, Q-agree) case on ``mesh`` (None:
    unmeshed, on cuda:0) from the seed's state and draw, under
    ``fixed_sums`` if ``fixed``.  Returns the state whole (the row blocks
    gathered: a collective on a mesh), the loss, the draw's digest, the
    epoch's ms, the tier, what the data ranks did with each step, the
    launches, the bytes of P, Q and their moments this process holds,
    with ``evaluate`` the evaluation after the epoch, and ``unfixed``:
    ``fixed_sums``' notes."""
    notes = []
    with fixed_sums(notes) if fixed else contextlib.nullcontext():
        res = r_epoch(name, overrides, mesh, evaluate)
    return {**res, "unfixed": notes}


def r_epoch(name, overrides, mesh, evaluate):
    """``r_run``'s epoch."""
    device = mesh.device if mesh is not None else torch.device(R_CARD)
    if name == "FM":
        from cleverrec_tpu_torch.data.libfm import load_rating_data
        from cleverrec_tpu_torch.rating import FMTrainer, make_rating_model
        # The files are written before the ranks start (phase_r): a rank
        # that rewrote them could cut them short under the other's read.
        cfg = config(LIBFM_DATASET, recommender=name, **overrides)
        data = load_rating_data(cfg)
        trainer = FMTrainer(make_rating_model(cfg, data), data, cfg,
                            device=device, mesh=mesh)
        params, state = trainer.init_state()
        order, w = trainer.epoch_order()
        digest = q_digest({"order": order, "w": w})

        def run():
            return trainer.train_epoch(params, state, order, w)[:3]
        model, tier = trainer.model, "rating"
    else:
        cfg = config("ml-100k", recommender=name, **overrides)
        data = load_ranking_data(cfg)
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                           device=device)
        trainer = Trainer(model, data, cfg, device=device, mesh=mesh)
        params, state = trainer.init_state()
        draw = trainer.sample_epoch()
        digest = q_digest(draw)
        trainer.sample_epoch = lambda: draw

        def run():
            return trainer.train_epoch(params, state)
        tier = trainer.tier
    scores.reset_launches()
    train_ops.reset_launches()
    (params, state, loss), sec = sync_s(run)
    metrics = ({str(k): v for k, v in trainer.evaluate().items()}
               if evaluate else None)
    launched = {k: v for k, v in {**scores.launches,
                                  **train_ops.launches}.items() if v}
    parts = (("p", params), *moment_parts(state).items())
    held = {f"{part}_{n}": t[n].numel() * t[n].element_size()
            for part, t in parts for n in ("P", "Q") if n in t}
    shards = sharding.shards_of(model)
    whole = {part: {n: x.detach().cpu() for n, x in
                    (sharding.full_tensors(t, shards, mesh) if mesh
                     else t).items()}
             for part, t in parts}
    return {"state": whole, "loss": float(loss), "digest": digest,
            "epoch_ms": sec * 1e3, "tier": tier,
            "data_mode": getattr(trainer, "_data_mode", None),
            "launches": launched, "held": held, "shards": sorted(shards),
            "metrics": metrics}


def r_rank(rank: int, port: int) -> int:
    """``--model-rank R PORT``: one of phase R's two ranks of a 1 x 2 mesh
    on cuda:0 with gloo.  R-parity: one epoch of each ``R_CASES`` case on
    the seed's draw, the gathered state saved under build/phase_r/.
    Writes build/phase_r/rank<R>.json."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    mesh = make_mesh(1, 2, R_CARD)
    out = {"device": str(mesh.device), "runs": {}}
    for tag, name, overrides, *_ in R_CASES:
        res = r_run(name, overrides, mesh, fixed=True)
        torch.save({"state": res.pop("state"), "loss": res["loss"]},
                   os.path.join(R_DIR, f"{tag}_rank{rank}.pt"))
        out["runs"][tag] = res
    with open(os.path.join(R_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def r_hold(tag, name, overrides, tier, exact, ranks):
    """R-parity of one case: the ranks' draws equal this process's, their
    gathered states equal each other bit for bit, and the unmeshed scan
    (or dual) epoch here bit for bit (``exact``) or within phase D's
    EPOCH_*."""
    want = r_run(name, {**overrides, "train.fused_kernel": "False"}, None,
                 fixed=True)
    got = [torch.load(os.path.join(R_DIR, f"{tag}_rank{r}.pt"))
           for r in range(2)]
    runs = [r["runs"][tag] for r in ranks]
    check(all(r["digest"] == want["digest"] for r in runs),
          f"R {tag}: the ranks' draws differ from this process's")
    check(all(r["tier"] == tier for r in runs) and want["tier"] == tier,
          f"R {tag}: tiers {[r['tier'] for r in runs]}, unmeshed "
          f"{want['tier']}")
    check(not any(r["launches"] for r in runs),
          f"R {tag}: launches {[r['launches'] for r in runs]}")
    errors = {}
    for part, tensors in want["state"].items():
        for n, x in tensors.items():
            a, b = got[0]["state"][part][n], got[1]["state"][part][n]
            check(torch.equal(a, b), f"R {tag}: the ranks' {part} {n} differ")
            if exact:
                check(torch.equal(a, x), f"R {tag}: {part} {n} differs from "
                      "the unmeshed epoch")
                errors[f"{part}_{n}"] = 0.0
            else:
                errors.update(hold(f"R {tag}", [(f"{part}_{n}", a.cuda(),
                                                 x.cuda())],
                                   EPOCH_ATOL, EPOCH_RTOL))
    loss_rel = abs(got[0]["loss"] - want["loss"]) / abs(want["loss"])
    check(got[0]["loss"] == got[1]["loss"]
          and loss_rel <= (0.0 if exact else EPOCH_LOSS_RTOL),
          f"R {tag}: losses {got[0]['loss']}, {got[1]['loss']}, unmeshed "
          f"{want['loss']}")
    unfixed = sorted({*want["unfixed"],
                      *(n for r in runs for n in r["unfixed"])})
    check(not unfixed, f"R {tag}: ops without a fixed order {unfixed}")
    return {"max_abs_err": max(errors.values()),
            "max_err_at": max(errors, key=errors.get),
            "loss_rel_err": loss_rel, "exact": exact,
            "epoch_ms": [r["epoch_ms"] for r in runs],
            "unmeshed_epoch_ms": want["epoch_ms"],
            "shards": runs[0]["shards"], "held": [r["held"] for r in runs],
            "unmeshed_held": want["held"]}


def r_cli(tag, argv, timeout=300):
    """A port CLI run in a fresh process from the checkout; its output."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    run = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    check(run.returncode == 0, f"{tag}: exit code {run.returncode}:\n"
          f"{(run.stdout + run.stderr)[-4000:]}")
    return run


def r_quality():
    """R-quality: python -m torch.distributed.run --nproc-per-node 2 ...
    --distributed --mesh 1x2 --device cuda:0 on BPR at phase C's recipe
    (two gloo ranks on the one card); rank 0's log gives the tier, the
    epochs' seconds and the best HR@10."""
    log_dir = os.path.join(R_DIR, "quality")
    argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
            "--nproc-per-node", "2", "--master-addr", "localhost",
            "--master-port", str(free_port()), "-m",
            "cleverrec_tpu_torch.cli", "--distributed", "--mesh", "1x2",
            "--device", R_CARD,
            *cli_argv("BPR", (), cli_values(EPOCHS, **{"log.dir": log_dir}))]
    _, wall = sync_s(lambda: r_cli("R quality", argv))
    with open(os.path.join(log_dir, "BPR.log")) as f:
        text = f.read()
    check(text.count("mesh 1x2: the scan tier; Q row-sharded over 2 model "
                     "ranks") == 1, "R quality: no model-axis line")
    tail = text[text.rindex("best_epoch: "):]
    best = {f"{m}@{k}": float(v) for k, hr, mrr, nd in re.findall(
        r"\(k=(\d+)\) HR=([0-9.]+), MRR=([0-9.]+), NDCG=([0-9.]+)", tail)
        for m, v in zip(("HR", "MRR", "NDCG"), (hr, mrr, nd))}
    secs = [float(x) for x in re.findall(
        r"Training loss: [-0-9.]+, time: ([0-9.]+)s", text)]
    check(len(secs) == EPOCHS, f"R quality: {len(secs)} epochs logged")
    check(abs(best["HR@10"] - JAX_R_HR10) <= JAX_BAND,
          f"R quality: best HR@10 {best['HR@10']} against the JAX CLI's "
          f"{JAX_R_HR10}")
    return {"wall_s": wall, "best": best, "jax_hr10": JAX_R_HR10,
            "epoch_s_median": statistics.median(secs),
            "best_epoch": int(re.search(r"best_epoch: (\d+)", tail)[1])}


def r_trace():
    """R-trace: BPR's CLI two blocks (2 epochs, the fused tier) with
    profile.dir in a fresh process: its one Chrome trace holds the second
    block's bpr_epoch kernel (``bpr_persist``) on the card."""
    out = os.path.join(R_DIR, "trace")
    argv = [sys.executable, "-m", "cleverrec_tpu_torch.cli",
            *cli_argv("BPR", (), cli_values(
                2, **{"log.dir": os.path.join(R_DIR, "trace_logs"),
                      "profile.dir": out}))]
    _, wall = sync_s(lambda: r_cli("R trace", argv))
    check(os.listdir(out) == ["BPR_rank0.json"], f"R trace: {os.listdir(out)}")
    with open(os.path.join(out, "BPR_rank0.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "bpr_persist" in e.get("name", "")]
    check(len(kernels) >= 1, "R trace: no bpr_epoch kernel in the trace")
    return {"wall_s": wall, "events": len(events),
            "bpr_kernels": len(kernels),
            "bpr_kernel_us": sum(e.get("dur", 0) for e in kernels)}


def phase_r(card: str):
    """The parallel layer's model axis: two ranks of this script on
    cuda:0 (``--model-rank``), R-parity and R-memory held here, then
    R-quality and R-trace, each in fresh processes.  Two ranks on one
    card over gloo say whether the model axis is right, not how fast it
    is."""
    t0 = time.perf_counter()
    write_ml100k_libfm()
    ranks = spawn_ranks("--model-rank", R_DIR, R_TIMEOUT, "R")
    ranks_s = time.perf_counter() - t0
    out = {"card": card, "ranks": "2 on cuda:0, gloo: a check of the "
           "model axis, not its speed",
           "devices": [r["device"] for r in ranks]}
    out["parity"] = {case[0]: r_hold(*case, ranks) for case in R_CASES}
    # R-memory: Q (1,682 rows) and its moments split in half; P (943
    # users, odd) stays whole on each rank, as the JAX package's rule
    # keeps a table that does not divide over the model axis.
    bpr = out["parity"]["BPR_gspmd"]
    check(bpr["shards"] == ["Q"], f"R memory: shards {bpr['shards']}")
    for held in bpr["held"]:
        for k, v in bpr["unmeshed_held"].items():
            check(held[k] * (2 if k.endswith("_Q") else 1) == v,
                  f"R memory: {k} {held[k]} of {v} bytes")
    out["memory"] = {"rank_bytes": bpr["held"][0],
                     "unmeshed_bytes": bpr["unmeshed_held"]}
    out["parity_s"] = time.perf_counter() - t0
    out["quality"] = r_quality()
    out["trace"] = r_trace()
    out["ranks_s"] = ranks_s
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    missing = [p for p in NEEDED if not os.path.exists(os.path.join(ROOT, p))]
    if missing:
        print(f"chip_smoke: not a checkout of the repo, missing {missing}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    t0 = time.perf_counter()
    build.build()
    times = {"build_s": time.perf_counter() - t0}
    for name in build.SOURCES:
        with open(build.paths(name)[2]) as f:
            print(f.read(), file=sys.stderr)

    rng = np.random.default_rng(0)
    profiles = {}
    gen = torch.Generator().manual_seed(1)
    scores.reset_launches()
    model_a, dd_a, calls_a, eval_a, t_a, metrics = phase_a(rng, profiles)
    launches_a = dict(scores.launches)
    model_b, dd_b, calls_b, t_b = phase_b(rng, profiles)
    launches_b = dict(scores.launches)
    shapes = {"A": kernel_inputs(model_a, dd_a, calls_a[0], gen),
              "E": kernel_inputs(model_a, dd_a, eval_a, gen),
              "B": kernel_inputs(model_b, dd_b, calls_b[0], gen)}
    # Phase N's launches are counted from 0 and added to the kernel rows
    # apart from A's, B's and H's.
    scores.reset_launches()
    phase_n_out = phase_n(rng, model_a, dd_a, calls_a, model_b, dd_b,
                          calls_b)
    launches_n = dict(scores.launches)
    scores.launches.update(launches_b)
    check(launches_n["dot_scores"] > 0 and launches_n["dot_gmax"] > 0,
          f"phase N launches {launches_n}")
    phase_n_out["launches"] = launches_n
    print("phase N: " + json.dumps(phase_n_out), flush=True)
    del model_b, dd_b                     # phase H needs the memory
    torch.cuda.empty_cache()
    model_h, dd_h, users_h, t_h, metrics_h = phase_h(rng, profiles)
    launches = dict(scores.launches)
    check(launches_a["dot_scores"] > 0, "phase A never launched dot_scores")
    check(launches_b["dot_gmax"] - launches_a["dot_gmax"] > 0,
          "phase B never launched dot_gmax")
    check(launches["dot_topk_scores"] - launches_b["dot_topk_scores"] > 0,
          "phase H never launched dot_topk_scores")
    for t in (t_a, t_b, t_h):
        times.update(t)
    metrics = {"A": metrics, "H": metrics_h}
    print("phase H: " + json.dumps({k: v for k, v in t_h.items()
                                    if k.startswith("H_")}), flush=True)

    shapes["H"] = kernel_inputs(model_h, dd_h, users_h, gen)
    shapes["border"] = border_inputs(rng, gen)
    del model_h, dd_h
    rows = [kernel_rows("dot_scores",
                        {k: shapes[k] for k in ("A", "E", "B", "border")},
                        launches["dot_scores"],
                        scores.dot_scores_ref, scores.dot_scores,
                        "cleverrec_tpu/ops/pallas_scores.py:276",
                        lambda b, i: b * i),
            kernel_rows("dot_gmax", {k: shapes[k] for k in ("B", "A")},
                        launches["dot_gmax"], scores.dot_gmax_ref,
                        scores.dot_gmax,
                        "cleverrec_tpu/ops/pallas_scores.py:241",
                        lambda b, i: b * -(-i // 32)),
            kernel_rows("dot_topk_scores",
                        {k: shapes[k] for k in ("H", "A")},
                        launches["dot_topk_scores"],
                        scores.dot_topk_scores_ref, scores.dot_topk_scores,
                        "cleverrec_tpu/ops/pallas_scores.py:181",
                        lambda b, i: b * (-(-i // 4096) * 4096) * 33 // 32)]
    del shapes
    torch.cuda.empty_cache()

    train = {"C": phase_c()}
    summary = ("wall_s", "epoch_first_ms", "epoch_ms_median",
               "eval_ms_median", "loss_first", "loss_last", "best_epoch",
               "best")
    print("phase C: " + json.dumps({k: train["C"][k] for k in summary}),
          flush=True)
    train["D"] = phase_d()
    print("phase D: " + json.dumps(
        {"jax_on_u_data": train["D"]["jax_on_u_data"],
         **{t: train["D"][t]["best"] for t in ("fused", "scan")}}),
          flush=True)
    train["E"] = phase_e()
    print("phase E: " + json.dumps(
        {name: {"best": run["best"], "loss_first": run["loss_first"],
                "loss_last": run["loss_last"],
                "epoch_ms_median": run["epoch_ms_median"],
                "jax_hr10": JAX_HR10[name],
                "tiers": {t: train["E"]["tiers"][name][t]["best"]
                          for t in ("fused", "scan")}}
         for name, run in train["E"]["runs"].items()}), flush=True)
    train["F"] = phase_f()
    print("phase F: " + json.dumps(
        {name: {"best": run["best"], "loss_first": run["loss_first"],
                "loss_last": run["loss_last"],
                "epoch_ms_median": run["epoch_ms_median"],
                "jax_hr10": JAX_SOCIAL_HR10[name],
                "tiers": {t: train["F"]["tiers"][name][t]["best"]
                          for t in ("fused", "scan", "stream")}
                if name in train["F"]["tiers"] else None}
         for name, run in train["F"]["runs"].items()}), flush=True)
    rows.append(epoch_row(train["C"]["launches"]["bpr_epoch"], profiles))
    rows.append(gmf_row(train["E"]["launches"]["gmf_epoch"], profiles))
    rows.append(mlp_row(train["E"]["launches"]["mlp_epoch"], profiles))
    train["G"] = phase_g(profiles)
    print("phase G: " + json.dumps(
        {name: {"best": run["best"], "loss_first": run["loss_first"],
                "loss_last": run["loss_last"],
                "epoch_ms_median": run["epoch_ms_median"],
                "eval_ms_median": run["eval_ms_median"],
                "jax_hr10": JAX_METRIC_HR10[name],
                "tiers": {t: train["G"]["tiers"][name][t]["best"]
                          for t in ("fused", "scan")}
                if name in train["G"]["tiers"] else None}
         for name, run in train["G"]["runs"].items()}), flush=True)
    train["I"] = phase_i(train, profiles)
    print("phase I: " + json.dumps(train["I"]), flush=True)
    train["J"], j_inputs = phase_j(rng, gen, profiles)
    print("phase J: " + json.dumps(train["J"]), flush=True)
    # dot_scores on phase J's serving shape; its launches add phase J's.
    j_row = kernel_rows("dot_scores", {"J": j_inputs},
                        train["J"]["launches"]["dot_scores"],
                        scores.dot_scores_ref, scores.dot_scores,
                        "cleverrec_tpu/ops/pallas_scores.py:276",
                        lambda b, i: b * i)
    del j_inputs
    train["K"], k_inputs = phase_k(rng, gen, profiles)
    print("phase K: " + json.dumps(train["K"]), flush=True)
    # ... and on phase K's: LR_GCCF's 256 users against its 1,682
    # concatenated item rows, d 256.
    k_row = kernel_rows("dot_scores", {"K": k_inputs},
                        train["K"]["launches"]["dot_scores"],
                        scores.dot_scores_ref, scores.dot_scores,
                        "cleverrec_tpu/ops/pallas_scores.py:276",
                        lambda b, i: b * i)
    del k_inputs
    train["L"] = phase_l(profiles)
    print("phase L: " + json.dumps(train["L"]), flush=True)
    train["M"] = phase_m(profiles)
    print("phase M: " + json.dumps(train["M"]), flush=True)
    train["O"] = phase_o()
    print("phase O: " + json.dumps(train["O"]), flush=True)
    train["P"] = phase_p(train)
    print("phase P: " + json.dumps({k: v for k, v in train["P"].items()
                                    if k != "scale"}), flush=True)
    train["Q"] = phase_q(smi[0])
    print("phase Q: " + json.dumps(train["Q"]), flush=True)
    train["R"] = phase_r(smi[0])
    print("phase R: " + json.dumps(train["R"]), flush=True)
    # bpr_epoch's launches: phase C's and phase L's popularity run's.
    bpr = next(row for row in rows if row["name"] == "bpr_epoch")
    bpr["launches_by_phase"] = {"C": bpr["launches"],
                                "L": train["L"]["launches"]["bpr_epoch"]}
    bpr["launches"] += train["L"]["launches"]["bpr_epoch"]
    bpr["max_abs_err"] = max(
        bpr["max_abs_err"],
        *train["L"]["bpr_epoch_popularity_hold"]["errors"].values())
    rows[0]["launches_by_phase"] = {"A_B_H": rows[0]["launches"],
                                    "J": j_row["launches"],
                                    "K": k_row["launches"],
                                    "N": launches_n["dot_scores"]}
    for extra in (j_row, k_row):
        rows[0]["launches"] += extra["launches"]
        rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                     extra["max_abs_err"])
        rows[0]["timings"] += extra["timings"]
    rows[0]["launches"] += launches_n["dot_scores"]
    # dot_gmax's launches: phase B's (with its approx calls) and N's.
    rows[1]["launches_by_phase"] = {"B": rows[1]["launches"],
                                    "N": launches_n["dot_gmax"]}
    rows[1]["launches"] += launches_n["dot_gmax"]
    rows.append(rows_row(train["F"]["launches"]["rows_epoch"], profiles))
    rows.append(lrml_row(train["G"]["launches"]["rows_epoch_lrml"],
                         profiles))
    rows.append(cml_row(train["G"]["launches"]["cml_epoch"], profiles))
    # Phase P's variants, their launches from its tier runs; the grouped
    # runs of the unchanged kernels (and P-scale's) add to their rows.
    p_runs = train["P"]["runs"]
    rows.append(bpr_bf16_row(p_runs["BPR_bf16"]["launches"]["bpr_epoch"]))
    rows.append(rows_bf16_row(
        "SBPR", "rows_epoch", p_runs["SBPR_bf16"]["launches"]["rows_epoch"]))
    rows.append(rows_bf16_row(
        "LRML", "rows_epoch_lrml",
        p_runs["LRML_bf16"]["launches"]["rows_epoch_lrml"]))
    rows.append(cml_grouped_row(
        p_runs["CML_grouped"]["launches"]["cml_epoch"]))
    for row in rows:
        extra = {"bpr_epoch": {
                     "P": p_runs["BPR_grouped"]["launches"]["bpr_epoch"],
                     "P_scale": train["P"]["scale"]["launches"]},
                 "gmf_epoch": {
                     "P": p_runs["GMF_grouped"]["launches"]["gmf_epoch"]},
                 "mlp_epoch": {
                     "P": p_runs["NeuMF_grouped"]["launches"]["mlp_epoch"]}
                 }.get(row["name"], {})
        if extra:
            row["launches_by_phase"] = {
                **row.get("launches_by_phase", {"E": row["launches"]}),
                **extra}
            row["launches"] += sum(extra.values())
        hold_p = train["P"]["grouped_holds"].get(
            {"bpr_epoch": "BPR", "gmf_epoch": "GMF", "mlp_epoch": "NeuMF",
             "cml_epoch_grouped": "CML"}.get(row["name"], ""))
        if hold_p:
            row["grouped_hold"] = hold_p
            row["max_abs_err"] = max(row["max_abs_err"],
                                     hold_p["max_abs_err"])
    # Phase Q's launches, the two ranks' (Q-parity and Q-quality).
    first_phase = {"rows_epoch": "F", "cml_epoch": "G"}
    for row in rows:
        q = train["Q"]["launches"].get(row["name"], 0)
        if q:
            by = (row.get("launches_by_phase")
                  or {first_phase[row["name"]]: row["launches"]})
            row["launches_by_phase"] = {**by, "Q": q}
            row["launches"] += q
    for row in rows:
        print(f"kernel {row['name']}: launches {row['launches']}, "
              f"max_abs_err {row['max_abs_err']}, ms {row['ms']}, "
              f"device_ms {row.get('device_ms')}, "
              f"plain_ms {row['plain_ms']}, library_ms {row['library_ms']}, "
              f"bound_ms {row['bound_ms']} ({row['bound_by']})")
    print(json.dumps({"timings": times, "launches_phase_a": launches_a,
                      "metrics": metrics, "export": phase_n_out}))
    print(json.dumps({"training": train}))
    print(json.dumps({"profiles": profiles}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if len(sys.argv) == 3 and sys.argv[1] == "--trace":
            sys.exit(trace_main(sys.argv[2]))
        if len(sys.argv) == 4 and sys.argv[1] == "--rank":
            sys.exit(q_rank(int(sys.argv[2]), int(sys.argv[3])))
        if len(sys.argv) == 4 and sys.argv[1] == "--model-rank":
            sys.exit(r_rank(int(sys.argv[2]), int(sys.argv[3])))
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
