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
  mode on a random split (full-catalog eval) and in ``candidate`` mode
  on the default leave-one-out, 99-negative protocol.  Random weights
  from the config's seed.
- Phase B, a 131072-id synthetic catalog (wide catalog, kernel
  ``dot_gmax``): the generator of ``benchmarks/catalog_scale.py``
  (49,152 users x 40 rows), 4 x 1024 users at k=20 through
  ``backend="fused"``, held against ``dense``.
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
  ml-100k alone, at the widths of their confs, 50 epochs each (the
  confs' count) through the fused tier: the kernel launches once per
  epoch, the loss falls, and the best HR@10 is at least the JAX
  package's on the same files less ``JAX_BAND``.  Then each model 3
  epochs through the fused tier, the scan tier and the fused tier with
  ``train.fused_stream=True`` (the same kernel), held to each other as
  phase D holds BPR's.
- Phase G, the metric-learning family (kernels ``cml_epoch`` and
  ``rows_epoch_lrml``, LRML's form of the rows kernel): the same CLI
  with ``--model CML``, ``LRML`` and ``TransCF`` at the widths of their
  confs and their epoch counts (30, 100, 100): CML and LRML through the
  fused tier (each kernel launches once per epoch), TransCF, which has
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
  batch 6144, neg_ratio 1), 100 epochs through the grouped pairwise
  epoch: no epoch kernel launches, the loss falls and the best HR@10 is
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
  with ``--model FISM`` (embed 128, 50 epochs), ``LightGCN`` and
  ``NGCF`` (embed 64, 3 layers, 100 epochs), each on its conf through
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
  100-epoch LightGCN's parameters on a random split: its ``full_fused``
  eval (``dot_scores`` on the propagated item rows) equal to ``full``,
  and 4 x 256 users at k=10 through ``auto``, which must pick ``fused``,
  held against ``dense``; ``dot_scores`` must launch.  One NAIS epoch is
  profiled (the device's busy share).  The ``phase J`` line gives each
  run's epoch and eval ms, first and last loss, best HR@10 beside its
  reference, the bucket plan, and phase J's seconds.
- Kernel rows: each kernel against its plain PyTorch version at the
  shapes of its phase, timed beside the plain version, a library call
  where one computes the same function (yardstick only), and the least
  time the card needs for the same work.  The scoring rows also give the
  kernel's own device time (``device_ms``, from torch.profiler), the
  library call's (``library_device_ms``) and the host's time to issue
  one wrapper call (``wrapper_us``, over the calls ``ms`` times);
  ``dot_scores`` is held and timed at A, at phase A's eval batches (E:
  its 1,024-user ``full_fused`` batches, which take another tile), at B,
  at N, 1,024 users x 4,096 items (the narrow branch's border), and at J
  (phase J's first serving call: LightGCN's 256 propagated user rows
  against its 1,682 item rows, d 64),
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
  device kernel; ``device_trace_from``).

Launch counts are set to 0 before phase A and read after phases A, B
and H, again before and after each training run (phases I's and J's
included), and before and after phase J's LightGCN eval and serving
(``dot_scores``' row counts A, B, H and J).  Exits non-zero, with no
result line, on any failure or without a CUDA device.  The last line of
stdout is ``{"ok": true, "device": {...}}``; the line before it lists
the kernels.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cleverrec_tpu_torch import cli
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import STREAM_THRESHOLD, Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import build, scores
from cleverrec_tpu_torch.ops import train as train_ops
from cleverrec_tpu_torch.ops.topk import topk
from cleverrec_tpu_torch.sampling import rows_to_bits
from cleverrec_tpu_torch.serving import build_retrieval_fn
from cleverrec_tpu_torch.train import Trainer
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
          "conf/NGCF.properties",
          "benchmarks/UIRT/ml100k.train.libfm",
          "benchmarks/UIRT/ml100k.test.libfm", "benchmarks/PARITY_BPR.json")

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
SOCIAL_EPOCHS = 50    # the epoches of conf/{SBPR,TBPR,CUNE_BPR}.properties
TRUST_SEED = 2026
# Phase F: the JAX package's best HR@10 on the same rebuilt ml-100k and the
# trust graph of write_trusts(TRUST_SEED), each conf's recipe, 50 epochs
# (the JAX CLI on the CPU; the command is in PERF.md).
JAX_SOCIAL_HR10 = {"SBPR": 0.7391, "TBPR": 0.6819, "CUNE_BPR": 0.7635}
METRIC = ("CML", "LRML", "TransCF")
METRIC_EPOCHS = {"CML": 30, "LRML": 100, "TransCF": 100}   # the confs'
METRIC_KERNEL = {"CML": "cml_epoch", "LRML": "rows_epoch_lrml",
                 "TransCF": None}
# Phase G: the JAX package's best HR@10 on the same rebuilt ml-100k, each
# conf's recipe and epoch count (the JAX CLI on the CPU; the command is in
# PERF.md).
JAX_METRIC_HR10 = {"CML": 0.8017, "LRML": 0.8271, "TransCF": 0.8314}
TRAP_EPOCHS = 5       # CML's epochs before the distance-model trap
SAMN_EPOCHS = 100     # the epoches of conf/SAMN.properties
# Phase I: the JAX package's best HR@10 for SAMN on the same rebuilt
# ml-100k and the trust graph of write_trusts(TRUST_SEED), the conf's
# recipe, 100 epochs (the JAX CLI on the CPU; the command is in PERF.md).
JAX_SAMN_HR10 = 0.8303
SAMN_SINGLE_EPOCHS = 10
# SAMN's grouped against its flat epoch: they converge at different
# rates.  On the same files the JAX CLI's flat epoch leads the grouped one
# by 0.025 HR@10 at epoch 10 and by 0.01 or less from epoch 25 on (best
# HR@10 over 100 epochs 0.8388 flat, 0.8303 grouped), so they are held to
# each other after 30 epochs.
GROUPED_FLAT_EPOCHS = 30
CKPT_EPOCHS = (2, 4)     # BPR: saved after the first, resumed to the second
PRETRAIN_EPOCHS = 3      # GMF and MLP before NeuMF's warm start
# Phase J: the confs' epoch counts (FISM 50, LightGCN and NGCF 100), and
# NAIS's, warm and cold, cut from the conf's 50 to what phase J's time
# allows.
ITEM_GRAPH_EPOCHS = {"FISM": 50, "LightGCN": 100, "NGCF": 100}
NAIS_EPOCHS = 10
NAIS_SHORT_EPOCHS = 2   # NAIS_single, and NAIS on the flat tier
EDGE_EPOCHS = 5         # LightGCN's dense against its edge-list path
# Phase J: the JAX package's best HR@10 on the same rebuilt ml-100k, each
# conf's recipe at the epoch counts above, from the JAX CLI on the CPU:
#   JAX_PLATFORMS=cpu python -m cleverrec_tpu.cli --config
#     CleverRec.properties --conf-dir conf --set data.root_dir=build/data
#     --set data.file_name=ratings.csv --set data.sep=, --model M
# with M FISM (and --set save.best=True --set saved_dir=DIR), LightGCN,
# NGCF, and NAIS with --set epoches=10 --set test.batch_size=256, cold
# and warm-started from that FISM (--set fism_pretrain=DIR/FISM).
JAX_ITEM_GRAPH_HR10 = {"FISM": 0.7922, "LightGCN": 0.7519, "NGCF": 0.8293,
                       "NAIS_warm": 0.6437, "NAIS_cold": 0.8070}
# The JAX CLI's first-epoch NAIS loss on the same files, warm-started from
# its FISM and cold: the warm start raises it.  Phase J holds the port's
# warm first epoch above WARM_GAP times its cold one.
JAX_NAIS_FIRST_LOSS = {"warm": 1036.9663, "cold": 382.5351}
WARM_GAP = 1.1
H_IDS = 4_194_304     # phase H: the synthetic catalog's id range
H_K = 20


class SmokeError(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


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


def write_ml100k() -> None:
    """ml-100k as UIRT csv from the repo's libfm copy: `rating,<u>:1,
    <943+i>:1` lines, train then test; the time is the row's position."""
    rows = []
    for part in ("train", "test"):
        path = os.path.join(ROOT, "benchmarks", "UIRT", f"ml100k.{part}.libfm")
        with open(path) as f:
            for line in f:
                r, u, i = line.strip().split(",")
                rows.append((int(u.split(":")[0]),
                             int(i.split(":")[0]) - 943, int(float(r))))
    table = np.asarray(rows, dtype=np.int64)
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
          profiles, aux=None):
    """Serve 4 calls through ``backend``, which must resolve to
    ``expect``, and hold each to dense; time both backends and add a
    kernel breakdown of one call of each to ``profiles``.  ``aux``: the
    model's (default none).  Returns the calls' users, the times and the
    dense answers."""
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
                              dd.item_nums)
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

    cand_cfg = config("ml-100k")                  # loo, 99 negatives
    cand_data = load_ranking_data(cand_cfg)
    cand_ev = Evaluator(model, build_device_data(cand_data), cand_cfg)
    check(cand_ev.mode == "candidate", f"eval mode {cand_ev.mode}")
    cand, times["A_eval_candidate_s"] = evaluate("candidate", cand_ev)
    metrics = {"full_fused": got, "full": want, "candidate": cand}
    # The users of the full_fused eval's first batch: the test users
    # wrapped to a whole batch of test.batch_size, as the Evaluator pads.
    eval_users = dd.test_users[np.arange(cfg.test_batch_size)
                               % len(dd.test_users)]
    return model, dd, calls[0], eval_users, times, metrics


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
    return model, dd, calls[0], times


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


def drive_cli(tag, model="BPR", epochs=EPOCHS, flags=(), runs=None,
              trials=1, **overrides):
    """Run the port's CLI on ``model``'s recipe (CleverRec.properties and
    its conf), on the rebuilt ml-100k, for ``epochs`` epochs with
    ``overrides`` and the further ``flags``; its log goes to
    build/logs/<tag>.log.  ``runs`` is the epochs a run trains (all of
    them unless it resumes), ``trials`` the runs (``--tune``'s grid).
    Returns the (last) run's numbers and all the kernel launches (counts
    set to 0 first)."""
    values = {"data.root_dir": DATA, "data.file_name": "ratings.csv",
              "data.sep": ",", "log.dir": LOGS, "epoches": epochs}
    values.update(overrides)
    argv = ["--config", os.path.join(ROOT, "CleverRec.properties"),
            "--conf-dir", os.path.join(ROOT, "conf"), "--model", model,
            *flags]
    for k, v in values.items():
        argv += ["--set", f"{k}={v}"]
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
    launches = {**scores.launches, **train_ops.launches}
    check(rc == 0, f"{tag}: cli exit code {rc}")
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
            "buckets": records.buckets[-1] if records.buckets else None}


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
    """The social-triple family at its confs' widths, 50 epochs each
    through the fused tier; then 3 epochs of each through the fused tier,
    the scan tier and the streamed option, on identical draws."""
    stats = social_stats(write_trusts())
    print("phase F trust graph: " + json.dumps(stats), flush=True)
    runs, tiers = {}, {}
    for name in SOCIAL:
        res = runs[name] = drive_cli(f"F_{name}", model=name,
                                     epochs=SOCIAL_EPOCHS)
        check(res["launches"]["rows_epoch"] == SOCIAL_EPOCHS
              and sum(res["launches"].values()) == SOCIAL_EPOCHS,
              f"F {name}: launches {res['launches']}")
        check(res["loss_last"] < res["loss_first"],
              f"F {name}: loss {res['loss_first']} -> {res['loss_last']}")
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
        check(got == {"fused": TIER_EPOCHS, "scan": 0, "stream": TIER_EPOCHS}
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


def one_epoch_in(name):
    """The main path's trainer for ``name`` on ml-100k, its state after
    one trained epoch, and the next epoch's draw."""
    cfg = config("ml-100k", recommender=name)
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


def lightgcn_ranking(ckpt, rng, gen, profiles):
    """LightGCN's trained parameters (the checkpoint ``ckpt``) on a random
    split with the full-catalog eval: ``full_fused`` against ``full``,
    and 4 x 256 users at k=10 through ``auto`` (which must pick
    ``fused``) against ``dense``, the counts set to 0 just before.
    Returns the numbers, with the dot_scores launches, and dot_scores'
    inputs at the first call's users: the propagated user rows and the
    item rows, a row slice of the propagated matrix."""
    cfg = config("ml-100k", recommender="LightGCN",
                 **{"test.neg_samples": "0", "data.split_way": "rs"})
    data = load_ranking_data(cfg)
    dd = build_device_data(data)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    copy_into({k: p.detach() for k, p in model.named_parameters()},
              load_params(ckpt), "parameter")
    aux = {k: torch.as_tensor(v, device="cuda")
           for k, v in model.build_aux(dd, data).items()}
    scores.reset_launches()
    fused_ev = Evaluator(model, dd, cfg)
    full_ev = Evaluator(model, dd, cfg.with_overrides(
        **{"eval.fused_kernel": "False"}))
    check((fused_ev.mode, full_ev.mode) == ("full_fused", "full"),
          f"J eval modes {fused_ev.mode}, {full_ev.mode}")
    out = {}
    got, out["eval_full_fused_s"] = evaluate("J full_fused", fused_ev, aux)
    want, out["eval_full_s"] = evaluate("J full", full_ev, aux)
    for k in cfg.topk:
        check(bool(np.allclose(got[k], want[k], atol=METRIC_TOL, rtol=0)),
              f"J @{k}: full_fused {got[k]} vs full {want[k]}")
    calls, times, _ = serve("J", model, dd, 10, 256, "auto", "fused", rng,
                            profiles, aux=aux)
    out.update(times)
    out["launches"] = {"dot_scores": scores.launches["dot_scores"]}
    check(out["launches"]["dot_scores"] > 0,
          "phase J never launched dot_scores")
    out["metrics"] = {"full_fused": got, "full": want}
    with torch.no_grad():
        uv, table, _ = model.dot_decomposition(
            torch.as_tensor(calls[0], device="cuda").long(), aux)
    check(table.storage_offset() == data.user_nums * table.shape[1],
          "J: the item table is not the propagated matrix's item rows")
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
    ranked, inputs = lightgcn_ranking(os.path.join(saved, "LightGCN"), rng,
                                      gen, profiles)
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


def epoch_row(launches, profiles):
    """bpr_epoch against its plain version on one state and one sampled
    epoch at the main shape (ml-100k, embed 128, B 6144): the state after
    one trained epoch, the next epoch's draw.  Times both and the card's
    least time for the same work."""
    cfg, data, model, trainer, params, state, tensors = one_epoch_in("BPR")
    ids = sentinel_ids(data, tensors, ("u", "i", "j"))
    names = ("P", "Q", "mP", "vP", "mQ", "vQ")
    base = (params["P"].detach(), params["Q"].detach(), state.mu["P"],
            state.nu["P"], state.mu["Q"], state.nu["Q"])
    opts = {"lr": cfg.lr, "reg": model.reg}
    got, want = [x.clone() for x in base], [x.clone() for x in base]
    loss = train_ops.fused_bpr_epoch(*got, *ids, state.count, **opts)
    ref = train_ops.fused_bpr_epoch_ref(*want, *ids, state.count, **opts)
    torch.cuda.synchronize()
    errors = hold("bpr_epoch", zip(names, got, want), EPOCH_ATOL, EPOCH_RTOL)
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL, f"bpr_epoch loss: rel error {loss_rel}")

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
    model_a, dd_a, users_a, eval_a, t_a, metrics = phase_a(rng, profiles)
    launches_a = dict(scores.launches)
    model_b, dd_b, users_b, t_b = phase_b(rng, profiles)
    launches_b = dict(scores.launches)
    shapes = {"A": kernel_inputs(model_a, dd_a, users_a, gen),
              "E": kernel_inputs(model_a, dd_a, eval_a, gen),
              "B": kernel_inputs(model_b, dd_b, users_b, gen)}
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
    shapes["N"] = border_inputs(rng, gen)
    del model_h, dd_h
    rows = [kernel_rows("dot_scores",
                        {k: shapes[k] for k in ("A", "E", "B", "N")},
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
                          for t in ("fused", "scan", "stream")}}
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
    rows[0]["launches_by_phase"] = {"A_B_H": rows[0]["launches"],
                                    "J": j_row["launches"]}
    rows[0]["launches"] += j_row["launches"]
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"],
                                 j_row["max_abs_err"])
    rows[0]["timings"] += j_row["timings"]
    rows.append(rows_row(train["F"]["launches"]["rows_epoch"], profiles))
    rows.append(lrml_row(train["G"]["launches"]["rows_epoch_lrml"],
                         profiles))
    rows.append(cml_row(train["G"]["launches"]["cml_epoch"], profiles))
    for row in rows:
        print(f"kernel {row['name']}: launches {row['launches']}, "
              f"max_abs_err {row['max_abs_err']}, ms {row['ms']}, "
              f"device_ms {row.get('device_ms')}, "
              f"plain_ms {row['plain_ms']}, library_ms {row['library_ms']}, "
              f"bound_ms {row['bound_ms']} ({row['bound_by']})")
    print(json.dumps({"timings": times, "launches_phase_a": launches_a,
                      "metrics": metrics}))
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
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
