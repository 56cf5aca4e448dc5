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
- Kernel rows: each kernel against its plain PyTorch version at the
  shapes of its phase, timed beside the plain version, a library call
  where one computes the same function (yardstick only), and the least
  time the card needs for the same work.

Launch counts are set to 0 before phase A and read after phases A and B,
and again before and after each training run.  Exits non-zero, with no
result line, on any failure or without a CUDA device.  The last line of
stdout is ``{"ok": true, "device": {...}}``; the line before it lists
the kernels.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cleverrec_tpu_torch import cli
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import build, scores
from cleverrec_tpu_torch.ops import train as train_ops
from cleverrec_tpu_torch.serving import build_retrieval_fn
from cleverrec_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "build", "data")
LOGS = os.path.join(ROOT, "build", "logs")
NEEDED = ("cleverrec_tpu_torch/csrc/dot_scores.cu",
          "cleverrec_tpu_torch/csrc/bpr_epoch.cu", "CleverRec.properties",
          "conf/BPR.properties", "benchmarks/UIRT/ml100k.train.libfm",
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


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms over ``iters`` runs, CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def check_answer(tag, got, want, bits, k, item_nums):
    """Fused answer vs dense answer: same shape, scores within SERVE_RTOL,
    ids equal except among near-tied scores, no seen or out-of-range id."""
    (gi, gv), (wi, wv) = [(i.cpu().numpy(), v.cpu().numpy())
                          for i, v in (got, want)]
    check(gi.shape == wi.shape == gv.shape == (bits.shape[0], k),
          f"{tag}: shape {gi.shape}")
    check(bool(np.isfinite(gv[gi >= 0]).all()), f"{tag}: non-finite score")
    check(bool(((gi >= -1) & (gi < item_nums)).all()), f"{tag}: id range")
    check(not seen_in(bits, gi)[gi >= 0].any(), f"{tag}: seen item served")
    check(bool(np.allclose(gv, wv, rtol=SERVE_RTOL, atol=0)),
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
    """Device time of one fn() call by kernel, from torch.profiler: the
    top kernels, their sum, and the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_s(fn)
    # Device-side events only (kernels, copies): a CPU op's row repeats
    # the time of the kernels it launched.
    kernels = sorted(((e.key[:70], e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "top": [{"kernel": name, "ms": ms, "count": n}
                    for name, ms, n in kernels[:top]]}


def serve(tag, model, dd, k, users_per_call, backend_fused, rng, profiles):
    """Serve 4 calls through the fused backend and hold each to dense;
    time both backends and add a kernel breakdown of one call of each to
    ``profiles``."""
    fused = build_retrieval_fn(model, {}, dd, k=k, backend=backend_fused)
    check(fused.backend == "fused", f"{tag}: auto picked {fused.backend}")
    dense = build_retrieval_fn(model, {}, dd, k=k, backend="dense")
    calls = [np.sort(rng.choice(dd.user_nums, users_per_call, replace=False))
             for _ in range(4)]
    swaps, fused_s, dense_s = 0, [], []
    for u in calls:
        got, s = sync_s(lambda: fused(u))
        fused_s.append(s)
        want, s = sync_s(lambda: dense(u))
        dense_s.append(s)
        swaps += check_answer(tag, got, want, dd.seen.bits[u], k,
                              dd.item_nums)
    u = calls[0]

    def per_call_ms(fn):
        return sync_s(lambda: [fn(u) for _ in range(10)])[1] * 100

    times = {f"{tag}_serve_first_call_s": fused_s[0],
             f"{tag}_serve_fused_ms": per_call_ms(fused),
             f"{tag}_serve_dense_ms": per_call_ms(dense),
             f"{tag}_tied_id_swaps": swaps}
    profiles[f"{tag}_fused"] = breakdown(lambda: fused(u))
    profiles[f"{tag}_dense"] = breakdown(lambda: dense(u))
    return calls, times


def evaluate(tag, evaluator):
    evaluator.evaluate()                  # first use loads CUDA modules
    res, s = sync_s(evaluator.evaluate)
    host = evaluator.evaluate_host()
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
    calls, times = serve("A", model, dd, 10, 256, "auto", rng, profiles)
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
    return model, dd, calls[0], times, metrics


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
    calls, times = serve("B", model, dd, 20, 1024, "fused", rng, profiles)
    times["B_data_s"] = load_s
    times["B_items"] = data.item_nums
    return model, dd, calls[0], times


def kernel_rows(name, shapes, launches, ref, kernel, replaces):
    """Hold ``kernel`` to ``ref`` on each phase's inputs, with and without
    bias, and time it; one row of the kernels line."""
    row = {"name": name, "route": "cuda",
           "source": "cleverrec_tpu_torch/csrc/dot_scores.cu",
           "replaces": replaces, "launches": launches, "max_abs_err": 0.0}
    timings = []
    for tag, (u, q, bits, bias) in shapes.items():
        for b in (None, bias):
            got, want = kernel(u, q, bits, b), ref(u, q, bits, b)
            torch.cuda.synchronize()
            masked = want == scores.NEG
            check(bool(torch.equal(got == scores.NEG, masked)),
                  f"{name} {tag}: masked slots differ")
            err = (got[~masked] - want[~masked]).abs()
            check(bool(torch.isfinite(got[~masked]).all()),
                  f"{name} {tag}: non-finite")
            check(bool((err <= KERNEL_ATOL
                        + KERNEL_RTOL * want[~masked].abs()).all()),
                  f"{name} {tag}: max error {err.max().item()}")
            row["max_abs_err"] = max(row["max_abs_err"], err.max().item())
        bsz, d = u.shape
        n_items = q.shape[0]
        out_elems = bsz * (n_items if name == "dot_scores"
                           else -(-n_items // 32))
        moved = 4 * (u.numel() + q.numel() + bits.numel() + out_elems)
        flops = 2 * bsz * n_items * d
        t_bytes, t_ops = moved / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
        timings.append({
            "shape": tag, "B": bsz, "I": n_items, "d": d,
            "ms": time_ms(lambda: kernel(u, q, bits)),
            "ms_bias": time_ms(lambda: kernel(u, q, bits, bias)),
            "plain_ms": time_ms(lambda: ref(u, q, bits)),
            "library_ms": time_ms(lambda: torch.matmul(u, q.T)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    main = timings[0]
    row.update({key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")})
    row["timings"] = timings
    return row


def kernel_inputs(model, dd, users, gen):
    u_idx = torch.as_tensor(users, device="cuda").long()
    with torch.no_grad():
        u = model.P[u_idx].contiguous()
        q = model.Q.detach().contiguous()
    bits = torch.as_tensor(dd.seen.bits[users], device="cuda")
    bias = torch.randn(q.shape[0], generator=gen).cuda()
    return u, q, bits, bias


class Records(logging.Handler):
    """Collects the numbers the trainer's log records carry."""

    def __init__(self):
        super().__init__()
        self.train, self.eval, self.best = [], [], None

    def emit(self, record):
        if hasattr(record, "train"):
            self.train.append(record.train)
        if hasattr(record, "eval"):
            self.eval.append(record.eval)
        if hasattr(record, "best"):
            self.best = record.best


def drive_cli(tag, **overrides):
    """Run the port's CLI on the default recipe, on the rebuilt ml-100k,
    with ``overrides``; its log goes to build/logs/<tag>.log.  Returns
    the run's numbers and its kernel launches (counts set to 0 first)."""
    values = {"data.root_dir": DATA, "data.file_name": "ratings.csv",
              "data.sep": ",", "log.dir": LOGS}
    values.update(overrides)
    argv = ["--config", os.path.join(ROOT, "CleverRec.properties"),
            "--conf-dir", os.path.join(ROOT, "conf")]
    for k, v in values.items():
        argv += ["--set", f"{k}={v}"]
    os.makedirs(LOGS, exist_ok=True)
    records = Records()
    log_file = logging.FileHandler(os.path.join(LOGS, f"{tag}.log"))
    log_file.setFormatter(logging.Formatter("%(asctime)s  %(message)s"))
    # Handlers set before the CLI's get_logger keep its log off stdout.
    logger = logging.getLogger("cleverrec_tpu_torch.BPR")
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
    check(len(records.train) == EPOCHS == len(records.eval)
          and records.best is not None,
          f"{tag}: {len(records.train)} epochs, {len(records.eval)} evals")
    losses = [r["losses"][-1] for r in records.train]
    check(all(np.isfinite(losses)), f"{tag}: losses {losses}")
    train_ms = [r["seconds"] * 1e3 for r in records.train]
    eval_ms = [r["seconds"] * 1e3 for r in records.eval]
    best = {f"{name}@{k}": v for k, vals in records.best["metrics"].items()
            for name, v in zip(("HR", "MRR", "NDCG"), vals)}
    check(all(np.isfinite(v) and 0 <= v <= 1 for v in best.values()),
          f"{tag}: best metrics {best}")
    return {"wall_s": wall, "launches": launches,
            "epoch_first_ms": train_ms[0],
            "epoch_ms_median": statistics.median(train_ms[1:]),
            "eval_ms_median": statistics.median(eval_ms),
            "loss_first": losses[0], "loss_last": losses[-1],
            "best_epoch": records.best["epoch"], "best": best,
            "epoch_ms": train_ms, "losses": losses}


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


def epoch_row(launches, profiles):
    """bpr_epoch against its plain version on one state and one sampled
    epoch at the main shape (ml-100k, embed 128, B 6144): the state after
    one trained epoch, the next epoch's draw.  Times both and the card's
    least time for the same work."""
    cfg = config("ml-100k")
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
    trainer = Trainer(model, data, cfg)
    check(trainer.fused, "the recipe must take the fused tier on the card")
    params, state = trainer.init_state()
    params, state, _ = trainer.train_epoch(params, state)
    tensors = trainer.sample_epoch()
    u_sent, i_sent = (n - 1 for n in train_ops.sentinel_dims(
        data.user_nums, data.item_nums))
    inval = tensors["w"] == 0
    ids = [torch.where(inval, sent, tensors[k]).to(torch.int32).contiguous()
           for k, sent in (("u", u_sent), ("i", i_sent), ("j", i_sent))]
    names = ("P", "Q", "mP", "vP", "mQ", "vQ")
    base = (params["P"].detach(), params["Q"].detach(), state.mu["P"],
            state.nu["P"], state.mu["Q"], state.nu["Q"])
    opts = {"lr": cfg.lr, "reg": model.reg}
    got, want = [x.clone() for x in base], [x.clone() for x in base]
    loss = train_ops.fused_bpr_epoch(*got, *ids, state.count, **opts)
    ref = train_ops.fused_bpr_epoch_ref(*want, *ids, state.count, **opts)
    torch.cuda.synchronize()
    errors = {}
    for name, g, w in zip(names, got, want):
        check(bool(torch.isfinite(g).all()), f"bpr_epoch {name}: non-finite")
        errors[name] = (g - w).abs().max().item()
        check(bool(((g - w).abs() <= EPOCH_ATOL + EPOCH_RTOL * w.abs()).all()),
              f"bpr_epoch {name}: max error {errors[name]}")
    loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
    check(loss_rel <= EPOCH_LOSS_RTOL, f"bpr_epoch loss: rel error {loss_rel}")

    k_state, r_state = [x.clone() for x in base], [x.clone() for x in base]
    steps, b = ids[0].shape
    u_n, i_n, d = data.user_nums, data.item_nums, model.embed_size
    n_real = int((~inval).sum())
    # Each input read once and each output written once: six state
    # tables in and out, the three id planes, the per-step loss.
    moved = 4 * (12 * (u_n + i_n) * d + 3 * steps * b + steps)
    # FP32 operations: 21 d per real slot (qi - qj, the dot, three
    # squared norms, three row grads, three scatter-adds) and 14 per
    # element of P and Q per step for Adam.
    flops = 21 * d * n_real + 14 * (u_n + i_n) * d * steps
    t_bytes, t_ops = moved / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    row = {"name": "bpr_epoch", "route": "cuda",
           "source": "cleverrec_tpu_torch/csrc/bpr_epoch.cu",
           "replaces": "cleverrec_tpu/ops/pallas_train.py:276",
           "launches": launches, "max_abs_err": max(errors.values()),
           "ms": time_ms(lambda: train_ops.fused_bpr_epoch(
               *k_state, *ids, state.count, **opts)),
           "plain_ms": time_ms(lambda: train_ops.fused_bpr_epoch_ref(
               *r_state, *ids, state.count, **opts), iters=5),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           # No single PyTorch call trains an epoch.
           "library_ms": None,
           "errors": errors, "loss_rel_err": loss_rel,
           "shape": {"U": u_n, "I": i_n, "d": d, "B": b, "steps": steps,
                     "real_slots": n_real, "bytes": moved, "flops": flops}}
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
    scores.reset_launches()
    model_a, dd_a, users_a, t_a, metrics = phase_a(rng, profiles)
    launches_a = dict(scores.launches)
    model_b, dd_b, users_b, t_b = phase_b(rng, profiles)
    launches = dict(scores.launches)
    check(launches_a["dot_scores"] > 0, "phase A never launched dot_scores")
    check(launches["dot_gmax"] - launches_a["dot_gmax"] > 0,
          "phase B never launched dot_gmax")
    times.update(t_a)
    times.update(t_b)

    gen = torch.Generator().manual_seed(1)
    shapes = {"A": kernel_inputs(model_a, dd_a, users_a, gen),
              "B": kernel_inputs(model_b, dd_b, users_b, gen)}
    rows = [kernel_rows("dot_scores", shapes, launches["dot_scores"],
                        scores.dot_scores_ref, scores.dot_scores,
                        "cleverrec_tpu/ops/pallas_scores.py:276"),
            kernel_rows("dot_gmax", dict(reversed(shapes.items())),
                        launches["dot_gmax"], scores.dot_gmax_ref,
                        scores.dot_gmax,
                        "cleverrec_tpu/ops/pallas_scores.py:241")]

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
    rows.append(epoch_row(train["C"]["launches"]["bpr_epoch"], profiles))
    for row in rows:
        print(f"kernel {row['name']}: launches {row['launches']}, "
              f"max_abs_err {row['max_abs_err']}, ms {row['ms']}, "
              f"plain_ms {row['plain_ms']}, library_ms {row['library_ms']}, "
              f"bound_ms {row['bound_ms']} ({row['bound_by']})")
    print(json.dumps({"timings": times, "launches_phase_a": launches_a,
                      "metrics_phase_a": metrics}))
    print(json.dumps({"training": train}))
    print(json.dumps({"profiles": profiles}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
