"""Drive the PyTorch port's serving and eval path on one NVIDIA GPU.

    python3 chip_smoke.py        (from the root of a checkout)

Builds the port's CUDA kernels from ``cleverrec_tpu_torch/csrc`` with
``nvcc``, then, with BPR at the width of ``conf/BPR.properties``
(embed_size 128) and random weights from the config's seed:

- Phase A, ml-100k (narrow catalog, kernel ``dot_scores``): rebuilds the
  ratings from ``benchmarks/UIRT/ml100k.{train,test}.libfm``, serves
  4 x 256 users at k=10 through ``build_retrieval_fn(backend="auto")``
  (which must pick ``fused``) and holds every answer against the
  ``dense`` backend; runs the Evaluator in ``full_fused`` and ``full``
  mode on a random split (full-catalog eval) and in ``candidate`` mode
  on the default leave-one-out, 99-negative protocol.
- Phase B, a 131072-id synthetic catalog (wide catalog, kernel
  ``dot_gmax``): the generator of ``benchmarks/catalog_scale.py``
  (49,152 users x 40 rows), 4 x 1024 users at k=20 through
  ``backend="fused"``, held against ``dense``.
- Phase C: each kernel against its plain PyTorch version at the shapes of
  phases A and B, with and without an item bias, and timed beside the
  plain version, a ``torch.matmul`` of the dot part alone (yardstick
  only), and the least time the card needs for the same work.

Launch counts are set to 0 before phase A and read after phase B: each
kernel must have launched in its phase.  Exits non-zero, with no result
line, on any failure or without a CUDA device.  The last line of stdout
is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import build, scores
from cleverrec_tpu_torch.serving import build_retrieval_fn

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "build", "data")
NEEDED = ("cleverrec_tpu_torch/csrc/dot_scores.cu", "CleverRec.properties",
          "conf/BPR.properties", "benchmarks/UIRT/ml100k.train.libfm",
          "benchmarks/UIRT/ml100k.test.libfm")

# NVIDIA H100 SXM data sheet: FP32 on the CUDA cores, HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

SERVE_RTOL = 1e-4     # fused vs dense scores (f32 sums in another order)
METRIC_TOL = 1e-6     # full_fused vs full eval metrics
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 1e-5   # kernel vs plain, unmasked slots


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
    with open(build.paths("dot_scores")[2]) as f:
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
    for row in rows:
        print(f"kernel {row['name']}: launches {row['launches']}, "
              f"max_abs_err {row['max_abs_err']}, ms {row['ms']}, "
              f"plain_ms {row['plain_ms']}, library_ms {row['library_ms']}, "
              f"bound_ms {row['bound_ms']} ({row['bound_by']})")
    print(json.dumps({"timings": times, "launches_phase_a": launches_a,
                      "metrics_phase_a": metrics}))
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
