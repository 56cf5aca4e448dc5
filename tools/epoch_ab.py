"""Time the BPR, GMF and CML epoch kernels (``bpr_epoch``, ``gmf_epoch``,
``cml_epoch``) of this checkout against another checkout's (the parent
commit's) on one GPU, in turns: parent, change, change, parent; or, with
``--phases``, where a block of this checkout's persistent kernels spends
its cycles.

    python3 tools/epoch_ab.py --parent DIR
    python3 tools/epoch_ab.py --phases

The inputs are made once, by this checkout, at the shapes of
``chip_smoke.py``'s phases C, E and G: ml-100k rebuilt from the repo, BPR
(the default recipe: embed 128, B 6,144, 65 steps), GMF (embed 64, B
6,144, 81 steps) and CML (embed 128, K 20, B 6,144, 17 steps) at their
confs and seeds, each the state one epoch in and the next epoch's draw
(``chip_smoke.one_epoch_in``), into ``build/epoch_ab/inputs.pt``.  Each
turn is a process that imports one checkout's package, which builds that
checkout's ``csrc/bpr_epoch.cu``, ``csrc/gmf_epoch.cu`` and
``csrc/cml_epoch.cu`` on first use, and for each input:

- holds the kernel to its plain version over the epoch with that
  checkout's ``chip_smoke.hold``, at the smoke's tolerances;
- times whole epochs: ``ms`` is CUDA events over 5 epochs, a mean;
  ``device_ms`` the device time of one epoch by kernel name
  (torch.profiler over 3 epochs), with their sum, and ``launches`` each
  kernel's launches an epoch.

Prints one JSON line per (input, version, turn), then the card's name and
power limit; exits 1 if any hold failed.

``--phases`` builds this checkout's three sources with
``-DPERSIST_CLOCKS`` (nvcc, ``sm_90a``) into ``build/kernels/phases/``:
thread 0 of each block then adds up the ``clock64()`` cycles of each part
of every step (phase A's two parts, the wait at the barrier after it,
phase B, the wait after B).  It runs one epoch of each input through the
port's wrapper, and prints a JSON line each: the cycles a step of each
part, the median and the largest over the blocks, the epoch's ms (CUDA
events over 20 epochs, the clocks' build), and the time of one grid
barrier at the kernel's grid (a launch of 2,000 barriers and nothing
else, less a launch of none, CUDA events), the kernels' own barrier and
cooperative_groups' ``grid.sync()`` in turns (ours, cg, cg, ours).  Then
the card's name, power limit and SM clock (``nvidia-smi``), at which
cycles become time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("parent", "change", "change", "parent")
INPUTS = os.path.join(ROOT, "build", "epoch_ab", "inputs.pt")
KERNELS = {"BPR": "bpr_epoch", "GMF": "gmf_epoch", "CML": "cml_epoch"}
# csrc/persist.cuh's PERSIST_PHASES: the parts of a step each kernel stamps.
PARTS = {"BPR": ("slots", "loss into part_loss", "barrier after A",
                 "phase B", "barrier after B"),
         "GMF": ("slots", "dh and loss into the slices", "barrier after A",
                 "phase B", "barrier after B"),
         "CML": ("rows", "column sums from the slices", "barrier after A",
                 "phase B", "barrier after B")}


def make_inputs() -> None:
    """Every input of the turns, into INPUTS (this checkout's trainer)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cleverrec_tpu_torch.ops import train as T
    cs.write_ml100k()
    out = []
    for name in KERNELS:
        cfg, data, model, trainer, params, state, draw = cs.one_epoch_in(name)
        tables = ("P", "Q", "h_gmf") if name == "GMF" else ("P", "Q")
        rec = {"model": name, "t0": state.count,
               "state": [params[n].detach().cpu().clone() for n in tables]
               + [t[n].cpu().clone() for n in tables
                  for t in (state.mu, state.nu)],
               "opts": {"lr": cfg.lr, "reg": model.reg}}
        if name == "BPR":
            rec["ids"] = [x.cpu() for x in cs.sentinel_ids(data, draw,
                                                           ("u", "i", "j"))]
        elif name == "GMF":
            rec["ids"] = [x.cpu() for x in cs.sentinel_ids(data, draw,
                                                           ("u", "i"))]
            rec["ids"].append(draw["y"].contiguous().cpu())
        else:
            u, i = cs.sentinel_ids(data, draw, ("u", "i"))
            i_sent = T.sentinel_dims(data.user_nums, data.item_nums)[1] - 1
            negs = torch.where(draw["w"][..., None] == 0, i_sent,
                               draw["negs"]).to(torch.int32).contiguous()
            rec["ids"] = [u.cpu(), i.cpu(), negs.cpu()]
            rec["opts"].update(margin=model.margin,
                               item_nums=data.item_nums)
        out.append(rec)
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    torch.save(out, INPUTS)


def epoch_fns(T, rec):
    """(kernel epoch, plain epoch) of one input: each takes the state."""
    ids = [x.cuda() for x in rec["ids"]]
    if rec["model"] == "BPR":
        return (lambda st: T.fused_bpr_epoch(*st, *ids, rec["t0"],
                                             **rec["opts"]),
                lambda st: T.fused_bpr_epoch_ref(*st, *ids, rec["t0"],
                                                 **rec["opts"]))
    if rec["model"] == "GMF":
        return (lambda st: T.fused_gmf_epoch(*st, *ids, rec["t0"],
                                             **rec["opts"]),
                lambda st: T.fused_gmf_epoch_ref(*st, *ids, rec["t0"],
                                                 **rec["opts"]))
    return (lambda st: T.fused_cml_epoch(*st, *ids, rec["t0"], **rec["opts"]),
            lambda st: T.fused_cml_epoch_ref(*st, *ids, rec["t0"],
                                             **rec["opts"]))


def by_kernel(fn, calls: int = 3):
    """(device ms, launches) of one fn() call by kernel name
    (torch.profiler over ``calls`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms, count = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            key = re.match(r"(?:void )?([\w:]*)", name).group(1)
            key = key.split("::")[-1] or name[:40]
            ms[key] = ms.get(key, 0.0) + e.self_device_time_total / 1e3 / calls
            count[key] = count.get(key, 0) + e.count / calls
    return ms, count


def time_tree(tree: str) -> None:
    """One turn: ``tree``'s kernels on every input, a JSON line each."""
    sys.path[:0] = [tree]
    import chip_smoke as cs
    from cleverrec_tpu_torch.ops import train as T
    for rec in torch.load(INPUTS):
        kernel, plain = epoch_fns(T, rec)
        got = [x.cuda() for x in rec["state"]]
        want = [x.cuda() for x in rec["state"]]
        loss, ref = kernel(got), plain(want)
        torch.cuda.synchronize()
        loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
        try:
            errors = cs.hold(rec["model"], zip(map(str, range(99)), got, want),
                             cs.EPOCH_ATOL, cs.EPOCH_RTOL)
            held = loss_rel <= cs.EPOCH_LOSS_RTOL or f"loss {loss_rel}"
        except cs.SmokeError as e:
            errors, held = {}, str(e)
        state = [x.cuda() for x in rec["state"]]
        ms, count = by_kernel(lambda: kernel(state))
        print(json.dumps({
            "model": rec["model"], "held": held,
            "max_err": max(errors.values(), default=None),
            "loss_rel_err": loss_rel,
            "ms": cs.timed(lambda: kernel(state), iters=5)[0],
            "device_ms": sum(ms.values()), "by_kernel": ms,
            "launches": count}), flush=True)


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def phases() -> int:
    """This checkout's persistent kernels built with -DPERSIST_CLOCKS: the
    cycles of a step's parts and one barrier's time, a JSON line an
    input."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cleverrec_tpu_torch.ops import build
    from cleverrec_tpu_torch.ops import train as T
    make_inputs()
    out = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out, exist_ok=True)
    libs, procs = {}, []
    for name in KERNELS.values():
        src = build.paths(name)[0]
        lib = os.path.join(out, f"lib{name}.so")
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-DPERSIST_CLOCKS", "-o", lib,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for name, lib, p in procs:
        log = p.communicate()[0]
        if p.returncode != 0:
            print(log.decode(), file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(lib)
    build.load = lambda name: libs[name]     # the wrapper loads the probe build
    bar = torch.zeros(2, dtype=torch.int32, device="cuda")
    for rec in torch.load(INPUTS):
        name = KERNELS[rec["model"]]
        lib = libs[name]
        kernel, _ = epoch_fns(T, rec)
        state = [x.cuda() for x in rec["state"]]
        kernel(state)
        torch.cuda.synchronize()
        cycles = np.zeros((1024, len(PARTS["GMF"])), np.int64)
        err = lib.persist_read_clocks(cycles.ctypes.data_as(ctypes.c_void_p))
        if err != 0:
            raise RuntimeError(f"persist_read_clocks: cudaError {err}")
        per_sm, threads = next(v for k, v in T._per_sm.items()
                               if k[0] == name)
        blocks = per_sm * torch.cuda.get_device_properties(
            0).multi_processor_count
        steps = rec["ids"][0].shape[0]
        c = cycles[:min(blocks, 1024)] / steps
        probe = lib.persist_barrier_probe
        probe.restype = ctypes.c_int
        probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        stream = torch.cuda.current_stream().cuda_stream

        def barriers(n, cg):
            return lambda: probe(bar.data_ptr(), blocks, threads, n, cg,
                                 stream)
        # The kernels' barrier, then cooperative_groups' grid.sync(), in
        # turns: ours, cg, cg, ours.
        barrier_us = {"ours": [], "cg": []}
        for cg in (0, 1, 1, 0):
            t_many = cs.timed(barriers(2000, cg), iters=5)[0]
            t_none = cs.timed(barriers(0, cg), iters=5)[0]
            barrier_us["cg" if cg else "ours"].append(
                (t_many - t_none) / 2000 * 1e3)
        parts = PARTS[rec["model"]]
        print(json.dumps({
            "model": rec["model"], "blocks": blocks, "threads": threads,
            "steps": steps,
            "ms": cs.timed(lambda: kernel(state), iters=20)[0],
            "cycles_a_step": {n: {"median": float(np.median(c[:, k])),
                                  "max": float(c[:, k].max())}
                              for k, n in enumerate(parts)},
            "barrier_us": barrier_us,
            "launch_of_no_barrier_ms": t_none}), flush=True)
    print(smi("name,power.limit,clocks.sm"))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent")
    parser.add_argument("--phases", action="store_true")
    parser.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("epoch_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.phases:
        return phases()
    if args.time_tree:
        time_tree(args.time_tree)
        return 0
    if not args.parent:
        parser.error("--parent DIR or --phases")
    make_inputs()
    parent = os.path.abspath(args.parent)
    ok = True
    for turn, tag in enumerate(TURNS):
        tree = parent if tag == "parent" else ROOT
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-tree", tree],
            capture_output=True, text=True)
        if run.returncode != 0:
            print(f"epoch_ab: the {tag} turn failed:\n{run.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        for line in run.stdout.splitlines():
            rec = json.loads(line)
            ok &= rec["held"] is True
            print(json.dumps({**rec, "version": tag, "turn": turn}),
                  flush=True)
    print(smi("name,power.limit"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
