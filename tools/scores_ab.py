"""Time the scoring kernels of this checkout against another checkout's
(the parent commit's) on one GPU, in turns: parent, change, change,
parent.

    python3 tools/scores_ab.py --parent DIR [--seed 0]
    python3 tools/scores_ab.py --parent DIR --wrappers [--seed 0]

Without ``--wrappers`` it builds ``DIR/cleverrec_tpu_torch/csrc/
dot_scores.cu`` and this checkout's with ``nvcc`` (``sm_90a``) into
``build/kernels/ab/``, then, at the shapes of ``chip_smoke.py``'s scoring
rows (d 128; u, q, bias and 5% seen bitmaps from ``--seed``), calls each
kernel through its C entry point, without the Python wrapper: ``ms`` is
CUDA events over 20 launches, ``device_ms`` the kernel's own time from
``torch.profiler``.  The change's outputs are held equal to the parent's
element by element.  The SM clock and power draw (``nvidia-smi``, sampled
every 0.2 s) are read over each version's 100 launches.  The parent's
entry points take no ``tile``, ``vec`` or ``sms`` argument; this
checkout's take ``scores._scores_tile``, 16-byte staging and the card's
SM count.

With ``--wrappers`` it times each checkout's Python wrapper
``ops.scores.dot_scores`` at the shapes where a call is short (A, 256
users, and E, phase A's 1,024-user eval batches, both x 1,682 items), one
process per turn that imports that checkout's package (and builds its
kernels there): ``ms`` is CUDA events over 200 calls, ``host_us`` the
host's time to issue one of the same calls, ``device_ms`` the kernel's
own time; ``checksum`` (the float64 sum of the unmasked scores) shows
that both give the same scores.

Prints one JSON line per (kernel, shape, version, turn), then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "kernels", "ab")
D = 128
SHAPES = {"A": (256, 1682), "E": (1024, 1682), "B": (1024, 103523),
          "N": (1024, 4096), "H": (1024, 593231)}
RUNS = {"dot_scores": ("A", "E", "B", "N"), "dot_gmax": ("B",),
        "dot_topk_scores": ("H",)}
WRAPPER_SHAPES = ("A", "E")
TURNS = ("parent", "change", "change", "parent")
P, I = ctypes.c_void_p, ctypes.c_int


def compile_all(sources: dict) -> dict:
    """{version: loaded library}, one nvcc per source, all at once."""
    from cleverrec_tpu_torch.ops import build
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for tag, src in sources.items():
        lib = os.path.join(OUT, f"libdot_scores_{tag}.so")
        procs[tag] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        libs[tag] = ctypes.CDLL(lib)
    return libs


def inputs(b, n_items, gen):
    u = torch.randn(b, D, generator=gen).cuda()
    q = torch.randn(n_items, D, generator=gen).cuda()
    bias = torch.randn(n_items, generator=gen).cuda()
    w = -(-n_items // 32)
    seen = torch.zeros(b, w * 32, dtype=torch.bool, device="cuda")
    seen[:, :n_items] = torch.rand(b, n_items, device="cuda") < 0.05
    weights = torch.ones(32, dtype=torch.int64, device="cuda") << torch.arange(
        32, device="cuda")
    words = (seen.view(b, w, 32).long() * weights).sum(dim=2)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return u, q, words.to(torch.int32).contiguous(), bias


def launcher(lib, tag, name, u, q, bits, bias):
    """(launch(), outputs) of entry point ``name`` of ``lib``."""
    from cleverrec_tpu_torch.ops import scores
    b, n_items = u.shape[0], q.shape[0]
    w = bits.shape[1]
    if name == "dot_topk_scores":
        i_pad = -(-n_items // 4096) * 4096
        outs = [torch.empty(b, i_pad, device="cuda"),
                torch.empty(b, i_pad // 32, device="cuda")]
    else:
        width = n_items if name == "dot_scores" else w
        outs = [torch.empty(b, width, device="cuda")]
    own = []
    if tag == "change" and name == "dot_scores":
        sms = scores._sms(u.device.index)
        own = [scores._scores_tile(b, n_items, sms), 1, sms]
    elif tag == "change" and name == "dot_topk_scores":
        own = [1]
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [P] * (4 + len(outs)) + [I] * (4 + len(own)) + [P]
    args = (u.data_ptr(), q.data_ptr(), bits.data_ptr(), bias.data_ptr(),
            *(t.data_ptr() for t in outs), b, n_items, D, w, *own,
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{tag} {name}: cudaError {err}")
    return launch, outs


def timed(fn, iters=20):
    """(ms, host_us) over the same ``iters`` calls after 3 warm-up calls:
    CUDA events from before the first call to after the last, per call,
    and the host's time to issue one call."""
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


def profiled_ms(fn, iters=20):
    """The kernel's device time a launch, from torch.profiler over the
    launches the trace holds (it may miss the first ones)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "dot_" in e.key]
    launches = sum(e.count for e in events)
    if launches == 0:
        return None
    return sum(e.self_device_time_total for e in events) / 1e3 / launches


class Clocks:
    """Samples the SM clock (MHz) and power draw (W) with nvidia-smi in a
    thread while its block runs."""

    def __enter__(self):
        import threading
        self.samples, self.stop = [], threading.Event()

        def sample():
            while not self.stop.is_set():
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True).stdout.split(",")
                if len(out) == 2:
                    self.samples.append((float(out[0]), float(out[1])))
                self.stop.wait(0.2)
        self.thread = threading.Thread(target=sample)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()

    def summary(self) -> dict:
        if not self.samples:
            return {"sm_mhz": None, "power_w": None}
        mhz, watts = zip(*self.samples)
        return {"sm_mhz": sorted(mhz)[len(mhz) // 2],
                "power_w": sorted(watts)[len(watts) // 2]}


def kernels(parent: str, seed: int) -> bool:
    """The C entry points of both checkouts, in turns; True if every
    output of the change equals the parent's."""
    rel = os.path.join("cleverrec_tpu_torch", "csrc", "dot_scores.cu")
    libs = compile_all({"parent": os.path.join(parent, rel),
                        "change": os.path.join(ROOT, rel)})
    gen = torch.Generator().manual_seed(seed)
    torch.cuda.manual_seed(seed)
    ok = True
    for shape in ("A", "E", "N", "B", "H"):
        b, n_items = SHAPES[shape]
        data = inputs(b, n_items, gen)
        for name, at in RUNS.items():
            if shape not in at:
                continue
            runs = {tag: launcher(libs[tag], tag, name, *data)
                    for tag in libs}
            for turn, tag in enumerate(TURNS):
                launch, _ = runs[tag]
                with Clocks() as clocks:
                    long_ms = timed(launch, iters=100)[0]
                print(json.dumps({"kernel": name, "shape": shape, "B": b,
                                  "I": n_items, "d": D, "version": tag,
                                  "turn": turn, "ms": timed(launch)[0],
                                  "device_ms": profiled_ms(launch),
                                  "ms_100": long_ms, **clocks.summary()}),
                      flush=True)
            torch.cuda.synchronize()
            diff = max((x - y).abs().max().item() for x, y in
                       zip(runs["parent"][1], runs["change"][1]))
            ok &= diff == 0.0
            print(json.dumps({"kernel": name, "shape": shape,
                              "max_abs_diff": diff}), flush=True)
            del runs
        del data
        torch.cuda.empty_cache()
    return ok


def time_wrapper(tree: str, seed: int) -> None:
    """One turn of ``--wrappers``: ``tree``'s ``dot_scores`` wrapper at
    ``WRAPPER_SHAPES``, a JSON line each."""
    sys.path.insert(0, tree)
    from cleverrec_tpu_torch.ops import scores
    gen = torch.Generator().manual_seed(seed)
    torch.cuda.manual_seed(seed)
    for shape in WRAPPER_SHAPES:
        b, n_items = SHAPES[shape]
        u, q, bits, bias = inputs(b, n_items, gen)
        out = scores.dot_scores(u, q, bits, bias)
        kept = out[out != scores.NEG].double().sum().item()
        ms, host_us = timed(lambda: scores.dot_scores(u, q, bits), iters=200)
        print(json.dumps({"kernel": "dot_scores", "shape": shape, "B": b,
                          "I": n_items, "d": D, "ms": ms, "host_us": host_us,
                          "device_ms": profiled_ms(
                              lambda: scores.dot_scores(u, q, bits)),
                          "checksum": kept}), flush=True)


def wrappers(parent: str, seed: int) -> bool:
    """Both checkouts' wrappers in turns, a process each; True if both
    give the same checksums."""
    sums = {}
    for turn, tag in enumerate(TURNS):
        tree = parent if tag == "parent" else ROOT
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent", parent,
             "--time-wrapper", tree, "--seed", str(seed)],
            capture_output=True, text=True, check=True).stdout
        for line in out.splitlines():
            rec = json.loads(line)
            sums.setdefault(rec["shape"], set()).add(rec["checksum"])
            print(json.dumps({**rec, "version": tag, "turn": turn}),
                  flush=True)
    return all(len(s) == 1 for s in sums.values())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--wrappers", action="store_true")
    parser.add_argument("--time-wrapper", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("scores_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.time_wrapper:
        time_wrapper(args.time_wrapper, args.seed)
        return 0
    sys.path.insert(0, ROOT)
    ok = (wrappers if args.wrappers else kernels)(
        os.path.abspath(args.parent), args.seed)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
