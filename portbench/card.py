"""The card: its peaks, its name and power limit, clocks and traces.

Copied from ``chip_smoke.py`` (``PEAK_FP32``, ``PEAK_BYTES``, ``bound`` as
``least_time``, ``breakdown``), with one repair: ``breakdown`` summed the
durations of the profiler's device records, so overlapping records hid
idle time; ``busy_ns`` and ``breakdown`` here take the union of the
records' intervals.  Nothing here imports the port.
"""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM data sheet (dense, no sparsity, at the full 700 W): FP32
# outside the tensor cores, and HBM3 bandwidth.  Every configuration
# computes in FP32 with TF32 off, so FP32 is the peak that applies.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def least_time(work: dict) -> tuple[float, str]:
    """(seconds, what bounds it) of work {"flops", "bytes"}: the larger of
    its operations at the FP32 peak and its bytes at the HBM peak."""
    t_ops = work["flops"] / PEAK_FP32
    t_bytes = work["bytes"] / PEAK_BYTES
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(event, f"{what}_us")()
                                                 * 1000)


def trace(fn, prefix: str) -> dict:
    """Run fn() under torch.profiler (host and device activity) and keep
    the device records (name, start ns, end ns) and the host spans whose
    names start with ``prefix`` (``torch.profiler.record_function``), on
    the profiler's one clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + int(e.duration_ns())
        if e.name().startswith(prefix):
            # A host span is also mirrored on the device's timeline as a
            # user annotation; only the host's copy is kept.
            if e.device_type() != DeviceType.CUDA:
                spans.append((e.name(), start, end))
        elif e.device_type() == DeviceType.CUDA and not (
                hasattr(e, "is_user_annotation") and e.is_user_annotation()):
            device.append((e.name(), start, end))
    return {"device": device, "spans": spans}


def union(intervals) -> list[tuple[int, int]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def busy_ns(device, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) in which some device record ran."""
    return sum(e - s for s, e in clip(union((s, e) for _, s, e in device),
                                      lo, hi))


def breakdown(device, spans, lo: int, hi: int, top: int = 10) -> dict:
    """The device operations that took most time in [lo, hi) (summed by
    name) and the longest idle gaps, each named by the innermost host span
    open at its middle; seconds."""
    by_name: dict[str, int] = {}
    for name, s, e in device:
        for cs, ce in clip([(s, e)], lo, hi):
            by_name[name] = by_name.get(name, 0) + ce - cs
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    busy = clip(union((s, e) for _, s, e in device), lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(mid):
        open_ = [(s, name) for name, s, e in spans if s <= mid < e]
        return max(open_)[1] if open_ else "no span"

    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[label((s + e) // 2), (e - s) / 1e9]
                          for s, e in gaps[:top]]}
