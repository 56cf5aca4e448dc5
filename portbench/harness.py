"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell's configuration and traffic mix and
the metrics it reports.  Each is found by its name:

- a configuration: ``configs/<name>.json`` (the port's conf as it is
  run, the dataset's statistics) and ``configs/<name>.py`` (the work
  counts of its timed units);
- the model a configuration runs: ``recommenders/<recommender>.py``
  (its parameters' shapes and draw, its plain reference, its training
  control's precision, what the port's fused tier counts for a padding
  slot);
- a traffic mix: ``traffic/<name>.json``, the parameters that the kind
  it names (``kinds.KINDS``) reads;
- an end-to-end metric: ``end_to_end/<name>.py``; a per-layer metric:
  ``layer_metrics/<name>.py``; each a ``read(run)`` that returns the
  number, or None where it finds nothing to read;
- the limits of the numbers that decide ``correct``: ``limits/<cell>.json``.

A later change adds a configuration, a model, a mix, a metric or a cell
by adding files and entries; it edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import time

from portbench import card, synth
from portbench.kinds import KINDS, SPAN, sync

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = SPAN + "unit"
TRACE_TRIES = 3


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_bench(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, cell: str) -> dict:
    check_name(cell)
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json("configs", f"{check_name(name)}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{check_name(name)}.json")


def limits(cell: str) -> dict:
    return _json("limits", f"{check_name(cell)}.json")


def module(folder: str, name: str):
    """``<folder>/<name>.py`` as a module (names hold dots and dashes)."""
    path = os.path.join(HERE, folder, f"{check_name(name)}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (untraced) or per-layer ones."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


class Run:
    """What a run's readers read: the window's units (their host seconds,
    spans and work), the traced units' device records, and the sizes
    and work counts of the configuration."""

    def __init__(self, kind: str, units: list, window_s: float,
                 setup_s: float, shape: dict, work, trace: dict | None):
        self.kind, self.units, self.window_s = kind, units, window_s
        self.setup_s, self.shape, self.trace = setup_s, shape, trace
        self._work = work

    def work(self, name: str) -> dict:
        return getattr(self._work, name)(self.shape)

    def least(self, name: str) -> float:
        return card.least_time(self.work(name))[0]

    def unit_seconds(self) -> list[float]:
        return [u["t1"] - u["t0"] for u in self.units]

    def device(self, pattern: str | None = None) -> list:
        """The traced window's device records, those whose name matches
        ``pattern`` where given."""
        if not self.trace:
            return []
        lo, hi = self.trace["window"]
        rx = re.compile(pattern) if pattern else None
        return [(n, s, e) for n, s, e in self.trace["device"]
                if s < hi and e > lo and (rx is None or rx.search(n))]

    def idle_share(self) -> float | None:
        """1 - (union of device records) / (traced window), in %."""
        if not self.device():
            return None
        lo, hi = self.trace["window"]
        return 100.0 * (1.0 - card.busy_ns(self.trace["device"], lo, hi)
                        / (hi - lo))


def window(kind, seconds: float, traced: bool) -> tuple[list, float]:
    """Units back to back until ``seconds`` have passed; each unit ends
    with its result on the host, so the last one's end is synchronised."""
    sync(kind.device)
    start = time.perf_counter()
    units = []
    while True:
        a = time.perf_counter()
        work = kind.unit(traced)
        b = time.perf_counter()
        units.append({"t0": a - start, "t1": b - start, "work": work,
                      "spans": dict(kind.spans)})
        if b - start >= seconds:
            return units, b - start


def traced_units(kind, n: int) -> dict:
    """``n`` units under the profiler, each inside a ``portbench.unit``
    span; taken again (up to ``TRACE_TRIES`` times) where the profiler
    kept no device record."""
    import torch

    def body():
        for _ in range(n):
            with torch.profiler.record_function(UNIT):
                kind.unit(True)

    for _ in range(TRACE_TRIES):
        tr = card.trace(body, SPAN)
        units = [(s, e) for name, s, e in tr["spans"] if name == UNIT]
        if tr["device"] and units:
            tr["window"] = (min(s for s, _ in units),
                            max(e for _, e in units))
            tr["units"] = len(units)
            return tr
    return {"device": [], "spans": [], "window": (0, 1), "units": 0}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, *, bench: dict | None = None,
             conf: dict | None = None, mix: dict | None = None,
             data_root: str = synth.CACHE,
             replace: str | None = None) -> dict:
    """One run of ``cell``; returns the result line's fields.  ``conf``,
    ``mix`` and ``data_root`` stand in for the cell's own (the tests'
    small sizes); ``replace`` puts the reference in the port's place
    (``control``, or a fault) for what the check judges."""
    import torch
    bench = bench or load_bench()
    w = workload(bench, cell)
    conf = conf or config(w["config"])
    mix = mix or traffic(w["traffic"])
    kind = KINDS[mix["kind"]](conf, mix, device, synth.ensure(
        conf["dataset"], data_root))
    kind.build()
    kind.reseed(seed)
    kind.prepare()
    setup_s = time.perf_counter() - t_start
    units, window_s = window(kind, seconds, trace)
    tr = traced_units(kind, int(mix["trace_units"])) if trace else None
    cuda = kind.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(kind.device) if cuda else 0
    outputs = kind.collect()
    if replace:
        outputs = kind.reference_outputs(replace)
    kind.free()
    numbers = kind.check(outputs)
    bounds = limits(cell)
    correct = set(numbers) == set(bounds) and all(
        numbers[n] <= bounds[n] for n in bounds)
    run = Run(mix["kind"], units, window_s, setup_s, kind.shape(),
              module("configs", w["config"]), tr)
    metrics, missing = {}, []
    for m in metrics_of(bench, cell, trace):
        folder = "layer_metrics" if trace else "end_to_end"
        value = module(folder, m["name"]).read(run)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": len(units), "failed": 0,
           "metrics": metrics, "missing": missing,
           "device": {"platform": "gpu" if cuda else kind.device.type,
                      "kind": (torch.cuda.get_device_name(kind.device)
                               if cuda else "cpu"),
                      "count": int(w["chips"]),
                      "memory_peak_bytes": int(peak)},
           "checks": {n: {"value": numbers[n], "limit": bounds.get(n)}
                      for n in numbers}}
    if tr is not None:
        lo, hi = tr["window"]
        out["device"]["busy_s"] = card.busy_ns(tr["device"], lo, hi) / 1e9
        out["device"]["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = card.breakdown(tr["device"], tr["spans"], lo, hi)
    return out

