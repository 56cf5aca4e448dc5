"""The readers of the device's idle time under the port's spans
(``portbench/spans.py``, ``layer_metrics/*_idle_ms.*.py``) on a made-up
run: device records and program records by hand, one span outside the
traced window, one span with no record, a port that keeps no spans."""

import sys
import types

import pytest
import torch

from portbench import harness, spans

# Device records (ns): two that overlap, one inside, one past the window.
DEVICE = [("k", 1000, 3000), ("k", 2500, 4000), ("k", 6000, 7000),
          ("k", 9000, 12000)]
WINDOW, UNITS = (1000, 11000), 2


def rec(name, s, e):
    return types.SimpleNamespace(name=name, start_ns=s, end_ns=e)


PROGRAM = [
    rec("train.sample", 500, 5000),      # starts before the window
    rec("train.step", 0, 900),           # wholly before it
    rec("train.step", 4500, 6500),
    rec("train.step", 6500, 8000),       # abuts the one before
    rec("rank.decompose", 12000, 13000),  # wholly after it
    rec("rank.extract", 8500, 10000),
    rec("eval.metrics", 10500, 11500),   # runs past its end, busy all along
]
# Idle ns in the window under each span (None: no span in the window).
IDLE_NS = {"train_idle_ms.sample": 1000, "train_idle_ms.step": 2500,
           "eval_idle_ms.extract": 500, "eval_idle_ms.metrics": 0,
           "eval_idle_ms.decompose": None, "serve_idle_ms.call": None}


def made_up_run(trace=True):
    tr = {"device": DEVICE, "spans": [], "window": WINDOW,
          "units": UNITS} if trace else None
    return harness.Run("eval", [], 1.0, 0.0, {}, None, tr)


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: PROGRAM)


@pytest.mark.parametrize("name", sorted(IDLE_NS))
def test_each_reader_gives_its_idle_ms(program, name):
    got = harness.module("layer_metrics", name).read(made_up_run())
    want = IDLE_NS[name]
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want / 1e6 / UNITS, abs=1e-15)


@pytest.mark.parametrize("name", sorted(IDLE_NS))
def test_no_trace_or_no_spans_reads_nothing(monkeypatch, name):
    reader = harness.module("layer_metrics", name).read
    monkeypatch.setattr(spans, "program_records", lambda: PROGRAM)
    assert reader(made_up_run(trace=False)) is None
    monkeypatch.setattr(spans, "program_records", lambda: [])
    assert reader(made_up_run()) is None


def test_the_readers_are_in_the_benchmark():
    """Each reader lies in ``layer_metrics`` under its metric's name, where
    the harness finds a declared metric's reader."""
    for name in IDLE_NS:
        assert harness.check_name(name) == name
        assert callable(harness.module("layer_metrics", name).read)


def test_a_port_without_spans_gives_no_records(monkeypatch):
    # A port that lacks the span module (None in sys.modules and no such
    # attribute on its package: its import fails) keeps no spans, and
    # every reader then reads nothing.
    import cleverrec_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "cleverrec_tpu_torch.utils.trace", None)
    assert spans.program_records() == []
    for name in IDLE_NS:
        assert harness.module("layer_metrics", name).read(
            made_up_run()) is None


def test_the_port_records_its_spans_under_the_profiler():
    from cleverrec_tpu_torch.utils import trace
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("serve.call"):
            torch.ones(4).sum()
    last = spans.program_records()[-1]
    assert last.name == "serve.call" and last.start_ns < last.end_ns


def test_overlap_of_interval_lists():
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap_ns([], [(0, 5)]) == 0
