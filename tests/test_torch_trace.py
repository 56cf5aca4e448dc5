"""The port's spans (``utils/trace.py``): nothing without a profiler; with
one, each span a profiler range and a record on the profiler's clock,
nested as the profiler nests them, in a bounded buffer; and the trainer,
the evaluator, the retrieval function and its export give what they give
without one."""

import collections
import io
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cleverrec_tpu_torch import ranking
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.sampling import build_member_table
from cleverrec_tpu_torch.serving import build_retrieval_fn, export_retrieval
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.utils import trace
from cleverrec_tpu_torch.weights import load_params
from tests.conftest import make_toy_interactions

# A program record's start against its profiler event's (the same clock,
# read a few microseconds apart).
CLOCK_NS = 1_000_000
K = 5


def _profiled(fn):
    """(fn()'s result, the profiler's ``cleverrec.*`` events as (name,
    start ns, end ns) in start order, the records the run added)."""
    last = max((r.id for r in trace.records()), default=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(trace.PREFIX)),
                    key=lambda e: (e[1], -e[2]))
    return out, events, [r for r in trace.records() if r.id > last]


def _nesting(intervals) -> list:
    """The index of each interval's innermost enclosing one, or None."""
    out = []
    for k, (s, e) in enumerate(intervals):
        outer = [j for j in range(k) if intervals[j][0] <= s
                 and e <= intervals[j][1]]
        out.append(outer[-1] if outer else None)
    return out


def _nested_spans():
    with trace.span("a"):
        with trace.span("a.b"):
            torch.ones(8).sum()
        with trace.span("a.c"):
            with trace.span("a.c.d"):
                torch.ones(8).sum()
    with trace.span("e"):
        torch.ones(8).sum()


def test_off_without_a_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: calls.append(a) or real(*a))
    before = [r.id for r in trace.records()]
    _nested_spans()
    assert calls == []
    assert [r.id for r in trace.records()] == before
    assert trace.span("x") is trace.span("y")


def test_records_match_the_profiler_events():
    # The profiler's first range in a process pays its own set-up.
    _profiled(_nested_spans)
    _, events, recs = _profiled(_nested_spans)
    assert [trace.PREFIX + r.name for r in recs] == [n for n, _, _ in events]
    assert [r.name for r in recs] == ["a", "a.b", "a.c", "a.c.d", "e"]
    for r, (_, s, e) in zip(recs, events):
        assert abs(r.start_ns - s) < CLOCK_NS
        assert abs(r.end_ns - e) < CLOCK_NS
    ids = [r.id for r in recs]
    parents = [None if p is None else ids[p]
               for p in _nesting([(s, e) for _, s, e in events])]
    assert [r.parent for r in recs] == parents
    a, b, c, d, e = recs
    assert [r.root for r in recs] == [a.id] * 4 + [e.id]
    assert (b.parent, c.parent, d.parent) == (a.id, a.id, c.id)
    assert a.parent is None and e.parent is None


def test_the_buffer_keeps_the_newest_records(monkeypatch):
    assert trace._buffer.maxlen == trace.LIMIT == 2 ** 20
    monkeypatch.setattr(trace, "_buffer", collections.deque(maxlen=4))

    def many():
        for n in range(10):
            with trace.span(f"s{n}"):
                pass
    _profiled(many)
    assert [r.name for r in trace.records()] == ["s6", "s7", "s8", "s9"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """BPR on the toy dataset's random split, full-catalog evaluation."""
    root = tmp_path_factory.mktemp("trace")
    (root / "toy").mkdir()
    make_toy_interactions(root / "toy" / "ratings.csv")
    values = {
        "recommender": "BPR", "model_type": "ranking",
        "data.root_dir": str(root), "data.dataset": "toy",
        "data.file_name": "ratings.csv", "data.sep": ",",
        "data.format": "UIRT", "data.split_way": "rs",
        "data.split_ratio": "[0.7,0.2,0.1]", "data.split_by_time": "False",
        "data.user_min": "0", "data.item_min": "0",
        "test.neg_samples": "0", "test.batch_size": "8", "topk": "[5,10]",
        "epoches": "1", "batch_size": "64", "embed_size": "16",
        "reg": "0.01", "lr": "0.01", "neg_ratio": "2", "optimizer": "Adam",
        "is_pairwise": "True", "loss_func": "bpr", "init_method": "normal",
        "stddev": "0.1", "seed": "7"}
    return types.SimpleNamespace(values=values,
                                 data=load_ranking_data(Config(values)))


def _model(toy, **over):
    cfg = Config({**toy.values, **over})
    model = make_model(cfg, DataMeta(toy.data.user_nums, toy.data.item_nums),
                       device="cpu")
    rng = np.random.default_rng(3)
    load_params(model, {k: rng.normal(size=tuple(p.shape)).astype(np.float32)
                        for k, p in model.named_parameters()})
    return cfg, model


def _tree(recs) -> list:
    """Each record as (name, its parent's name, its root's name)."""
    by_id = {r.id: r for r in recs}
    return [(r.name, by_id[r.parent].name if r.parent else None,
             by_id[r.root].name) for r in recs]


def test_an_epoch_is_the_same_with_its_spans(toy):
    def epoch():
        cfg, model = _model(toy)
        tr = Trainer(model, toy.data, cfg, device="cpu")
        params, opt = tr.init_state(7)
        _, _, loss = tr.train_epoch(params, opt)
        return loss, {k: p.detach().clone() for k, p in params.items()}

    want_loss, want = epoch()
    (loss, got), _, recs = _profiled(epoch)
    assert loss == want_loss
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    tree = _tree(recs)
    assert tree[0] == ("train.epoch", None, "train.epoch")
    assert tree[1] == ("train.sample", "train.epoch", "train.epoch")
    steps = [t for t in tree if t[0] == "train.step"]
    assert steps and set(steps) == {("train.step", "train.epoch",
                                     "train.epoch")}
    assert len(steps) + 2 == len(tree)


@pytest.mark.parametrize("fused", ["False", "True"])
def test_an_evaluation_is_the_same_with_its_spans(toy, fused):
    cfg, model = _model(toy, **{"eval.fused_kernel": fused})
    ev = Evaluator(model, build_device_data(toy.data), cfg, device="cpu")
    assert ev.mode == ("full_fused" if fused == "True" else "full")
    want = ev.evaluate()
    got, _, recs = _profiled(ev.evaluate)
    assert got == want
    tree = _tree(recs)
    n_batches = ev._batches["u"].shape[0]
    assert tree[0] == ("eval.evaluate", None, "eval.evaluate")
    assert [t[:2] for t in tree].count(("eval.batch", "eval.evaluate")) \
        == n_batches
    assert [t[:2] for t in tree].count(("eval.metrics", "eval.batch")) \
        == n_batches
    ranks = {t[0] for t in tree if t[1] == "eval.batch"} - {"eval.metrics"}
    assert ranks == ({"rank.decompose", "rank.score", "rank.select"}
                     if fused == "True"
                     else {"rank.score", "rank.mask", "rank.select"})
    assert {t[2] for t in tree} == {"eval.evaluate"}


def test_retrieval_is_the_same_with_its_spans(toy):
    _, model = _model(toy)
    fn = build_retrieval_fn(model, {}, build_device_data(toy.data), K,
                            backend="dense", device="cpu")
    users = np.arange(6)
    want = fn(users)
    got, _, recs = _profiled(lambda: fn(users))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert _tree(recs) == [
        ("serve.call", None, "serve.call"),
        ("rank.score", "serve.call", "serve.call"),
        ("rank.mask", "serve.call", "serve.call"),
        ("rank.select", "serve.call", "serve.call")]


def test_the_wide_fused_branch_is_the_same_with_its_spans():
    """A 5,000-item catalog takes ``rank_fused``'s wide branch: the group
    maxes, the rescue and the extraction, each its own span."""
    n_users, n_items = 12, 5000
    rng = np.random.default_rng(5)
    values = {"recommender": "BPR", "embed_size": "16", "reg": "0.01"}
    model = make_model(Config(values), DataMeta(n_users, n_items),
                       device="cpu")
    load_params(model, {
        "P": rng.normal(size=(n_users, 16)).astype(np.float32),
        "Q": rng.normal(size=(n_items, 16)).astype(np.float32)})
    seen = build_member_table({u: rng.choice(n_items, 60, replace=False)
                               .tolist() for u in range(n_users)},
                              n_users, n_items)
    u = torch.arange(n_users)
    bits = torch.as_tensor(seen.bits)[u]

    def rank():
        return ranking.rank_fused(model, {}, u, bits, 20)
    want = rank()
    got, _, recs = _profiled(rank)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [r.name for r in recs] == ["rank.decompose", "rank.score",
                                      "rank.rescue", "rank.extract"]
    assert all(r.parent is None and r.root == r.id for r in recs)


def _graph(blob) -> list:
    program = torch.export.load(io.BytesIO(blob))
    return [(n.op, str(n.target)) for n in program.graph.nodes]


def test_an_export_under_the_profiler_is_unchanged(toy):
    _, model = _model(toy)
    dd = build_device_data(toy.data)

    def export():
        return export_retrieval(model, {}, dd, 4, K, backend="dense",
                                device="cpu")
    want = _graph(export())
    blob, events, recs = _profiled(export)
    assert _graph(blob) == want
    assert not any("record_function" in t or "profiler" in t
                   for _, t in want)
    assert recs == [] and events == []
