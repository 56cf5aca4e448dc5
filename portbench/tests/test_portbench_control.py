"""``correct`` comes out false where it must: with the reference put in
the port's place at the precision below the configured one (the
control), and with the port's timed path broken underneath (each fault
that a cell's kind can have).  Each run skips the harness's look for a
card and drives the rest of a run at a test's size, on the CPU where
the fault shows there."""

import pytest
import torch

import cleverrec_tpu_torch.ranking as port_ranking
from cleverrec_tpu_torch import evalx
from cleverrec_tpu_torch.models.gcn import LightGCN
from cleverrec_tpu_torch.ops import train as port_train
from cleverrec_tpu_torch.train import trainer as port_trainer

TRAIN = ["bpr-amazonbook.train", "lightgcn-gowalla.train"]
SERVE, EVAL = "bpr-amazonbook.serve", "lightgcn-gowalla.eval"
SATURATED = "bpr-amazonbook.serve-saturated"


@pytest.mark.parametrize("cell", TRAIN + [SERVE, SATURATED, EVAL])
def test_the_port_is_correct(run_small, cell):
    out = run_small(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1


@pytest.mark.parametrize("cell", TRAIN)
def test_control_in_bfloat16_is_not_correct(run_small, cell):
    out = run_small(cell, replace="control")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [SERVE, EVAL])
def test_control_in_tf32_is_not_correct(run_small, card, cell):
    # TF32 exists on the card alone: on the CPU a float32 product is exact
    # float32 either way.
    out = run_small(cell, device=card, replace="control")
    assert not out["correct"], out["checks"]


def _frozen_bpr(real):
    def epoch(p, q, mp, vp, mq, vq, *rest, **kw):
        return real(*(t.clone() for t in (p, q, mp, vp, mq, vq)), *rest, **kw)
    return epoch


def _half_bpr(real):
    def epoch(p, q, mp, vp, mq, vq, u, i, j, t0, **kw):
        h = u.shape[1] // 2
        u, i, j = u.clone(), i.clone(), j.clone()
        # Ids outside the tables read zero rows and take no gradient.
        u[:, h:], i[:, h:], j[:, h:] = p.shape[0], q.shape[0], q.shape[0]
        return 2 * real(p, q, mp, vp, mq, vq, u, i, j, t0, **kw)
    return epoch


def _each_step_first_bpr(real):
    # Every step of a launch corrected as the launch's first: a launch
    # that runs its steps after the first wrong, which one-step launches
    # never show.
    def epoch(p, q, mp, vp, mq, vq, u, i, j, t0, **kw):
        return sum(real(p, q, mp, vp, mq, vq, u[s:s + 1], i[s:s + 1],
                        j[s:s + 1], t0, **kw) for s in range(u.shape[0]))
    return epoch


def _still_optimizer(name, lr):
    real = _MAKE_OPTIMIZER(name, lr)
    return real._replace(update=lambda params, grads, state: state)


_MAKE_OPTIMIZER = port_trainer.make_optimizer


def _half_loss(self, batch, aux):
    h = batch["u"].shape[0] // 2
    part = {k: v[:h] if torch.is_tensor(v) else v for k, v in batch.items()}
    return 2 * _LIGHTGCN_LOSS(self, part, aux)


_LIGHTGCN_LOSS = LightGCN.loss


@pytest.mark.parametrize("fault", ["unchanged", "half", "each_step_first"])
def test_bpr_epoch_faults_are_not_correct(run_small, monkeypatch, fault):
    wrap = {"unchanged": _frozen_bpr, "half": _half_bpr,
            "each_step_first": _each_step_first_bpr}[fault]
    monkeypatch.setitem(port_train.EPOCH_FNS, "bpr",
                        wrap(port_train.EPOCH_FNS["bpr"]))
    out = run_small(TRAIN[0])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_lightgcn_step_faults_are_not_correct(run_small, monkeypatch, fault):
    if fault == "unchanged":
        monkeypatch.setattr(port_trainer, "make_optimizer", _still_optimizer)
    else:
        monkeypatch.setattr(LightGCN, "loss", _half_loss)
    out = run_small(TRAIN[1])
    assert not out["correct"], out["checks"]


def _altered(real):
    def rank(*args, **kw):
        v, items = real(*args, **kw)
        items = items.clone()
        items[:, 0] = (items[:, 0] + 1) % args[0].meta.item_nums
        return v, items
    return rank


def _half_answered(real):
    def rank(model, aux, u, *rest, **kw):
        h = u.shape[0] // 2
        v, items = real(model, aux, u, *rest, **kw)
        v, items = v.clone(), items.clone()
        v[h:2 * h], items[h:2 * h] = v[:h], items[:h]
        return v, items
    return rank


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_serving_faults_are_not_correct(run_small, monkeypatch, fault):
    wrap = {"altered": _altered, "half": _half_answered}[fault]
    monkeypatch.setattr(port_ranking, "rank_dense",
                        wrap(port_ranking.rank_dense))
    out = run_small(SERVE)
    assert not out["correct"], out["checks"]


def _half_metrics(real):
    def sums(self, rec, real_ids, row_w):
        h = rec.shape[0] // 2
        return 2 * real(self, rec[:h], real_ids[:h], row_w[:h])
    return sums


def test_evaluation_answer_altered_is_not_correct(run_small, monkeypatch):
    monkeypatch.setattr(port_ranking, "rank_fused",
                        _altered(port_ranking.rank_fused))
    out = run_small(EVAL)
    assert not out["correct"], out["checks"]


def test_evaluation_half_of_the_batch_is_not_correct(run_small, monkeypatch):
    monkeypatch.setattr(evalx.Evaluator, "_metric_sums",
                        _half_metrics(evalx.Evaluator._metric_sums))
    out = run_small(EVAL)
    assert not out["correct"], out["checks"]


def test_the_saturated_cell_issues_each_call_when_the_last_is_back():
    from portbench import harness, synth
    from portbench.kinds import KINDS
    from portbench.tests.conftest import small
    import tempfile
    _, conf, mix = small(SATURATED)
    assert "calls_per_s" not in mix
    with tempfile.TemporaryDirectory() as root:
        kind = KINDS["serve"](conf, mix, "cpu",
                              synth.ensure(conf["dataset"], root))
        kind.build()
        kind.reseed(5)
        kind.prepare()
        units, _ = harness.window(kind, 0.2, False)
    assert len(units) >= 2
    for u in units:
        assert u["work"]["latency_s"] == u["work"]["service_s"]
