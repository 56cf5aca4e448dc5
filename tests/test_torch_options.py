"""Options and rules of the JAX package that the port does not follow yet
refuse instead of passing silently, each naming its ROADMAP item, and
the per-step social samplers, once refused, train; the eval options that
select streaming select the JAX evaluator's mode; and serving's ``auto``
backend picks dense past the measured crossover and streams past JAX's
threshold."""

import dataclasses

import pytest
import torch

from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.evalx import Evaluator as JEvaluator
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu_torch import serving
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import STREAM_THRESHOLD, Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.train import Trainer
from tests.conftest import base_config


def _setup(toy, **overrides):
    cfg = Config(base_config(toy, **overrides).to_dict())
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return cfg, data, model


@pytest.mark.parametrize("key,value,item", [
    ("eval.device_bitmaps", "False", "item 7"),
    ("eval.test_bitmap_budget_mb", "64", "item 7")])
def test_eval_options_not_ported_raise(toy_dataset, key, value, item):
    cfg, data, model = _setup(toy_dataset, **{key: value})
    for make in (lambda: Evaluator(model, build_device_data(data), cfg,
                                   device="cpu"),
                 lambda: Trainer(model, data, cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match=f"{key}.*{item}"):
            make()


def test_per_step_social_samplers_train(toy_social_dataset):
    """``train.sbpr_epoch_tensors=False`` is ported: SBPR and TBPR train
    on the per-step samplers (no static epoch layout), on both tiers; its
    default, and the explicit default, keep the epoch tensors."""
    for name in ("SBPR", "TBPR"):
        for fused in ("False", "True"):
            cfg, data, model = _setup(
                toy_social_dataset, recommender=name,
                social_file="trusts.csv", lr="0.05",
                **{"train.sbpr_epoch_tensors": "False",
                   "train.fused_kernel": fused})
            tr = Trainer(model, data, cfg, device="cpu")
            assert tr._per_step and tr._static == {}
            assert tr.fused == (fused == "True")
            params, state = tr.init_state()
            params, state, losses = tr.train_epochs(params, state, 3)
            assert losses[-1] < losses[0], (name, fused, losses)
            assert state.count == 3 * tr.steps_per_epoch
    for value in (None, "True"):
        extra = {} if value is None else {"train.sbpr_epoch_tensors": value}
        cfg, data, model = _setup(toy_social_dataset, recommender="SBPR",
                                  social_file="trusts.csv", **extra)
        tr = Trainer(model, data, cfg, device="cpu")
        assert not tr._per_step and "ord_spuoff" in tr._static


FULL = {"data.split_way": "rs", "test.neg_samples": "0"}


def _modes(toy, items=None, **overrides):
    """(port mode, JAX mode, port Evaluator) for one config, each
    evaluator's device data widened to ``items`` if given."""
    cfg, data, model = _setup(toy, **overrides)
    jcfg = base_config(toy, **overrides)
    jdata = j_load_ranking_data(jcfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    dd, jdd = build_device_data(data), j_build_device_data(jdata)
    if items is not None:
        dd = dataclasses.replace(dd, item_nums=items)
        jdd = dataclasses.replace(jdd, item_nums=items)
    ev = Evaluator(model, dd, cfg, device="cpu")
    return ev.mode, JEvaluator(jmodel, jdd, jcfg).mode, ev


@pytest.mark.parametrize("key,value,mode", [
    ("eval.stream", "True", "full_stream"),
    ("eval.stream_threshold", "10", "full_stream"),
    ("eval.stream_chunk", "4096", "full")])
def test_eval_stream_options_select_the_jax_mode(toy_dataset, key, value,
                                                 mode):
    """Each option is honoured as the JAX evaluator honours it, by the
    Evaluator and by the Trainer that builds one."""
    got, want, ev = _modes(toy_dataset, **FULL, **{key: value})
    assert got == want == mode
    if key == "eval.stream_chunk":
        assert ev.stream_chunk == 4096
    cfg, data, model = _setup(toy_dataset, **FULL, **{key: value})
    assert Trainer(model, data, cfg, device="cpu").steps_per_epoch > 0


def test_full_catalog_eval_past_the_stream_threshold_streams(toy_dataset):
    """Past 500,000 items a full-catalog eval streams by default, in
    chunks of 16384, unless eval.fused_kernel or eval.stream=false is
    set; candidate lists never stream.  Each as the JAX evaluator."""
    assert _modes(toy_dataset, **FULL)[:2] == ("full", "full")
    got, want, ev = _modes(toy_dataset, STREAM_THRESHOLD + 1, **FULL)
    assert got == want == "full_stream" and ev.stream_chunk == 16384
    assert _modes(toy_dataset, STREAM_THRESHOLD, **FULL)[:2] == (
        "full", "full")
    for key, value, mode in (("eval.fused_kernel", "True", "full_fused"),
                             ("eval.stream", "False", "full")):
        got, want, _ = _modes(toy_dataset, STREAM_THRESHOLD + 1, **FULL,
                              **{key: value})
        assert got == want == mode
    got, want, _ = _modes(toy_dataset, STREAM_THRESHOLD + 1)
    assert got == want == "candidate"


def test_auto_backend_picks_dense_past_the_crossover():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    limit, stream = serving.FUSED_MAX_ITEMS, serving.STREAM_THRESHOLD
    assert limit < stream == 131072
    for name, items, want in (
            ("BPR", 1682, "fused"),         # chip_smoke phase A
            ("BPR", limit, "fused"), ("BPR", limit + 1, "dense"),
            ("BPR", 103_523, "dense"),      # chip_smoke phase B
            ("BPR", stream, "dense"), ("BPR", stream + 1, "stream"),
            ("BPR", 593_231, "stream"),     # chip_smoke phase H
            ("GMF", 1682, "fused"), ("MLP", 1682, "dense"),
            ("MLP", stream + 1, "stream"),
            ("CML", 1682, "fused"), ("LRML", 1682, "dense")):
        cfg = Config({"recommender": name, "embed_size": "8", "reg": "0.01",
                      "reg1": "0.01", "reg2": "0.01", "layers": "[8,4]",
                      "margin": "0.5", "mem_size": "4"})
        model = make_model(cfg, DataMeta(4, items), device="cpu")
        assert serving._pick_backend(model, cuda) == want, (name, items)
        assert serving._pick_backend(model, cpu) == (
            "stream" if items > stream else "dense")


def test_approx_on_the_fused_backend_raises(toy_dataset):
    cfg, data, model = _setup(toy_dataset, **FULL)
    dd = build_device_data(data)
    with pytest.raises(NotImplementedError, match="item 7"):
        serving.build_retrieval_fn(model, {}, dd, backend="fused",
                                   approx=True, device="cpu")
    retrieve = serving.build_retrieval_fn(model, {}, dd, backend="stream",
                                          approx=True, device="cpu")
    assert retrieve.backend == "stream"
