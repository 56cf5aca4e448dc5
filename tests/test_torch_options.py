"""Options and rules of the JAX package that the port does not follow yet
refuse instead of passing silently, each naming its ROADMAP item; and
serving's ``auto`` backend picks dense past the measured crossover."""

import dataclasses

import pytest
import torch

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
    ("eval.stream", "True", "item 5"),
    ("eval.stream_threshold", "1000", "item 5"),
    ("eval.stream_chunk", "4096", "item 5"),
    ("eval.device_bitmaps", "False", "item 7"),
    ("eval.test_bitmap_budget_mb", "64", "item 7")])
def test_eval_options_not_ported_raise(toy_dataset, key, value, item):
    cfg, data, model = _setup(toy_dataset, **{key: value})
    for make in (lambda: Evaluator(model, build_device_data(data), cfg,
                                   device="cpu"),
                 lambda: Trainer(model, data, cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match=f"{key}.*{item}"):
            make()


def test_per_step_social_samplers_not_ported_raise(toy_social_dataset):
    cfg, data, model = _setup(toy_social_dataset, recommender="SBPR",
                              social_file="trusts.csv",
                              **{"train.sbpr_epoch_tensors": "False"})
    with pytest.raises(NotImplementedError,
                       match="train.sbpr_epoch_tensors.*item 9"):
        Trainer(model, data, cfg, device="cpu")
    # Its default, and the explicit default, train as before.
    for value in (None, "True"):
        extra = {} if value is None else {"train.sbpr_epoch_tensors": value}
        cfg, data, model = _setup(toy_social_dataset, recommender="SBPR",
                                  social_file="trusts.csv", **extra)
        assert Trainer(model, data, cfg, device="cpu").steps_per_epoch > 0


def test_full_catalog_eval_past_the_stream_threshold_raises(toy_dataset):
    """Where the JAX evaluator would stream (past 500,000 items, unless
    eval.fused_kernel or eval.stream=false is set), the port raises
    instead of building the whole [B, I] score matrix."""
    cfg, data, model = _setup(toy_dataset, **{"data.split_way": "rs",
                                              "test.neg_samples": "0"})
    dd = build_device_data(data)
    assert dd.cand is None and dd.item_nums <= STREAM_THRESHOLD
    assert Evaluator(model, dd, cfg, device="cpu").mode == "full"
    wide = dataclasses.replace(dd, item_nums=STREAM_THRESHOLD + 1)
    with pytest.raises(NotImplementedError, match="item 5"):
        Evaluator(model, wide, cfg, device="cpu")
    for key, value, mode in (("eval.fused_kernel", "True", "full_fused"),
                             ("eval.stream", "False", "full")):
        ev = Evaluator(model, wide, cfg.with_overrides(**{key: value}),
                       device="cpu")
        assert ev.mode == mode
    # Candidate lists never stream.
    cfg, data, model = _setup(toy_dataset)
    cand = dataclasses.replace(build_device_data(data),
                               item_nums=STREAM_THRESHOLD + 1)
    assert Evaluator(model, cand, cfg, device="cpu").mode == "candidate"


def test_auto_backend_picks_dense_past_the_crossover():
    cuda = torch.device("cuda")
    limit = serving.FUSED_MAX_ITEMS
    for name, items, want in (
            ("BPR", 1682, "fused"),         # chip_smoke phase A
            ("BPR", limit, "fused"), ("BPR", limit + 1, "dense"),
            ("BPR", 103_523, "dense"),      # chip_smoke phase B
            ("GMF", 1682, "fused"), ("MLP", 1682, "dense"),
            ("CML", 1682, "fused"), ("LRML", 1682, "dense")):
        cfg = Config({"recommender": name, "embed_size": "8", "reg": "0.01",
                      "reg1": "0.01", "reg2": "0.01", "layers": "[8,4]",
                      "margin": "0.5", "mem_size": "4"})
        model = make_model(cfg, DataMeta(4, items), device="cpu")
        assert serving._pick_backend(model, cuda) == want, (name, items)
        assert serving._pick_backend(model, torch.device("cpu")) == "dense"
