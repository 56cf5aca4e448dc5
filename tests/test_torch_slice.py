"""The whole serving/eval slice against the JAX package: toy data through
both loaders, JAX BPR's init parameters carried into the port, then
retrieval (dense, fused, stream), rerank and the Evaluator's candidate,
full, full_fused and full_stream modes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.evalx import Evaluator as JEvaluator
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.serving import build_rerank_fn as j_build_rerank_fn
from cleverrec_tpu.serving import build_retrieval_fn as j_build_retrieval_fn
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.serving import build_rerank_fn, build_retrieval_fn
from cleverrec_tpu_torch.weights import load_params
from tests.conftest import base_config

# Metric means are float32 sums over the same ranked lists, taken in
# another order.
METRIC_TOL = 1e-6
# BPR scores are f32 dots of width 16 of N(0, 0.01^2) tables (~1e-4).
SCORE_TOL = 1e-9

FULL = {"data.split_way": "rs", "test.neg_samples": "0",
        "data.split_by_time": "True"}


def _both(toy, **overrides):
    jcfg = base_config(toy, **overrides)
    cfg = Config(jcfg.to_dict())
    jdata, data = j_load_ranking_data(jcfg), load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    params = jmodel.init(jax.random.PRNGKey(jcfg.seed))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    load_params(model, {k: np.asarray(v) for k, v in params.items()})
    return ((jcfg, jmodel, params, j_build_device_data(jdata)),
            (cfg, model, build_device_data(data)))


def _without_bitmaps(dd):
    """The device data of a catalog past the bitmap budget: sorted seen
    rows only, so the fused path builds each batch's bitmaps."""
    return dataclasses.replace(dd, seen=dd.seen._replace(bits=None))


@pytest.mark.parametrize("backend,seen", [
    ("dense", "bits"), ("fused", "bits"), ("fused", "rows"),
    ("dense", "unfiltered"), ("fused", "unfiltered"), ("stream", "bits"),
    ("stream", "rows"), ("stream", "unfiltered")])
def test_retrieval_matches_jax(toy_dataset, backend, seen):
    (_, jmodel, params, jdd), (_, model, dd) = _both(toy_dataset, **FULL)
    if seen == "rows":
        dd = _without_bitmaps(dd)
    filter_seen = seen != "unfiltered"
    users = np.arange(dd.user_nums, dtype=np.int32)
    want_i, want_v = j_build_retrieval_fn(jmodel, params, {}, jdd, k=5,
                                          filter_seen=filter_seen,
                                          backend=backend)(users)
    retrieve = build_retrieval_fn(model, {}, dd, k=5, backend=backend,
                                  filter_seen=filter_seen, device="cpu")
    assert retrieve.backend == backend
    got_i, got_v = retrieve(users)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=SCORE_TOL)
    # The CPU picks the plain dense path; CUDA picks the kernels.
    assert build_retrieval_fn(model, {}, dd, k=5,
                              device="cpu").backend == "dense"


def test_rerank_matches_jax(toy_dataset):
    (_, jmodel, params, _), (_, model, dd) = _both(toy_dataset, **FULL)
    rng = np.random.default_rng(0)
    users = np.arange(10, dtype=np.int32)
    cand = rng.integers(0, dd.item_nums, (10, 12)).astype(np.int32)
    cand[:, 9:] = -1                                # padding never surfaces
    cand[0, 3:] = -1                                # fewer than k real
    want_i, want_v = j_build_rerank_fn(jmodel, params, {}, k=5)(
        jnp.asarray(users), jnp.asarray(cand))
    got_i, got_v = build_rerank_fn(model, {}, k=5, device="cpu")(users, cand)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=SCORE_TOL)
    assert (got_i.numpy()[0, 3:] == -1).all()


@pytest.mark.parametrize("mode,overrides,bitmaps", [
    ("candidate", {}, True),
    ("candidate", {"data.split_way": "rs", "test.neg_samples": "10"}, True),
    ("full", dict(FULL, **{"eval.fused_kernel": "False"}), True),
    ("full_fused", dict(FULL, **{"eval.fused_kernel": "True"}), True),
    ("full_fused", dict(FULL, **{"eval.fused_kernel": "True"}), False),
    ("full_stream", dict(FULL, **{"eval.stream": "True"}), True),
    ("full_stream", dict(FULL, **{"eval.stream": "True"}), False),
    # Chunks of no whole bitmap words: rank_stream masks with the rows.
    ("full_stream", dict(FULL, **{"eval.stream": "True",
                                  "eval.stream_chunk": "24"}), True),
])
def test_evaluator_matches_jax(toy_dataset, mode, overrides, bitmaps):
    (jcfg, jmodel, params, jdd), (cfg, model, dd) = _both(
        toy_dataset, **overrides)
    if not bitmaps:
        dd = _without_bitmaps(dd)
    jev = JEvaluator(jmodel, jdd, jcfg)
    ev = Evaluator(model, dd, cfg, device="cpu")
    assert ev.mode == jev.mode == mode
    np.testing.assert_array_equal(ev.recommend_topk(),
                                  jev.recommend_topk(params, {}))
    want = jev.evaluate(params, {})
    for got in (ev.evaluate(), ev.evaluate_host()):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=METRIC_TOL)
