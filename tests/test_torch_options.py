"""Options of the JAX package, each as the JAX package takes it: the
evaluator's test bitmaps past the global bitmap budget, the per-step
social samplers, the eval options that select streaming, serving's bf16
rescue (``approx`` on the fused backend); and serving's ``auto``
backend picks dense past the measured crossover and streams past JAX's
threshold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu import ranking as j_ranking
from cleverrec_tpu.config import Config as JConfig
from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.evalx import Evaluator as JEvaluator
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.models.bpr import BPR as JBPR
from cleverrec_tpu_torch import ranking, serving
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import STREAM_THRESHOLD, Evaluator
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.weights import load_params
from tests.conftest import base_config


def _setup(toy, **overrides):
    cfg = Config(base_config(toy, **overrides).to_dict())
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return cfg, data, model


def _past_the_budget(dd):
    """Device data past the global bitmap budget: sorted rows only."""
    return dataclasses.replace(dd, seen=dd.seen._replace(bits=None))


@pytest.mark.parametrize("route,overrides,mode,built_once", [
    ("once", {}, "full_fused", True),
    ("per_batch", {"eval.test_bitmap_budget_mb": "0"}, "full_fused", False),
    ("off", {"eval.device_bitmaps": "False"}, "full", False)])
def test_eval_test_bitmaps_match_jax(toy_dataset, route, overrides, mode,
                                     built_once):
    """Past the global bitmap budget, ``full_fused`` builds the test
    users' bitmaps once (within eval.test_bitmap_budget_mb) or each
    batch's, and eval.device_bitmaps=false falls back to ``full``, each
    as the JAX evaluator; the metrics equal the JAX evaluator's and the
    global bitmaps' run's, and so does the Trainer's Evaluator."""
    values = dict(FULL, **{"eval.fused_kernel": "True",
                           "test.batch_size": "8"}, **overrides)
    cfg, data, model = _setup(toy_dataset, **values)
    jcfg = base_config(toy_dataset, **values)
    jdata = j_load_ranking_data(jcfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    params = jmodel.init(jax.random.PRNGKey(jcfg.seed))
    load_params(model, {k: np.asarray(v) for k, v in params.items()})
    dd = build_device_data(data)
    ev = Evaluator(model, _past_the_budget(dd), cfg, device="cpu")
    jev = JEvaluator(jmodel, _past_the_budget(j_build_device_data(jdata)),
                     jcfg)
    assert ev.mode == jev.mode == mode
    assert ("bits" in ev._batches) == built_once
    assert ev._batches["u"].shape[0] > 1
    want = jev.evaluate(params, {})
    full = Evaluator(model, dd, cfg, device="cpu").evaluate()
    np.testing.assert_array_equal(ev.recommend_topk(),
                                  jev.recommend_topk(params, {}))
    for got in (ev.evaluate(), full):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    assert Trainer(model, data, cfg, device="cpu").steps_per_epoch > 0


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


class _Biased(torch.nn.Module):
    """A dot model with an item bias, the port's side."""

    cml_like = False

    def __init__(self, P, Q, b):
        super().__init__()
        self.P, self.Q, self.b = (torch.nn.Parameter(torch.as_tensor(x))
                                  for x in (P, Q, b))

    def dot_decomposition(self, u, aux):
        return self.P[u], self.Q, self.b


class _JBiased:
    """The same model, the JAX package's side."""

    cml_like = False

    def __init__(self, n_users, n_items):
        self.meta = JMeta(n_users, n_items)

    def dot_decomposition(self, params, u, aux):
        return params["P"][u], params["Q"], params["b"]


@pytest.mark.parametrize("bias", [False, True])
def test_approx_on_the_fused_backend_rescues_in_bf16(bias):
    """``approx`` on the fused backend: the wide branch rescues from a
    bf16 copy of the table (u rounded to bf16, f32 sums, f32 bias), as
    JAX's rank_fused(pre=fused_precompute(rescue_bf16=True)) on a
    9,000-item catalog (12,288 padded): scores within 1e-5, ids equal but
    among ties; the exact rescue differs from it."""
    n_users, n_items, d, b, k = 40, 9000, 16, 8, 5
    rng = np.random.default_rng(3)
    P, Q = (rng.normal(size=(n, d)).astype(np.float32)
            for n in (n_users, n_items))
    bvec = rng.normal(size=n_items).astype(np.float32)
    seen = rng.random((b, n_items)) < 0.05
    bits = np.packbits(np.pad(seen, ((0, 0), (0, -n_items % 32))), axis=1,
                       bitorder="little").view(np.uint32)
    users = np.arange(b, dtype=np.int32)
    if bias:
        jmodel, params = _JBiased(n_users, n_items), {"P": P, "Q": Q,
                                                      "b": bvec}
        model = _Biased(P, Q, bvec)
    else:
        values = {"recommender": "BPR", "embed_size": str(d), "reg": "0.01"}
        jmodel, params = JBPR(JConfig(values), JMeta(n_users, n_items)), \
            {"P": P, "Q": Q}
        model = make_model(Config(values), DataMeta(n_users, n_items),
                           device="cpu")
        load_params(model, params)
    params = {key: jnp.asarray(v) for key, v in params.items()}
    want_v, want_i = (np.asarray(x) for x in j_ranking.rank_fused(
        jmodel, params, {}, jnp.asarray(users), jnp.asarray(bits), k,
        interpret=True, pre=j_ranking.fused_precompute(
            jmodel, params, {}, rescue_bf16=True)))
    u_t = torch.as_tensor(users).long()
    bits_t = torch.as_tensor(bits.view(np.int32))
    pre = ranking.fused_precompute(model, {}, rescue_bf16=True)
    assert pre[2].dtype == torch.bfloat16
    got_v, got_i = (x.numpy() for x in ranking.rank_fused(
        model, {}, u_t, bits_t, k, pre=pre))
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5, atol=1e-5)
    for r, j in zip(*np.nonzero(got_i != want_i)):
        assert (np.abs(np.delete(got_v[r], j) - got_v[r, j]) <= 1e-5).any()
    exact_v, _ = ranking.rank_fused(model, {}, u_t, bits_t, k,
                                    pre=ranking.fused_precompute(model, {}))
    assert not np.array_equal(exact_v.numpy(), got_v)
    assert not seen[np.arange(b)[:, None], got_i].any()


def test_approx_on_the_fused_backend_serves(toy_dataset):
    """``build_retrieval_fn(backend="fused", approx=True)`` serves; on the
    narrow branch (the toy's catalog) the answer is the exact one."""
    cfg, data, model = _setup(toy_dataset, **FULL)
    dd = build_device_data(data)
    users = np.arange(dd.user_nums)
    approx = serving.build_retrieval_fn(model, {}, dd, backend="fused",
                                        approx=True, device="cpu")
    exact = serving.build_retrieval_fn(model, {}, dd, backend="fused",
                                       device="cpu")
    assert approx.backend == "fused"
    for a, e in zip(approx(users), exact(users)):
        np.testing.assert_array_equal(a.numpy(), e.numpy())
    retrieve = serving.build_retrieval_fn(model, {}, dd, backend="stream",
                                          approx=True, device="cpu")
    assert retrieve.backend == "stream"
