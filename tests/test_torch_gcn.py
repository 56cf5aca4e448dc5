"""LightGCN and NGCF in the port against the JAX package: the graph's
dense and edge forms (with duplicate edges), propagation, losses and
gradients in both forms, the scorers, one scan epoch on JAX's own
draws, NGCF's message dropout (its statistics, and that scoring never
drops), LightGCN's dot decomposition through the fused rankers' plain
versions, an NGCF resume equal to the uninterrupted run, and the
training loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import gcn as j_gcn
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import ranking
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import gcn, make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.serving import build_retrieval_fn
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.checkpoint import load_checkpoint
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config, make_toy_interactions

MODELS = ("LightGCN", "NGCF")
FORMS = ("dense", "edge")
# The confs (Adam, bpr, neg_ratio 1) cut to the toy: embed 16, 2 layers;
# stddev 0.1 so that the layers' products are not flat.  NGCF's parity
# runs without dropout: the port cannot draw jax.random's bits.
TRAIN = {"epoches": "2", "batch_size": "64", "embed_size": "16",
         "n_layers": "2", "reg": "0.01", "lr": "0.01", "neg_ratio": "1",
         "stddev": "0.1", "message_dropout": "0"}
# Losses and scores, port against JAX: f32 sums of width 16 and of the
# graph's rows in another order.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
# One scan epoch, port against JAX (tests/test_fused_train.py:95-106).
EPOCH_LOSS_RTOL = 1e-4
EPOCH_RTOL, EPOCH_ATOL = 1e-3, 1e-5


def _np(x):
    return np.asarray(x)


@pytest.fixture
def dup_dataset(tmp_path):
    """The toy dataset with 60 of its rows repeated: (u, i) pairs that
    emit their edge more than once."""
    ds = tmp_path / "toydup"
    ds.mkdir()
    make_toy_interactions(ds / "ratings.csv")
    lines = (ds / "ratings.csv").read_text().splitlines()
    rng = np.random.default_rng(1)
    extra = [lines[1 + k] for k in rng.integers(0, len(lines) - 1, 60)]
    (ds / "ratings.csv").write_text("\n".join(lines + extra) + "\n")
    return {"root": str(tmp_path), "name": "toydup"}


def _form(form):
    return {"graph.dense_budget_mb": "0"} if form == "edge" else {}


def _both(toy, name, **overrides):
    jcfg = base_config(toy, **{**TRAIN, "recommender": name, **overrides})
    cfg = Config(jcfg.to_dict())
    jdata, data = j_load_ranking_data(jcfg), load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return (jcfg, jdata, jmodel), (cfg, data, model)


def _aux(jmodel, jdata, model, data):
    j_aux = {k: jnp.asarray(v) for k, v in jmodel.build_aux(
        j_build_device_data(jdata), jdata).items()}
    aux = {k: torch.as_tensor(v) for k, v in model.build_aux(
        build_device_data(data), data).items()}
    return j_aux, aux


def _params(jmodel, model, seed):
    params = jmodel.init(jax.random.PRNGKey(seed))
    load_params(model, {k: _np(v) for k, v in params.items()})
    return params


@pytest.mark.parametrize("form", FORMS)
def test_graph_aux_matches_jax_with_duplicate_edges(dup_dataset, form):
    """The bipartite edges and the dense A_hat equal JAX's exactly; a
    repeated pair sums in both forms, and the two forms are one
    operator."""
    (jcfg, jdata, _), (cfg, data, _) = _both(dup_dataset, "LightGCN",
                                             **_form(form))
    jdd, dd = j_build_device_data(jdata), build_device_data(data)
    n_pairs = len(dd.pos_u)
    assert n_pairs > len(set(zip(dd.pos_u.tolist(), dd.pos_i.tolist())))
    for got, want in zip(gcn._bipartite_edges(dd, data.user_nums,
                                              data.item_nums),
                         j_gcn._bipartite_edges(jdd, jdata.user_nums,
                                                jdata.item_nums)):
        np.testing.assert_array_equal(got, want)
    got = gcn._graph_aux(dd, data.user_nums, data.item_nums, cfg)
    want = j_gcn._graph_aux(jdd, jdata.user_nums, jdata.item_nums, jcfg)
    assert sorted(got) == sorted(want) == (
        ["g_dense"] if form == "dense" else ["g_col", "g_row", "g_w"])
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    n = data.user_nums + data.item_nums
    ego = torch.as_tensor(np.random.default_rng(0).normal(
        size=(n, 5)).astype(np.float32))
    rows, cols, w = gcn._bipartite_edges(dd, data.user_nums, data.item_nums)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (rows, cols), w)
    out = gcn._adj_apply({k: torch.as_tensor(v) for k, v in got.items()},
                         ego)
    np.testing.assert_allclose(out.numpy(), dense @ ego.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_parameters_match_jax(toy_dataset, name):
    (_, _, jmodel), (_, data, model) = _both(toy_dataset, name)
    params = jmodel.init(jax.random.PRNGKey(0))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(v.shape) for n, v in params.items()}
    assert list(got) == list(params)
    assert got["P"] == (data.user_nums, 16) and got["Q"] == (data.item_nums,
                                                              16)
    assert model.sampler == "pairwise" and model.fused_protocol is None
    assert hasattr(model, "dot_decomposition") == (name == "LightGCN")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", MODELS)
def test_propagation_loss_and_grads_match_jax(dup_dataset, name, form):
    (_, jdata, jmodel), (_, data, model) = _both(dup_dataset, name,
                                                 **_form(form))
    params = _params(jmodel, model, 3)
    j_aux, aux = _aux(jmodel, jdata, model, data)
    for got, want in zip(model._propagate(aux),
                         jmodel._propagate(params, j_aux)):
        np.testing.assert_allclose(got.detach().numpy(), _np(want),
                                   rtol=SCORE_RTOL, atol=SCORE_ATOL)
    rng = np.random.default_rng(4)
    n = 40
    batch = {"u": rng.integers(0, data.user_nums, n).astype(np.int32),
             "i": rng.integers(0, data.item_nums, n).astype(np.int32),
             "j": rng.integers(0, data.item_nums, n).astype(np.int32),
             "w": (rng.random(n) < 0.8).astype(np.float32)}
    want, grads = jax.value_and_grad(jmodel.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, j_aux)
    loss = model.loss({k: torch.as_tensor(v) for k, v in batch.items()}, aux)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(grads[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_scores_match_jax(toy_dataset, name):
    (_, jdata, jmodel), (_, data, model) = _both(toy_dataset, name)
    params = _params(jmodel, model, 5)
    j_aux, aux = _aux(jmodel, jdata, model, data)
    rng = np.random.default_rng(9)
    u = rng.integers(0, data.user_nums, 12).astype(np.int32)
    i = rng.integers(0, data.item_nums, 12).astype(np.int32)
    cand = rng.integers(0, data.item_nums, (12, 7)).astype(np.int32)
    tu = torch.as_tensor(u).long()

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)

    with torch.no_grad():
        close(model.score_pairs(tu, torch.as_tensor(i).long(), aux),
              jmodel.score_pairs(params, jnp.asarray(u), jnp.asarray(i),
                                 j_aux))
        close(model.score_candidates(tu, torch.as_tensor(cand).long(), aux),
              jmodel.score_candidates(params, jnp.asarray(u),
                                      jnp.asarray(cand), j_aux))
        close(model.score_all(tu, aux),
              jmodel.score_all(params, jnp.asarray(u), j_aux))
        if name == "LightGCN":
            got = model.dot_decomposition(tu, aux)
            want = jmodel.dot_decomposition(params, jnp.asarray(u), j_aux)
            close(got[0], want[0])
            close(got[1], want[1])
            assert got[2] is None and want[2] is None


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", MODELS)
def test_scan_epoch_on_jax_draws_matches_jax(toy_dataset, name, form):
    """One scan epoch from JAX's parameters and Adam state one epoch in,
    on JAX's sampled batches: parameters, moments and loss."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(toy_dataset, name,
                                                      **_form(form))
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    assert not tr.fused and tr._grid is None and tr._buckets is None
    assert tr.steps_per_epoch == j_tr.steps_per_epoch
    p0, o0 = j_tr.init_state()
    p0, o0, _ = j_tr.train_epoch(p0, o0)
    p0 = {k: np.array(v) for k, v in p0.items()}
    count = o0[0].count
    mu, nu = ({k: np.array(v) for k, v in m.items()}
              for m in (o0[0].mu, o0[0].nu))
    build_xs, run_scan = j_tr._scan_parts[:2]
    xs = build_xs(jax.random.PRNGKey(7), j_tr.arrays)
    want_p, want_o, losses = run_scan(
        {k: jnp.asarray(v) for k, v in p0.items()}, o0, xs, j_tr.arrays,
        lambda batch: batch)
    load_params(model, p0)
    state = adam_state_from_jax(count, mu, nu, "cpu", model=model)
    got_p, got_o, loss = tr._run_epoch(
        dict(model.named_parameters()), state,
        {k: torch.as_tensor(np.array(v)) for k, v in xs[0].items()})
    assert float(loss) == pytest.approx(float(jnp.mean(losses)),
                                        rel=EPOCH_LOSS_RTOL)
    for k in p0:
        for got, want in ((got_p[k].detach(), want_p[k]),
                          (got_o.mu[k], want_o[0].mu[k]),
                          (got_o.nu[k], want_o[0].nu[k])):
            np.testing.assert_allclose(got.numpy(), _np(want),
                                       rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                       err_msg=k)


def _ngcf_one_layer(toy, p):
    (_, _, _), (cfg, data, model) = _both(toy, "NGCF",
                                          message_dropout=str(p),
                                          n_layers="1")
    model.init(torch.Generator().manual_seed(2))
    aux = {k: torch.as_tensor(v) for k, v in model.build_aux(
        build_device_data(data), data).items()}
    return data, model, aux


def test_ngcf_dropout_keeps_and_scales(toy_dataset):
    """Over a seeded draw, a layer's activations are kept where the draw
    is below 1 - p and scaled by 1/(1 - p) before the normalisation
    (the layer written out by hand here); the kept share is 1 - p within
    four standard errors."""
    p = 0.3
    data, model, aux = _ngcf_one_layer(toy_dataset, p)
    ego = torch.cat([model.P, model.Q]).detach()
    a_hat = aux["g_dense"]
    agg = a_hat @ ego
    act = torch.nn.functional.leaky_relu(
        (agg + ego) @ model.W1_0.detach() + model.b1_0.detach()
        + (agg * ego) @ model.W2_0.detach() + model.b2_0.detach(), 0.2)
    keep = torch.rand(act.shape, generator=torch.Generator().manual_seed(5)
                      ) < 1.0 - p
    x = torch.where(keep, act / (1.0 - p), torch.zeros_like(act))
    want = x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + 1e-12)
    with torch.no_grad():
        got = torch.cat(model._propagate(aux, torch.Generator().manual_seed(
            5)))
    d = model.embed_size
    np.testing.assert_allclose(got[:, :d].numpy(), ego.numpy())
    np.testing.assert_allclose(got[:, d:].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        kept = torch.stack([torch.cat(model._propagate(aux, gen))[:, d:] != 0
                            for _ in range(20)])
    share, n = kept.float().mean().item(), kept.numel()
    assert abs(share - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n), share


def test_ngcf_scoring_never_drops(toy_dataset):
    """Every scorer runs without the dropout: the same scores twice, and
    those of the model at p = 0."""
    data, model, aux = _ngcf_one_layer(toy_dataset, 0.5)
    u = torch.arange(data.user_nums)
    i = torch.arange(data.user_nums) % data.item_nums
    cand = torch.arange(data.item_nums)[None, :6].expand(data.user_nums, -1)
    with torch.no_grad():
        runs = []
        for p in (0.5, 0.5, 0.0):
            model.message_dropout = p
            runs.append((model.score_all(u, aux), model.score_pairs(u, i, aux),
                         model.score_candidates(u, cand, aux)))
    for got in runs[1:]:
        for a, b in zip(runs[0], got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("form", FORMS)
def test_lightgcn_fused_ranking_equals_dense(toy_dataset, form):
    """The dot decomposition through the fused rankers' plain versions
    ranks as score_all does: full_fused eval equals full, and fused
    retrieval equals dense."""
    cfg = Config(base_config(toy_dataset, **{
        **TRAIN, "recommender": "LightGCN", "test.neg_samples": "0",
        "data.split_way": "rs", **_form(form)}).to_dict())
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = tr.init_state()
    tr.train_epochs(params, state, 2)
    fused = Evaluator(model, tr.dd, cfg.with_overrides(
        **{"eval.fused_kernel": "True"}), device="cpu")
    full = Evaluator(model, tr.dd, cfg, device="cpu")
    assert (fused.mode, full.mode) == ("full_fused", "full")
    got, want = fused.evaluate(tr.aux), full.evaluate(tr.aux)
    for k in cfg.topk:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    users = np.arange(data.user_nums)
    items = {}
    for backend in ("fused", "dense"):
        fn = build_retrieval_fn(model, tr.aux, tr.dd, k=5, backend=backend,
                                device="cpu")
        items[backend] = fn(users)
    np.testing.assert_allclose(items["fused"][1].numpy(),
                               items["dense"][1].numpy(), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(items["fused"][0], items["dense"][0])
    u = torch.as_tensor(users)
    uv, table, bias = model.dot_decomposition(u, tr.aux)
    assert bias is None and table.is_contiguous()
    with torch.no_grad():
        np.testing.assert_allclose((uv @ table.T).numpy(),
                                   model.score_all(u, tr.aux).numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert ranking.fused_precompute(model, tr.aux)[1] is None


def test_ngcf_resume_equals_the_whole_run(toy_dataset, tmp_path):
    """NGCF with dropout, 2 epochs saved and resumed to 4, against 4 in
    one run: equal on the CPU, the dropout generator being in the
    checkpoint."""
    (_, _, _), (cfg, data, model) = _both(toy_dataset, "NGCF",
                                          message_dropout="0.2")
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = tr.init_state()
    params, state, _ = tr.train_epochs(params, state, 2)
    ckpt = tr.save(str(tmp_path / "NGCF"), params, state, 2)
    assert "dropout" in load_checkpoint(ckpt)["rng"]
    params, state, _ = tr.train_epochs(params, state, 2)
    whole = {k: v.detach().clone() for k, v in params.items()}
    again = Trainer(model, data, cfg, device="cpu")
    params, state, epoch = again.resume(ckpt)
    assert epoch == 2
    params, state, _ = again.train_epochs(params, state, 2)
    for k, v in params.items():
        assert torch.equal(v.detach(), whole[k]), k


@pytest.mark.parametrize("name", MODELS)
def test_trains_and_evaluates(toy_dataset, name):
    """Both models train on the scan tier (NGCF with its conf's dropout)
    and evaluate: the loss falls, the metrics are finite."""
    over = {"message_dropout": "0.1"} if name == "NGCF" else {}
    (_, _, _), (cfg, data, model) = _both(toy_dataset, name, **over)
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = tr.init_state()
    params, state, losses = tr.train_epochs(params, state, 3)
    assert losses[-1] < losses[0], losses
    for hr, mrr, ndcg in tr.evaluate().values():
        assert 0.0 <= hr <= 1.0 and np.isfinite(ndcg)
