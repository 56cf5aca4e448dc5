"""DiffNet, DiffNet++ and LR_GCCF in the port against the JAX package: the
mean edges, the parameters, losses and gradients (DiffNet++'s unread
W_l and b_l at zero), the three scorers, one scan epoch on JAX's own
draws, LR_GCCF's dense and edge forms, LR_GCCF's dot decomposition
through the fused rankers' plain versions, and the social file the two
diffusion models need."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import diffnet as j_diffnet
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import ranking
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import diffnet, make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.serving import build_retrieval_fn
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config

MODELS = ("DiffNet", "DiffNetPlusPlus", "LR_GCCF")
# The confs (Adam, bpr; DiffNet and DiffNet++ 2 layers, neg_ratio 4;
# LR_GCCF 3 layers, neg_ratio 1) cut to the toy: embed 16; stddev 0.1 so
# that the layers' products are not flat.
TRAIN = {"epoches": "2", "batch_size": "64", "embed_size": "16",
         "reg": "0.01", "lr": "0.01", "stddev": "0.1",
         "social_file": "trusts.csv"}
CONF = {"DiffNet": {"n_layers": "2", "neg_ratio": "4"},
        "DiffNetPlusPlus": {"n_layers": "2", "neg_ratio": "4"},
        "LR_GCCF": {"n_layers": "3", "neg_ratio": "1"}}
# Losses and scores, port against JAX: f32 sums of width 16 and of the
# edges' rows in another order (index_add against segment_sum).
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
# One scan epoch, port against JAX (tests/test_fused_train.py:95-106).
EPOCH_LOSS_RTOL = 1e-4
EPOCH_RTOL, EPOCH_ATOL = 1e-3, 1e-5


def _np(x):
    return np.asarray(x)


def _both(toy, name, **overrides):
    """Both packages' config, data and model; an override of None drops
    the key."""
    values = {**TRAIN, **CONF[name], "recommender": name, **overrides}
    jcfg = base_config(toy, **{k: v for k, v in values.items()
                               if v is not None})
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


def _form(form):
    return {"graph.dense_budget_mb": "0"} if form == "edge" else {}


def test_mean_edges_match_jax():
    """Repeated sources and a node without edges: the same rows, columns
    and 1/deg weights, array for array, dtypes included."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 9, 60).astype(np.int64)
    a[a == 4] = 5                         # node 4 has no edge
    b = rng.integers(0, 13, 60).astype(np.int64)
    for got, want in zip(diffnet._mean_edges(a, b, 10),
                         j_diffnet._mean_edges(a, b, 10)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ("DiffNet", "DiffNetPlusPlus"))
def test_social_aux_matches_jax(toy_social_dataset, name):
    (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset, name)
    j_aux = jmodel.build_aux(j_build_device_data(jdata), jdata)
    aux = model.build_aux(build_device_data(data), data)
    assert sorted(aux) == sorted(j_aux)
    assert ("i_row" in aux) == (name == "DiffNetPlusPlus")
    for k in aux:
        assert aux[k].dtype == j_aux[k].dtype, k
        np.testing.assert_array_equal(aux[k], j_aux[k], err_msg=k)


@pytest.mark.parametrize("name", ("DiffNet", "DiffNetPlusPlus"))
def test_diffusion_needs_a_social_file(toy_dataset, name):
    """Without social_file both packages refuse to build the edges."""
    (_, jdata, jmodel), (_, data, model) = _both(toy_dataset, name,
                                                 social_file=None)
    assert data.user_friends is None and jdata.user_friends is None
    with pytest.raises(ValueError, match="requires social_file"):
        jmodel.build_aux(j_build_device_data(jdata), jdata)
    with pytest.raises(ValueError, match="requires social_file"):
        model.build_aux(build_device_data(data), data)


@pytest.mark.parametrize("name", MODELS)
def test_parameters_match_jax(toy_social_dataset, name):
    (_, _, jmodel), (_, data, model) = _both(toy_social_dataset, name)
    params = jmodel.init(jax.random.PRNGKey(0))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(v.shape) for n, v in params.items()}
    assert list(got) == list(params)
    assert got["P"] == (data.user_nums, 16) and got["Q"] == (data.item_nums,
                                                              16)
    assert model.sampler == "pairwise" and model.fused_protocol is None
    assert hasattr(model, "dot_decomposition") == (name == "LR_GCCF")
    if name == "DiffNetPlusPlus":
        assert all(torch.equal(model.get_parameter(f"gate_{lid}"),
                               torch.zeros(2)) for lid in range(2))


def _cases():
    return [("DiffNet", "edge"), ("DiffNetPlusPlus", "edge"),
            ("LR_GCCF", "dense"), ("LR_GCCF", "edge")]


@pytest.mark.parametrize("name,form", _cases())
def test_loss_and_grads_match_jax(toy_social_dataset, name, form):
    """The loss and every parameter's gradient; DiffNet++'s W_l and b_l,
    outside its loss, get none in the port and zeros in JAX."""
    (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset, name,
                                                 **_form(form))
    params = _params(jmodel, model, 3)
    if name == "DiffNetPlusPlus":
        # Gates away from 0, so that the softmax weighs its two terms
        # unevenly.
        for lid, g in enumerate(([0.3, -0.4], [-0.2, 0.5])):
            params[f"gate_{lid}"] = jnp.asarray(g, jnp.float32)
            model.get_parameter(f"gate_{lid}").data.copy_(torch.tensor(g))
    j_aux, aux = _aux(jmodel, jdata, model, data)
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
        if p.grad is None:
            assert name == "DiffNetPlusPlus" and k[0] in "Wb", k
            assert not np.any(_np(grads[k])), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), _np(grads[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_scores_match_jax(toy_social_dataset, name):
    (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset, name)
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
        if name == "LR_GCCF":
            got = model.dot_decomposition(tu, aux)
            want = jmodel.dot_decomposition(params, jnp.asarray(u), j_aux)
            assert got[1].shape == (data.item_nums, 4 * 16)
            close(got[0], want[0])
            close(got[1], want[1])
            assert got[2] is None and want[2] is None


@pytest.mark.parametrize("name,form", _cases())
def test_scan_epoch_on_jax_draws_matches_jax(toy_social_dataset, name, form):
    """One scan epoch from JAX's parameters and Adam state one epoch in,
    on JAX's sampled batches: parameters, moments and loss (DiffNet++'s
    W_l and b_l and their moments unchanged)."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(
        toy_social_dataset, name, **_form(form))
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
    if name == "DiffNetPlusPlus":
        for k in ("W_0", "b_0", "W_1", "b_1"):
            assert torch.equal(got_p[k].detach(), torch.as_tensor(p0[k]))
            assert torch.equal(got_o.mu[k], torch.as_tensor(mu[k]))


def test_lr_gccf_dense_and_edge_forms_agree(toy_social_dataset):
    """The two adjacency forms propagate to one matrix and train to the
    same parameters over two epochs from one seed."""
    runs = []
    for form in ("dense", "edge"):
        (_, _, _), (cfg, data, model) = _both(toy_social_dataset, "LR_GCCF",
                                              **_form(form))
        tr = Trainer(model, data, cfg, device="cpu")
        assert ("g_dense" in tr.aux) == (form == "dense")
        params, state = tr.init_state()
        with torch.no_grad():
            start = torch.cat(model._propagate(tr.aux))
        params, state, losses = tr.train_epochs(params, state, 2)
        runs.append((start, {k: v.detach().clone()
                             for k, v in params.items()}, losses))
    (s_d, p_d, l_d), (s_e, p_e, l_e) = runs
    np.testing.assert_allclose(s_e.numpy(), s_d.numpy(), rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(l_e, l_d, rtol=EPOCH_LOSS_RTOL)
    for k in p_d:
        np.testing.assert_allclose(p_e[k].numpy(), p_d[k].numpy(),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                   err_msg=k)


def test_lr_gccf_fused_ranking_equals_dense(toy_social_dataset):
    """LR_GCCF's decomposition (the concatenated item rows, width
    (L + 1) d) through the fused rankers' plain versions ranks as
    score_all does: full_fused eval equals full, fused retrieval equals
    dense."""
    (_, _, _), (cfg, data, model) = _both(
        toy_social_dataset, "LR_GCCF",
        **{"test.neg_samples": "0", "data.split_way": "rs"})
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
    assert table.shape == (data.item_nums, 4 * model.embed_size)
    with torch.no_grad():
        np.testing.assert_allclose((uv @ table.T).numpy(),
                                   model.score_all(u, tr.aux).numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert ranking.fused_precompute(model, tr.aux)[1] is None


@pytest.mark.parametrize("name", MODELS)
def test_trains_and_evaluates(toy_social_dataset, name):
    """Each trains on the scan tier and evaluates: the loss falls, the
    metrics are finite."""
    (_, _, _), (cfg, data, model) = _both(toy_social_dataset, name)
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = tr.init_state()
    params, state, losses = tr.train_epochs(params, state, 3)
    assert losses[-1] < losses[0], losses
    for hr, mrr, ndcg in tr.evaluate().values():
        assert 0.0 <= hr <= 1.0 and np.isfinite(ndcg)
