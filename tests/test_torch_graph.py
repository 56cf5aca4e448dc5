"""RML_DGATs and SoHRML in the port against the JAX package: both
``build_aux``s array for array, the parameters, losses and gradients,
the three scorers, SoHRML's ``pre_epoch``, the social rows of the dual
protocol, one dual epoch on JAX's own draws, the dropout draws on their
own, a SoHRML run resumed against the whole run, and the evaluator's
candidate and full metrics (both models rank ascending)."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu import sampling as j_sampling
from cleverrec_tpu.common import cdiv
from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.evalx import Evaluator as JEvaluator
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import cli, sampling
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import graph, make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.checkpoint import load_checkpoint
from cleverrec_tpu_torch.utils.logging import get_logger
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("RML_DGATs", "SoHRML")
# The confs (Adam, hinge, neg_ratio 4, 100 train_batches; RML_DGATs embed
# 64, atten 32, att_type 2, max_i = max_s = 30; SoHRML embed 128, 2 GAT
# layers, dropout 0.3, every neighbour) cut to the toy: embed 16, atten
# 8, 3 train_batches, neighbour caps below the toy's list lengths so that
# the numpy draws run, dropout off (JAX's draws cannot be repeated);
# stddev 0.1 so that the attention is not flat.
TRAIN = {"epoches": "2", "embed_size": "16", "atten_size": "8",
         "train_batches": "3", "neg_ratio": "2", "lr": "0.01",
         "stddev": "0.1", "loss_func": "hinge", "margin": "0.5",
         "gamma": "0.1", "reg1": "0.1", "reg2": "0.01", "att_type": "2",
         "mlp_type": "0", "max_i": "5", "max_s": "3",
         "social_file": "trusts.csv"}
CONF = {"RML_DGATs": {},
        "SoHRML": {"gat_layer_nums": "2", "node_dropout": "0",
                   "message_dropout": "0"}}
# Losses and scores, port against JAX: f32 sums of width 16, softmaxes
# and segment sums in another order (index_add against segment_sum).
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
# pre_epoch's attention: exp of f32 edge scores, sums in another order.
ATT_RTOL, ATT_ATOL = 1e-5, 1e-7
# One dual epoch, port against JAX (tests/test_torch_diffnet.py:44-46).
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


def _arrays(aux):
    """The numeric arrays of a build_aux (the trainer's aux)."""
    return {k: v for k, v in aux.items() if isinstance(v, np.ndarray)}


def _aux(jmodel, jdata, model, data):
    j_aux = {k: jnp.asarray(v) for k, v in _arrays(jmodel.build_aux(
        j_build_device_data(jdata), jdata)).items()}
    aux = {k: torch.as_tensor(v) for k, v in _arrays(model.build_aux(
        build_device_data(data), data)).items()}
    return j_aux, aux


def _params(jmodel, model, seed):
    params = jmodel.init(jax.random.PRNGKey(seed))
    load_params(model, {k: _np(v) for k, v in params.items()})
    return params


def _refresh(jmodel, params, j_aux, model, aux):
    """SoHRML's attention from these parameters in both packages, so that
    the tests run on a non-uniform attention."""
    if hasattr(model, "pre_epoch"):
        j_aux.update(jmodel.pre_epoch(params, j_aux))
        with torch.no_grad():
            aux.update(model.pre_epoch(aux))


def _batch(rng, data, n=40, m=24):
    return {"u": rng.integers(0, data.user_nums, n).astype(np.int32),
            "i": rng.integers(0, data.item_nums, n).astype(np.int32),
            "j": rng.integers(0, data.item_nums, n).astype(np.int32),
            "w": (rng.random(n) < 0.8).astype(np.float32),
            "u_s": rng.integers(0, data.user_nums, m).astype(np.int32),
            "v": rng.integers(0, data.user_nums, m).astype(np.int32),
            "w_neg": rng.integers(0, data.user_nums, m).astype(np.int32),
            "w_s": (rng.random(m) < 0.8).astype(np.float32)}


@pytest.mark.parametrize("name,caps", [("RML_DGATs", ("5", "3")),
                                       ("RML_DGATs", ("0", "0")),
                                       ("SoHRML", ("5", "3")),
                                       ("SoHRML", ("0", "0"))])
def test_build_aux_matches_jax(toy_social_dataset, name, caps):
    """Every table equal to JAX's, dtypes included: the numpy neighbour
    draws in the same order from the same seed, the friends' table (JAX's
    uint32 bitmap as the port's int32 words)."""
    (_, jdata, jmodel), (_, data, model) = _both(
        toy_social_dataset, name, max_i=caps[0], max_s=caps[1])
    want = jmodel.build_aux(j_build_device_data(jdata), jdata)
    got = model.build_aux(build_device_data(data), data)
    assert sorted(got) == sorted(want)
    for k in got:
        if k == "friends_tbl":
            np.testing.assert_array_equal(got[k].rows, want[k].rows)
            np.testing.assert_array_equal(got[k].lens, want[k].lens)
            np.testing.assert_array_equal(got[k].bits.view(np.uint32),
                                          want[k].bits)
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if name == "RML_DGATs" and caps[0] == "5":
        assert got["user_nbrs_i"].shape[1] == 5
        assert got["user_nbrs_s"].shape[1] == 3
        assert (got["user_nbrs_s"] == data.user_nums).any()   # sentinel pads


@pytest.mark.parametrize("name", MODELS)
def test_needs_a_social_file(toy_dataset, name):
    (_, jdata, jmodel), (_, data, model) = _both(toy_dataset, name,
                                                 social_file=None)
    with pytest.raises(ValueError, match="requires social_file"):
        jmodel.build_aux(j_build_device_data(jdata), jdata)
    with pytest.raises(ValueError, match="requires social_file"):
        model.build_aux(build_device_data(data), data)


@pytest.mark.parametrize("name", MODELS)
def test_dual_epoch_needs_friend_pairs(toy_dataset, name):
    """A trust file without a pair among the kept users leaves the social
    domain empty: the trainer raises rather than draw from no rows."""
    with open(os.path.join(toy_dataset["root"], toy_dataset["name"],
                           "trusts.csv"), "w") as f:
        f.write("u_id,v_id\n")
    (_, _, _), (cfg, data, model) = _both(toy_dataset, name)
    assert data.user_friends == {}
    with pytest.raises(ValueError, match="no friend pairs"):
        Trainer(model, data, cfg, device="cpu")


@pytest.mark.parametrize("name", MODELS)
def test_parameters_match_jax(toy_social_dataset, name):
    """Names, order and shapes, with a 2-layer relation tower."""
    (_, _, jmodel), (_, data, model) = _both(toy_social_dataset, name,
                                             mlp_type="2")
    params = jmodel.init(jax.random.PRNGKey(0))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(v.shape) for n, v in params.items()}
    assert list(got) == list(params)
    extra = int(name == "RML_DGATs")
    assert got["P"] == (data.user_nums + extra, 16)
    assert got["Q"] == (data.item_nums + extra, 16)
    assert got["W_mlp_0"] == (32, 32) and got["W_mlp_1"] == (32, 16)
    assert model.sampler == "dual" and model.cml_like
    assert not hasattr(model, "dot_decomposition")


def _cases():
    return [("RML_DGATs", {"att_type": "0"}), ("RML_DGATs", {"att_type": "1"}),
            ("RML_DGATs", {"att_type": "2"}),
            ("RML_DGATs", {"att_type": "2", "mlp_type": "1"}),
            ("SoHRML", {"mlp_type": "0"}), ("SoHRML", {"mlp_type": "1"})]


@pytest.mark.parametrize("name,over", _cases())
def test_loss_grads_and_scores_match_jax(toy_social_dataset, name, over):
    """The loss and every parameter's gradient without dropout (no key, no
    generator), then score_pairs, score_candidates and score_all."""
    (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset, name,
                                                 **over)
    params = _params(jmodel, model, 3)
    j_aux, aux = _aux(jmodel, jdata, model, data)
    _refresh(jmodel, params, j_aux, model, aux)
    rng = np.random.default_rng(4)
    batch = _batch(rng, data)
    want, grads = jax.value_and_grad(jmodel.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, j_aux)
    loss = model.loss({k: torch.as_tensor(v) for k, v in batch.items()}, aux)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    for k, p in model.named_parameters():
        if p.grad is None:
            # The attention MLP outside the loss: RML_DGATs' at att_type 0
            # and 1, SoHRML's (its attention is an input): JAX's zeros.
            assert k in ("W", "h", "b") and (
                name == "SoHRML" or over["att_type"] != "2"), k
            assert not np.any(_np(grads[k])), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), _np(grads[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    u = rng.integers(0, data.user_nums, 12).astype(np.int32)
    i = rng.integers(0, data.item_nums, 12).astype(np.int32)
    cand = rng.integers(0, data.item_nums, (12, 21)).astype(np.int32)
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


@pytest.mark.parametrize("att_type", ["0", "1", "2"])
def test_pre_epoch_matches_jax(toy_social_dataset, att_type):
    """SoHRML's edge attention: each row's edges sum to 1, equal to JAX's
    from the same parameters; the initial attention is the uniform row
    softmax."""
    (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset,
                                                 "SoHRML", att_type=att_type)
    params = _params(jmodel, model, 6)
    j_aux, aux = _aux(jmodel, jdata, model, data)
    rows = aux["adj_i_row"].long()
    deg = torch.zeros(data.user_nums + data.item_nums).index_add(
        0, rows, torch.ones(len(rows)))
    torch.testing.assert_close(aux["att_i"], 1.0 / deg[rows])
    want = jmodel.pre_epoch(params, j_aux)
    with torch.no_grad():
        got = model.pre_epoch(aux)
    assert sorted(got) == ["att_i", "att_s"]
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), _np(want[k]),
                                   rtol=ATT_RTOL, atol=ATT_ATOL, err_msg=k)
    sums = torch.zeros(deg.shape).index_add(0, rows, got["att_i"])
    torch.testing.assert_close(sums, torch.ones_like(sums))


def test_social_pairwise_batch_invariants(toy_social_dataset):
    """Row r holds friend pair (r mod n nr) div nr, its weight, and a
    negative user outside u_s's friends, except where u_s's friends are
    every user; the negatives cover every other user."""
    (_, _, _), (_, data, model) = _both(toy_social_dataset, "SoHRML")
    aux = model.build_aux(build_device_data(data), data)
    sf_u, sf_v = (torch.as_tensor(aux[k]) for k in ("sf_u", "sf_v"))
    friends = sampling.table_to(aux["friends_tbl"], "cpu")
    gen = torch.Generator().manual_seed(0)
    nr, n = 3, len(sf_u)
    rows, valid = sampling.epoch_permutation(gen, n * nr, n * nr + 7)
    rows, valid = rows.repeat(20), valid.repeat(20)
    out = sampling.social_pairwise_batch(gen, rows, valid, sf_u, sf_v,
                                         friends, data.user_nums, nr)
    p = (rows % (n * nr)) // nr
    assert torch.equal(out["u_s"], sf_u[p]) and torch.equal(out["v"], sf_v[p])
    assert torch.equal(out["w_s"], valid)
    w = out["w_neg"]
    assert w.dtype == torch.int32 and ((w >= 0) & (w < data.user_nums)).all()
    is_friend = sampling.member(friends, out["u_s"], w)
    full = friends.lens[out["u_s"].long()] >= data.user_nums
    assert not (is_friend & ~full).any()
    u0 = int(sf_u[0])
    drawn = set(w[out["u_s"] == u0].tolist())
    others = set(range(data.user_nums)) - set(data.user_friends[u0])
    assert drawn == others


def _dual_draws(j_tr, key):
    """The JAX dual epoch's draws, rebuilt outside its jit with its key
    splits (cleverrec_tpu/train/trainer.py:1976-1988)."""
    arrays, steps = j_tr.arrays, j_tr.steps_per_epoch
    nr = j_tr.neg_ratio
    m_i = j_tr.n_pairs * nr
    m_s = max(int(len(arrays["sf_u"])) * nr, 1)
    ki, ks, kbi, kbs, _ = jax.random.split(key, 5)
    perm_i, valid_i = j_sampling.epoch_permutation(ki, m_i,
                                                   steps * cdiv(m_i, steps))
    perm_s, valid_s = j_sampling.epoch_permutation(ks, m_s,
                                                   steps * cdiv(m_s, steps))
    batch = {**j_sampling.pairwise_batch(
        kbi, perm_i, valid_i, arrays["pos_u"], arrays["pos_i"],
        arrays["seen"], j_tr.dd.item_nums, nr,
        pop_cdf=arrays.get("pop_cdf")),
        **j_sampling.social_pairwise_batch(
            kbs, perm_s, valid_s, arrays["sf_u"], arrays["sf_v"],
            arrays["friends_tbl"], j_tr.dd.user_nums, nr)}
    return {k: _np(v).reshape(steps, -1) for k, v in batch.items()}


@pytest.mark.parametrize("name,over", [("RML_DGATs", {"att_type": "1"}),
                                       ("SoHRML", {"mlp_type": "1"})])
def test_dual_epoch_on_jax_draws_matches_jax(toy_social_dataset, name, over):
    """One dual epoch from JAX's parameters and Adam state one epoch in,
    on JAX's own draws (SoHRML's attention refreshed from those
    parameters in both packages first): parameters, moments and loss
    against the JAX trainer's real epoch function on the same key."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(toy_social_dataset,
                                                      name, **over)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    assert not tr.fused and tr.steps_per_epoch == j_tr.steps_per_epoch == 3
    p0, o0 = j_tr.init_state()
    p0, o0, _ = j_tr.train_epoch(p0, o0)
    p0 = {k: np.array(v) for k, v in p0.items()}
    count = int(o0[0].count)
    mu, nu = ({k: np.array(v) for k, v in m.items()}
              for m in (o0[0].mu, o0[0].nu))
    load_params(model, p0)
    if name == "SoHRML":
        j_tr.arrays.update(j_tr._pre_epoch_fn(
            {k: jnp.asarray(v) for k, v in p0.items()}, j_tr.arrays))
        with torch.no_grad():
            tr.aux.update(model.pre_epoch(tr.aux))
        for k in ("att_i", "att_s"):
            np.testing.assert_allclose(tr.aux[k].numpy(),
                                       _np(j_tr.arrays[k]), rtol=ATT_RTOL,
                                       atol=ATT_ATOL, err_msg=k)
    key = jax.random.PRNGKey(7)
    draws = _dual_draws(j_tr, key)
    assert draws["u"].shape[1] == cdiv(j_tr.n_pairs * 2, 3)
    want_p, want_o, want_loss = j_tr._epoch_fn(
        {k: jnp.asarray(v) for k, v in p0.items()}, o0, key, j_tr.arrays)
    state = adam_state_from_jax(count, mu, nu, "cpu", model=model)
    got_p, got_o, loss = tr._run_epoch(
        dict(model.named_parameters()), state,
        {k: torch.as_tensor(np.array(v)) for k, v in draws.items()})
    assert float(loss) == pytest.approx(float(want_loss),
                                        rel=EPOCH_LOSS_RTOL)
    assert got_o.count == count + 3
    for k in p0:
        for got, want in ((got_p[k].detach(), want_p[k]),
                          (got_o.mu[k], want_o[0].mu[k]),
                          (got_o.nu[k], want_o[0].nu[k])):
            np.testing.assert_allclose(got.numpy(), _np(want),
                                       rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                       err_msg=k)


def test_dual_draw_layout(toy_social_dataset):
    """The port's dual draw: 3 steps of cdiv(m, 3) rows a domain, each
    real row once (weight 1), padding at weight 0."""
    (_, _, _), (cfg, data, model) = _both(toy_social_dataset, "RML_DGATs")
    tr = Trainer(model, data, cfg, device="cpu")
    tr.init_state()
    draw = tr.sample_epoch()
    m_i, m_s = tr.n_pairs * 2, len(tr.aux["sf_u"]) * 2
    assert draw["u"].shape == (3, cdiv(m_i, 3))
    assert draw["u_s"].shape == (3, cdiv(m_s, 3))
    assert int(draw["w"].sum()) == m_i and int(draw["w_s"].sum()) == m_s
    seen = sampling.member(tr._seen_table(), draw["u"].reshape(-1),
                           draw["j"].reshape(-1))
    assert not seen.any()


def test_dropout_draws(toy_social_dataset):
    """The dropout on its own: the keep share within 5 sigma of the keep,
    kept entries scaled by 1/keep; each model's training loss reads the
    generator (two generators of one seed agree, another seed differs,
    none differs from both)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.full((400, 500), 2.0)
    for keep in (graph.GAT_KEEP, 0.7, 0.5):
        out = graph._dropout(x, keep, gen)
        share = float((out != 0).float().mean())
        assert abs(share - keep) < 5 * np.sqrt(keep * (1 - keep) / x.numel())
        assert torch.equal(out[out != 0], torch.full_like(out[out != 0],
                                                          2.0 / keep))
    for name, over in (("RML_DGATs", {"att_type": "2"}),
                       ("SoHRML", {"node_dropout": "0.3",
                                   "message_dropout": "0.3"})):
        (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset,
                                                     name, **over)
        _params(jmodel, model, 3)
        _, aux = _aux(jmodel, jdata, model, data)
        batch = {k: torch.as_tensor(v)
                 for k, v in _batch(np.random.default_rng(4), data).items()}
        with torch.no_grad():
            plain = model.loss(batch, aux)
            a, b, c = (model.loss({**batch, "dropout_gen":
                                   torch.Generator().manual_seed(s)}, aux)
                       for s in (1, 1, 2))
        assert torch.equal(a, b) and a != c and a != plain and c != plain


def test_sohrml_resume_equals_the_whole_run(toy_social_dataset, tmp_path):
    """SoHRML with dropout, 2 epochs saved and resumed to 4, against 4 in
    one run: equal on the CPU.  The checkpoint holds no attention; the
    first epoch after the resume refreshes it from the loaded
    parameters."""
    (_, _, _), (cfg, data, model) = _both(
        toy_social_dataset, "SoHRML", node_dropout="0.3",
        message_dropout="0.3")
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = tr.init_state()
    params, state, _ = tr.train_epochs(params, state, 2)
    ckpt = tr.save(str(tmp_path / "SoHRML"), params, state, 2)
    saved = load_checkpoint(ckpt)
    assert "dropout" in saved["rng"]
    assert not {"att_i", "att_s"} & set(saved["params"])
    params, state, losses = tr.train_epochs(params, state, 2)
    whole = {k: v.detach().clone() for k, v in params.items()}
    metrics = tr.evaluate()
    again = Trainer(model, data, cfg, device="cpu")
    assert torch.equal(again.aux["att_i"], torch.as_tensor(
        graph._uniform_row_values(again.aux["adj_i_row"].numpy(),
                                  data.user_nums + data.item_nums)))
    params, state, epoch = again.resume(ckpt)
    assert epoch == 2
    params, state, again_losses = again.train_epochs(params, state, 2)
    assert again_losses == losses
    for k, v in params.items():
        assert torch.equal(v.detach(), whole[k]), k
    assert torch.equal(again.aux["att_i"], tr.aux["att_i"])
    assert again.evaluate() == metrics


@pytest.mark.parametrize("name", MODELS)
def test_evaluator_matches_jax(toy_social_dataset, name):
    """The candidate protocol (ascending distances) and the full-catalog
    protocol on a random split: the port's metrics equal JAX's from the
    same parameters and attention."""
    for over in ({}, {"data.split_way": "rs", "test.neg_samples": "0"}):
        (jcfg, jdata, jmodel), (cfg, data, model) = _both(
            toy_social_dataset, name, **over)
        params = _params(jmodel, model, 11)
        j_aux, aux = _aux(jmodel, jdata, model, data)
        _refresh(jmodel, params, j_aux, model, aux)
        ev = Evaluator(model, build_device_data(data), cfg, device="cpu")
        j_ev = JEvaluator(jmodel, j_build_device_data(jdata), jcfg)
        assert ev.mode == j_ev.mode == ("full" if over else "candidate")
        got, want = ev.evaluate(aux), j_ev.evaluate(params, j_aux)
        for k in cfg.topk:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def _drop_handlers(logger):
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


@pytest.mark.parametrize("name", MODELS)
def test_cli_trains_on_the_cpu(toy_social_dataset, tmp_path, name):
    """The port's CLI trains both models on the CPU through the dual
    protocol, on their confs shrunk to the toy: the loss falls over three
    epochs, each evaluated."""
    props = tmp_path / "global.properties"
    props.write_text("\n".join([
        "[default]", "recommender=BPR", "model_type=ranking",
        f"data.root_dir={toy_social_dataset['root']}",
        f"data.dataset={toy_social_dataset['name']}",
        "data.file_name=ratings.csv", "data.sep=,", "data.format=UIRT",
        "data.split_way=loo", "test.neg_samples=10", "test.batch_size=64",
        "topk=[5,10]", f"log.dir={tmp_path / 'logs'}", "seed=7", ""]))
    argv = ["--config", str(props), "--conf-dir", os.path.join(REPO, "conf"),
            "--device", "cpu", "--model", name]
    for k, v in {"epoches": "3", "embed_size": "16", "atten_size": "8",
                 "train_batches": "3", "max_i": "5", "max_s": "3",
                 "lr": "0.01"}.items():
        argv += ["--set", f"{k}={v}"]
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = logging.getLogger(f"cleverrec_tpu_torch.{name}")
    try:
        _drop_handlers(logger)
        get_logger(str(tmp_path / "logs"), name)
        logger.addHandler(Keep())
        assert cli.main(argv) == 0
    finally:
        _drop_handlers(logger)
    epochs = [r.train for r in records if hasattr(r, "train")]
    losses = [e["losses"][-1] for e in epochs]
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    assert losses[-1] < losses[0], losses
    assert len([r for r in records if hasattr(r, "eval")]) == 3
