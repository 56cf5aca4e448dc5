"""FISM, NAIS and NAIS_single in the port against the JAX package: the
smoothed history attention (all-pad rows, beta 0.5 and 1, gradients),
each model's losses, gradients and scorers, the bucketed-history tier's
plan (grids equal to JAX's, repeated pairs included) and its row layout,
one grouped step and one bucketed epoch on JAX's own draws under
Adagrad, the flat pointwise tier, NAIS's warm start from FISM, the
weights carried across, and end-to-end runs of both packages."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.models.itemsim import NAIS as JNAIS
from cleverrec_tpu.models.modules import \
    masked_history_attention as j_attention
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu.train.checkpoint import graft_nais as j_graft_nais
from cleverrec_tpu_torch import cli, sampling
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.models.itemsim import NAIS
from cleverrec_tpu_torch.models.modules import masked_history_attention
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.checkpoint import (copy_into, graft_nais,
                                                  load_params,
                                                  save_checkpoint)
from cleverrec_tpu_torch.utils.logging import get_logger
from cleverrec_tpu_torch.weights import (adagrad_state_from_jax,
                                         params_from_jax)
from cleverrec_tpu_torch.weights import load_params as load_jax_params
from tests.conftest import base_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAIS_MODELS = ("NAIS", "NAIS_single")
# The confs cut to the toy: embed 16, atten 8; stddev 0.1 so that the
# attention is not flat.  FISM: Adam, pairwise bpr; NAIS: Adagrad,
# pointwise cross-entropy.
FISM_TRAIN = {"recommender": "FISM", "embed_size": "16", "alpha": "0.4",
              "reg": "0.01", "reg_bias": "0.01", "lr": "0.01",
              "neg_ratio": "2", "stddev": "0.1"}
NAIS_TRAIN = {"recommender": "NAIS", "embed_size": "16", "atten_size": "8",
              "beta": "0.5", "reg": "0.01", "lr": "0.05", "neg_ratio": "2",
              "optimizer": "Adagrad", "is_pairwise": "False",
              "loss_func": "cross_entropy", "stddev": "0.1",
              "batch_size": "256"}
# Losses, gradients and scores of the same parameters in the two
# packages: f32 sums of width 16 and over histories in another order.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
# One optimizer step from one batch: parameters and accumulators.
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
# A whole epoch, port against JAX: f32 sums in another order, carried
# through Adagrad's normalisation (tests/test_torch_samn.py).
EPOCH_RTOL, EPOCH_ATOL = 1e-3, 1e-5
# End to end, port against JAX on other random draws from the same seed:
# chip_smoke.JAX_BAND.
JAX_BAND = 0.03


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def write_histories(path, n_users=120, n_items=240, seed=3, dups=80):
    """Clustered interactions whose users' history lengths span several
    buckets (a quarter each near 6, 25, 50 and 95 items), 80% of each
    history from the user's third of the catalog, then ``dups`` rows
    repeated (pairs seen twice)."""
    r = np.random.default_rng(seed)
    lines = ["u_id,i_id,rating,time"]
    t = 0
    for u in range(n_users):
        deg = (6, 25, 50, 95)[u % 4] + int(r.integers(0, 6))
        pool = np.arange(u % 3, n_items, 3)
        n_pref = min(int(deg * 0.8), len(pool))
        items = np.concatenate([
            r.choice(pool, n_pref, replace=False),
            r.choice(np.setdiff1d(np.arange(n_items), pool), deg - n_pref,
                     replace=False)])
        for i in r.permutation(items):
            t += 1
            lines.append(f"{u},{i},5,{t}")
    lines += [lines[1 + k] for k in r.integers(0, len(lines) - 1, dups)]
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture
def histories(tmp_path):
    ds = tmp_path / "hist"
    ds.mkdir()
    write_histories(ds / "ratings.csv")
    return {"root": str(tmp_path), "name": "hist"}


def _both(toy, base, **overrides):
    jcfg = base_config(toy, **{**base, **overrides})
    cfg = Config(jcfg.to_dict())
    jdata, data = j_load_ranking_data(jcfg), load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return (jcfg, jdata, jmodel), (cfg, data, model)


def _params(jmodel, model, seed):
    """JAX's initial parameters, loaded into the port's model."""
    params = dict(jmodel.init(jax.random.PRNGKey(seed)))
    load_jax_params(model, {k: _np(v) for k, v in params.items()})
    return params


# -- the attention ----------------------------------------------------------

@pytest.mark.parametrize("per_target", [False, True])
@pytest.mark.parametrize("beta", [0.5, 1.0])
def test_masked_history_attention_matches_jax(beta, per_target):
    """Random histories with pad slots and two all-pad rows (whose output
    is 0, not NaN), with tied logits; values and gradients of hist_emb
    and logits.  ``per_target``: T targets a row against one history, as
    JAX's vmap over axis 1."""
    rng = np.random.default_rng(int(beta * 10) + per_target)
    b, t, h, d = 6, 3, 9, 5
    pe = rng.normal(size=(b, h, d)).astype(np.float32)
    mask = rng.random((b, h)) < 0.7
    mask[0] = False
    mask[3] = False
    shape = (b, t, h) if per_target else (b, h)
    logits = rng.normal(size=shape).astype(np.float32) * 3
    logits[..., 1] = logits[..., 2]                    # ties at the max too
    up = rng.normal(size=(b, t, d) if per_target else (b, d)).astype(
        np.float32)

    def j_fn(p, lg):
        if per_target:
            out = jax.vmap(j_attention, in_axes=(None, None, 1, None),
                           out_axes=1)(p, jnp.asarray(mask), lg, beta)
        else:
            out = j_attention(p, jnp.asarray(mask), lg, beta)
        return jnp.sum(out * up), out

    (_, want), grads = jax.value_and_grad(j_fn, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(pe), jnp.asarray(logits))
    t_pe = torch.as_tensor(pe).requires_grad_()
    t_lg = torch.as_tensor(logits).requires_grad_()
    out = masked_history_attention(t_pe, torch.as_tensor(mask), t_lg, beta)
    (out * torch.as_tensor(up)).sum().backward()
    got = out.detach().numpy()
    assert np.isfinite(got).all()
    assert (got[[0, 3]] == 0).all()
    np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-6)
    for g, w in zip((t_pe.grad, t_lg.grad), grads):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-4, atol=1e-6)


# -- the models -------------------------------------------------------------

@pytest.mark.parametrize("name", ("FISM",) + NAIS_MODELS)
def test_parameters_match_jax(toy_dataset, name):
    base = FISM_TRAIN if name == "FISM" else {**NAIS_TRAIN,
                                              "recommender": name}
    (_, _, jmodel), (_, data, model) = _both(toy_dataset, base)
    params = jmodel.init(jax.random.PRNGKey(0))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(v.shape) for n, v in params.items()}
    assert got["P"] == (data.item_nums + 1, 16)       # the sentinel row
    assert model.fused_protocol is None
    assert not hasattr(model, "dot_decomposition")
    if name != "FISM":
        assert model.history_bucketing and model.sampler == "pointwise"
        assert model.pretrain_keys == ("fism_pretrain",)


def _fism_batch(rng, data, pairwise, n=40):
    batch = {"u": rng.integers(0, data.user_nums, n).astype(np.int32),
             "i": rng.integers(0, data.item_nums, n).astype(np.int32),
             "w": (rng.random(n) < 0.8).astype(np.float32)}
    if pairwise:
        batch["j"] = rng.integers(0, data.item_nums, n).astype(np.int32)
    else:
        batch["y"] = (rng.random(n) < 0.4).astype(np.float32)
    return batch


def _check_loss(jloss, loss_fn, params, model, batch, j_aux, aux):
    want, grads = jax.value_and_grad(jloss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, j_aux)
    loss = loss_fn({k: torch.as_tensor(v) for k, v in batch.items()}, aux)
    model.zero_grad()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(grads[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("pairwise", [True, False])
def test_fism_loss_grads_and_scores_match_jax(histories, pairwise):
    over = {} if pairwise else {"is_pairwise": "False",
                                "loss_func": "cross_entropy"}
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(histories, FISM_TRAIN,
                                                      **over)
    assert model.sampler == ("pairwise" if pairwise else "pointwise")
    params = _params(jmodel, model, 3)
    j_tr, tr = JTrainer(jmodel, jdata, jcfg), Trainer(model, data, cfg,
                                                      device="cpu")
    j_aux, aux = j_tr.arrays, tr.aux
    np.testing.assert_array_equal(aux["u_deg"].numpy(), _np(j_aux["u_deg"]))
    batch = _fism_batch(np.random.default_rng(5), data, pairwise)
    _check_loss(jmodel.loss, model.loss, params, model, batch, j_aux, aux)
    rng = np.random.default_rng(6)
    u = rng.integers(0, data.user_nums, 12).astype(np.int32)
    i = rng.integers(0, data.item_nums, 12).astype(np.int32)
    tu = torch.as_tensor(u).long()
    with torch.no_grad():
        np.testing.assert_allclose(
            model.score_pairs(tu, torch.as_tensor(i).long(), aux).numpy(),
            _np(jmodel.score_pairs(params, jnp.asarray(u), jnp.asarray(i),
                                   j_aux)), rtol=SCORE_RTOL, atol=SCORE_ATOL)
        np.testing.assert_allclose(
            model.score_all(tu, aux).numpy(),
            _np(jmodel.score_all(params, jnp.asarray(u), j_aux)),
            rtol=SCORE_RTOL, atol=SCORE_ATOL)


def _nais_both(toy, name="NAIS", **over):
    return _both(toy, {**NAIS_TRAIN, "recommender": name}, **over)


def _grouped_batch(rng, data, g=5, t=6):
    gw = (rng.random((g, t)) < 0.8).astype(np.float32)
    gt = rng.integers(0, data.item_nums, (g, t)).astype(np.int32)
    gt[gw == 0] = data.item_nums                      # pad cells, as the grid
    return {"gu": rng.integers(0, data.user_nums, g).astype(np.int32),
            "gt": gt, "gy": (rng.random((g, t)) < 0.3).astype(np.float32),
            "gw": gw}


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("atten", ["prod", "concat"])
@pytest.mark.parametrize("name", NAIS_MODELS)
def test_nais_loss_and_grads_match_jax(histories, name, atten, grouped):
    """``loss`` (flat rows) and ``loss_grouped`` (groups) on the full-width
    seen table, histories of up to ~100 items with pad slots."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _nais_both(
        histories, name, atten_type=atten)
    params = _params(jmodel, model, 4)
    j_aux = {"seen": JTrainer(jmodel, jdata, jcfg).arrays["seen"]}
    aux = {"seen_rows": torch.as_tensor(
        Trainer(model, data, cfg, device="cpu").aux["seen_rows"])}
    rng = np.random.default_rng(7)
    if grouped:
        batch = _grouped_batch(rng, data)
        _check_loss(jmodel.loss_grouped, model.loss_grouped, params, model,
                    batch, j_aux, aux)
    else:
        batch = _fism_batch(rng, data, pairwise=False)
        _check_loss(jmodel.loss, model.loss, params, model, batch, j_aux,
                    aux)


@pytest.mark.parametrize("atten", ["prod", "concat"])
def test_nais_scores_match_jax(histories, atten):
    (jcfg, jdata, jmodel), (cfg, data, model) = _nais_both(
        histories, atten_type=atten)
    params = _params(jmodel, model, 8)
    j_aux = {"seen": JTrainer(jmodel, jdata, jcfg).arrays["seen"]}
    aux = {"seen_rows": Trainer(model, data, cfg, device="cpu").aux[
        "seen_rows"]}
    rng = np.random.default_rng(9)
    u = rng.integers(0, data.user_nums, 10).astype(np.int32)
    i = rng.integers(0, data.item_nums, 10).astype(np.int32)
    cand = rng.integers(0, data.item_nums, (10, 19)).astype(np.int32)
    ju, tu = jnp.asarray(u), torch.as_tensor(u).long()

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)

    with torch.no_grad():
        close(model.score_pairs(tu, torch.as_tensor(i).long(), aux),
              jmodel.score_pairs(params, ju, jnp.asarray(i), j_aux))
        close(model.score_candidates(tu, torch.as_tensor(cand).long(), aux),
              jmodel.score_candidates(params, ju, jnp.asarray(cand), j_aux))
        close(model.score_all(tu, aux), jmodel.score_all(params, ju, j_aux))
    with torch.no_grad():
        # The candidates' chunks are one scorer: each column alone gives
        # the same score.
        one = torch.cat([model.score_candidates(
            tu, torch.as_tensor(cand[:, c:c + 1]).long(), aux)
            for c in range(cand.shape[1])], dim=1)
        close(one, jmodel.score_candidates(params, ju, jnp.asarray(cand),
                                           j_aux))


# -- the bucketed-history tier ---------------------------------------------

@pytest.mark.parametrize("batch_size", ["64", "256", "1024"])
@pytest.mark.parametrize("dataset", ["toy", "histories"])
def test_bucket_plan_matches_jax(request, dataset, batch_size):
    """Widths, pairs, steps and every grouped grid array of each bucket
    equal JAX's ``_bucket_plan``; each bucket's seen rows are the table
    cut to its width.  The histories hold repeated pairs, so pairs and
    seen items differ."""
    toy = request.getfixturevalue(
        "toy_dataset" if dataset == "toy" else "histories")
    (jcfg, jdata, jmodel), (cfg, data, model) = _nais_both(
        toy, batch_size=batch_size)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    plan = j_tr._bucket_plan
    assert [(b["width"], b["pairs"], b["steps"]) for b in tr._buckets] == [
        (p["width"], p["pairs"], p["steps"]) for p in plan]
    if dataset == "histories":
        assert len(plan) >= 3
        assert tr.n_pairs > int(tr.dd.seen.lens.sum())
    for bucket, p in zip(tr._buckets, plan):
        for name in ("g_user", "g_pos", "g_y", "g_w", "g_nun"):
            got, want = bucket["grid"][name], _np(p["arrays"][name])
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(bucket["aux"]["seen_rows"].numpy(),
                                      _np(p["arrays"]["seen"].rows))
    assert tr.steps_per_epoch == sum(p["steps"] for p in plan)


class _JRowNAIS(JNAIS):
    """NAIS without a grouped loss: the bucketed tier's row layout."""

    @property
    def loss_grouped(self):
        raise AttributeError("loss_grouped")


class _RowNAIS(NAIS):
    @property
    def loss_grouped(self):
        raise AttributeError("loss_grouped")


def test_row_layout_matches_jax(histories):
    """The row layout: per bucket, the pairs' pointwise layout at
    min(batch, rows rounded up to 256, at least 256), equal to JAX's; it
    trains (the loss falls)."""
    jcfg = base_config(histories, **{**NAIS_TRAIN, "batch_size": "1024"})
    cfg = Config(jcfg.to_dict())
    jdata, data = j_load_ranking_data(jcfg), load_ranking_data(cfg)
    jmodel = _JRowNAIS(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = _RowNAIS(cfg, DataMeta(data.user_nums, data.item_nums))
    assert not hasattr(jmodel, "loss_grouped")
    assert not hasattr(model, "loss_grouped")
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    plan = j_tr._bucket_plan
    assert len(plan) >= 3
    assert [(b["width"], b["pairs"], b["steps"]) for b in tr._buckets] == [
        (p["width"], p["pairs"], p["steps"]) for p in plan]
    for bucket, p in zip(tr._buckets, plan):
        assert bucket["grid"] is None
        static = p["arrays"]["pointwise_static"]
        assert bucket["batch"] * bucket["steps"] == len(static["ord_u"])
        assert bucket["batch"] == min(1024, max(256, -(-bucket["rows"] // 256)
                                                * 256))
        for name in ("ord_u", "ord_i", "ord_y", "ord_nun"):
            np.testing.assert_array_equal(bucket["dev"][name].numpy(),
                                          _np(static[name]), err_msg=name)
    params, state = tr.init_state()
    draw = tr.sample_epoch()["buckets"]
    for bucket, d in zip(tr._buckets, draw):
        assert d["u"].shape == (bucket["steps"], bucket["batch"])
        assert int(d["w"].sum()) == bucket["rows"]
    params, state, losses = tr.train_epochs(params, state, 3)
    assert losses[-1] < losses[0], losses


def _jax_bucket_draws(j_tr, key):
    """The draws of JAX's bucketed epoch for ``key``
    (cleverrec_tpu/train/trainer.py:1799-1816, :1952-1953): per bucket, a
    complement rank a cell, its negatives and targets, and the groups'
    permutation."""
    seen = j_tr.arrays["seen"]
    assert seen.complement is not None
    out = []
    for p, bk in zip(j_tr._bucket_plan,
                     jax.random.split(key, len(j_tr._bucket_plan))):
        a = p["arrays"]
        jkey, pkey, _ = jax.random.split(bk, 3)
        g_pad, tc = a["g_pos"].shape
        r = jax.random.randint(jkey, (g_pad, tc), 0,
                               jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
        idx = r % a["g_nun"][:, None]
        j = seen.complement.reshape(-1)[a["g_user"][:, None]
                                        * seen.complement.shape[1] + idx]
        gt = jnp.where(a["g_y"] > 0, a["g_pos"], j)
        gt = jnp.where(a["g_w"] > 0, gt, j_tr.dd.item_nums)
        perm = jax.random.permutation(pkey, g_pad).reshape(p["steps"], -1)
        out.append((idx, gt, perm))
    return out


def _hold_bucketed_epoch(j_tr, tr, model, p0, state):
    """One bucketed epoch from the parameters ``p0`` (numpy) and JAX's
    Adagrad ``state``, on JAX's draws: the port's rank draw resolves
    JAX's ranks to JAX's negatives, and its parameters, accumulators and
    loss follow JAX's."""
    s0 = {k: np.array(v) for k, v in state[0].sum_of_squares.items()}
    key = jax.random.PRNGKey(13)
    draws = []
    for bucket, (idx, gt, perm) in zip(tr._buckets,
                                       _jax_bucket_draws(j_tr, key)):
        dev = bucket["dev"]
        j = sampling.unseen_by_rank(tr._neg_rows, tr._neg_lens,
                                    dev["g_user"], _t(idx))
        neg = (bucket["grid"]["g_w"] > 0) & (bucket["grid"]["g_y"] == 0)
        np.testing.assert_array_equal(j.numpy()[neg], _np(gt)[neg])
        draws.append({"gt": _t(gt), "perm": _t(perm)})
    want_p, want_s, want_loss = j_tr._bucketed_epoch(
        {k: jnp.asarray(v) for k, v in p0.items()}, state, key)
    load_jax_params(model, p0)
    got_p, got_s, loss = tr._run_epoch(
        dict(model.named_parameters()),
        adagrad_state_from_jax(s0, "cpu", model=model), {"buckets": draws})
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-4)
    for k in p0:
        np.testing.assert_allclose(got_p[k].detach().numpy(), _np(want_p[k]),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(got_s.sum_of_squares[k].numpy(),
                                   _np(want_s[0].sum_of_squares[k]),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", NAIS_MODELS)
def test_bucketed_epoch_on_jax_draws_matches_jax(histories, name):
    """One bucketed epoch from JAX's parameters and Adagrad state one
    epoch in, on JAX's draws: the port's rank draw resolves JAX's ranks
    to JAX's negatives, and its parameters, accumulators and loss follow
    JAX's."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _nais_both(histories, name)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = j_tr.init_state()
    params, state, _ = j_tr.train_epoch(params, state)
    _hold_bucketed_epoch(j_tr, tr, model,
                         {k: np.array(v) for k, v in params.items()}, state)


@pytest.mark.parametrize("name", NAIS_MODELS)
def test_warm_started_epoch_on_jax_draws_matches_jax(histories, tmp_path,
                                                     name):
    """NAIS's first epoch warm-started from the same trained FISM tables:
    JAX's ``graft_nais`` of them, and the port's ``warm_start`` from a
    port checkpoint of them, give the same parameters, and on JAX's draws
    the port's first-epoch loss and state follow JAX's."""
    (jfcfg, jfdata, jfism), _ = _both(histories, FISM_TRAIN)
    jf_tr = JTrainer(jfism, jfdata, jfcfg)
    fp, fs = jf_tr.init_state()
    for _ in range(3):
        fp, fs, _ = jf_tr.train_epoch(fp, fs)
    fism = {k: np.array(v) for k, v in fp.items()}
    ckpt = save_checkpoint(str(tmp_path / "FISM"),
                           {k: torch.as_tensor(v) for k, v in fism.items()})
    (jcfg, jdata, jmodel), (cfg, data, model) = _nais_both(histories, name)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg.with_overrides(fism_pretrain=ckpt),
                 device="cpu")
    params, state = j_tr.init_state()
    cold = {k: np.array(v) for k, v in params.items()}
    warm = {k: np.array(v) for k, v in j_graft_nais(cold, fism).items()}
    load_jax_params(model, cold)
    own = {k: p.detach() for k, p in model.named_parameters()}
    copy_into(own, model.warm_start(own, tr.cfg), "warm start")
    assert sorted(own) == sorted(warm)
    for k in warm:
        np.testing.assert_array_equal(own[k].numpy(), warm[k], err_msg=k)
    _hold_bucketed_epoch(j_tr, tr, model, warm, state)


@pytest.mark.parametrize("atten", ["prod", "concat"])
def test_grouped_step_matches_jax(histories, atten):
    """One grouped step and Adagrad from one batch of a bucket's grid, on
    that bucket's cut seen table: equal parameters and accumulators."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _nais_both(
        histories, atten_type=atten)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    k = 1
    p, bucket = j_tr._bucket_plan[k], tr._buckets[k]
    _, gt, perm = _jax_bucket_draws(j_tr, jax.random.PRNGKey(3))[k]
    sel = _np(perm[0])
    a = p["arrays"]
    batch = {"gu": _np(a["g_user"])[sel], "gt": _np(gt)[sel],
             "gy": _np(a["g_y"])[sel], "gw": _np(a["g_w"])[sel]}
    params = {k: jnp.asarray(v) for k, v in _params(jmodel, model, 2).items()}
    state = j_tr.optimizer.init(params)
    loss, grads = jax.value_and_grad(jmodel.loss_grouped)(
        params, {n: jnp.asarray(v) for n, v in batch.items()}, a)
    updates, state = j_tr.optimizer.update(grads, state, params)
    want = optax.apply_updates(params, updates)
    t_state = tr.optimizer.init(dict(model.named_parameters()))
    got, t_state, t_loss = tr._steps(
        dict(model.named_parameters()), t_state,
        [{n: torch.as_tensor(v) for n, v in batch.items()}],
        model.loss_grouped, bucket["aux"])
    assert float(t_loss) == pytest.approx(float(loss), rel=LOSS_RTOL)
    for n in want:
        np.testing.assert_allclose(got[n].detach().numpy(), _np(want[n]),
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=n)
        np.testing.assert_allclose(t_state.sum_of_squares[n].numpy(),
                                   _np(state[0].sum_of_squares[n]),
                                   rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=n)


def test_flat_tier_on_jax_draws_matches_jax(histories):
    """``train.bucketed_histories=False``: the flat pointwise scan tier
    with ``loss``, one epoch on JAX's draw from JAX's state one epoch
    in."""
    flat = {"train.bucketed_histories": "False"}
    (jcfg, jdata, jmodel), (cfg, data, model) = _nais_both(histories, **flat)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    assert j_tr._bucket_plan is None
    tr = Trainer(model, data, cfg, device="cpu")
    assert tr._buckets is None and tr._grid is None and not tr.fused
    assert tr.steps_per_epoch == j_tr.steps_per_epoch
    params, state = j_tr.init_state()
    params, state, _ = j_tr.train_epoch(params, state)
    p0 = {k: np.array(v) for k, v in params.items()}
    s0 = {k: np.array(v) for k, v in state[0].sum_of_squares.items()}
    build_xs, run_scan = j_tr._scan_parts[:2]
    xs = build_xs(jax.random.PRNGKey(5), j_tr.arrays)
    want_p, want_s, losses = run_scan(
        {k: jnp.asarray(v) for k, v in p0.items()}, state, xs, j_tr.arrays,
        lambda batch: batch)
    load_jax_params(model, p0)
    got_p, got_s, loss = tr._run_epoch(
        dict(model.named_parameters()),
        adagrad_state_from_jax(s0, "cpu", model=model),
        {k: _t(v) for k, v in xs[0].items()})
    assert float(loss) == pytest.approx(float(jnp.mean(losses)), rel=1e-4)
    for k in p0:
        np.testing.assert_allclose(got_p[k].detach().numpy(), _np(want_p[k]),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("bucketed", ["True", "False"])
def test_nais_trains_on_both_tiers(histories, bucketed):
    """Both tiers train: the grouped draw's targets are the grid's
    positives, unseen negatives and item_nums on pad cells; the loss
    falls and the metrics are finite."""
    (_, _, _), (cfg, data, model) = _nais_both(
        histories, **{"train.bucketed_histories": bucketed})
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = tr.init_state()
    if bucketed == "True":
        for bucket, d in zip(tr._buckets, tr.sample_epoch()["buckets"]):
            g = bucket["grid"]
            gt = d["gt"].numpy()
            assert (gt[g["g_w"] == 0] == data.item_nums).all()
            pos = g["g_y"] > 0
            np.testing.assert_array_equal(gt[pos], g["g_pos"][pos])
            neg = (g["g_w"] > 0) & ~pos
            users = np.repeat(g["g_user"], gt.shape[1]).reshape(gt.shape)
            assert not any(j in data.ui_train[u]
                           for u, j in zip(users[neg], gt[neg]))
            assert sorted(d["perm"].reshape(-1).tolist()) == list(
                range(len(g["g_user"])))
    params, state, losses = tr.train_epochs(params, state, 3)
    assert losses[-1] < losses[0], losses
    for hr, mrr, ndcg in tr.evaluate().values():
        assert 0.0 <= hr <= 1.0 and np.isfinite(ndcg)


@pytest.mark.parametrize("name", ["FISM", "NAIS"])
def test_end_to_end_matches_jax(histories, name):
    """A whole run of each package on the same files (a random split,
    full-catalog eval over 240 items): best HR@10 within ``JAX_BAND``."""
    base = FISM_TRAIN if name == "FISM" else NAIS_TRAIN
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(
        histories, base, epoches="4",
        **{"test.neg_samples": "0", "data.split_way": "rs"})
    assert not data.candidate_eval
    want = JTrainer(jmodel, jdata, jcfg).run()["metrics"][10][0]
    got = Trainer(model, data, cfg, device="cpu").run()["metrics"][10][0]
    assert abs(want - got) <= JAX_BAND, (got, want)


# -- warm start and weights ---------------------------------------------------

def test_graft_nais_matches_jax(histories):
    """The same FISM arrays grafted into the same NAIS parameters."""
    (_, _, jfism), (_, _, fism) = _both(histories, FISM_TRAIN)
    (_, _, jnais), (_, _, nais) = _nais_both(histories)
    f = {k: np.array(v) for k, v in jfism.init(jax.random.PRNGKey(1)).items()}
    n = {k: np.array(v) for k, v in jnais.init(jax.random.PRNGKey(2)).items()}
    want = j_graft_nais(n, f)
    got = graft_nais({k: torch.as_tensor(v) for k, v in n.items()},
                     {k: torch.as_tensor(v) for k, v in f.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), _np(want[k]))


def _drop_handlers(logger):
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


@pytest.mark.parametrize("name", NAIS_MODELS)
def test_cli_warm_starts_nais_from_fism(histories, tmp_path, capsys, name):
    """FISM through the port's CLI with save.best, then NAIS with
    ``--set fism_pretrain``: its P, Q and bias start as FISM's P, Q and
    b, and it trains."""
    props = tmp_path / "global.properties"
    props.write_text("\n".join([
        "[default]", "recommender=BPR", "model_type=ranking",
        f"data.root_dir={histories['root']}",
        f"data.dataset={histories['name']}", "data.file_name=ratings.csv",
        "data.sep=,", "data.format=UIRT", "data.split_way=loo",
        "test.neg_samples=10", "test.batch_size=64", "topk=[5,10]",
        f"log.dir={tmp_path / 'logs'}", "seed=7", ""]))
    argv = ["--config", str(props), "--conf-dir", os.path.join(REPO, "conf"),
            "--device", "cpu", "--set", "epoches=2", "--set", "embed_size=16",
            "--set", "batch_size=256"]
    saved = str(tmp_path / "saved")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    loggers = [logging.getLogger(f"cleverrec_tpu_torch.{m}")
               for m in ("FISM", name)]
    try:
        assert cli.main(argv + ["--model", "FISM", "--set", "save.best=True",
                                "--set", f"saved_dir={saved}"]) == 0
        _drop_handlers(loggers[1])
        get_logger(str(tmp_path / "logs"), name)
        loggers[1].addHandler(Keep())
        ckpt = os.path.join(saved, "FISM")
        assert cli.main(argv + ["--model", name, "--set",
                                f"fism_pretrain={ckpt}"]) == 0
    finally:
        for lg in loggers:
            _drop_handlers(lg)
    out = capsys.readouterr().out
    assert f"warm start: {name} from {ckpt}" in out
    assert "history buckets (grouped)" in out and "best_epoch: " in out
    epochs = [r.train for r in records if hasattr(r, "train")]
    assert [e["epoch"] for e in epochs] == [1, 2]
    cfg = Config.from_properties(str(props), os.path.join(REPO, "conf"), {
        "recommender": name, "embed_size": "16", "fism_pretrain": ckpt})
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    params, _ = Trainer(model, data, cfg, device="cpu").init_state()
    fism = load_params(ckpt)
    for mine, theirs in (("P", "P"), ("Q", "Q"), ("bias", "b")):
        assert torch.equal(params[mine].detach(), fism[theirs])


def test_fism_pretrain_on_another_model_raises(histories, tmp_path):
    """A fism_pretrain that the model does not read raises; NAIS without
    it starts cold."""
    (_, _, _), (cfg, data, model) = _both(histories, FISM_TRAIN)
    with pytest.raises(ValueError, match="warm-starts from no checkpoint"):
        Trainer(model, data, cfg.with_overrides(
            fism_pretrain=str(tmp_path / "FISM")), device="cpu")
    (_, _, _), (cfg, data, model) = _nais_both(histories)
    assert Trainer(model, data, cfg, device="cpu")._warm == ()


def test_weights_carry_jax_state_across(histories):
    """Each model's JAX parameters (FISM: P, Q, b; NAIS: P, Q, bias, W, b,
    h) and NAIS's Adagrad accumulators, by name and shape."""
    (_, _, jfism), (_, _, fism) = _both(histories, FISM_TRAIN)
    (jcfg, jdata, jnais), (_, _, nais) = _nais_both(histories)
    for jm, m, names in ((jfism, fism, ["P", "Q", "b"]),
                         (jnais, nais, ["P", "Q", "bias", "W", "b", "h"])):
        params = {k: _np(v) for k, v in jm.init(jax.random.PRNGKey(3)).items()}
        assert sorted(params) == sorted(names)
        load_jax_params(m, params)
        for k, v in params_from_jax(params, "cpu").items():
            assert torch.equal(dict(m.named_parameters())[k].detach(), v)
    j_tr = JTrainer(jnais, jdata, jcfg)
    _, state = j_tr.init_state()
    sums = {k: _np(v) for k, v in state[0].sum_of_squares.items()}
    got = adagrad_state_from_jax(sums, "cpu", model=nais)
    assert sorted(got.sum_of_squares) == sorted(names)
    with pytest.raises(KeyError):
        adagrad_state_from_jax({"P": sums["P"]}, "cpu", model=nais)
