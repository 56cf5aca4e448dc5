"""SAMN and SAMN_single in the port against the JAX package: the loss,
its gradients and every scorer on the same parameters and batches, the
grouped loss against the flat one, the grouped pairwise epoch's grid,
one grouped step and one flat epoch on JAX's own draws under Adagrad,
training, Adagrad's state carried across, and the CLI on SAMN's conf."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import cli, sampling
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.models.modules import relu_mlp_logits
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.utils.logging import get_logger
from cleverrec_tpu_torch.weights import adagrad_state_from_jax, load_params
from tests.conftest import base_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("SAMN", "SAMN_single")

# SAMN's conf (Adagrad, neg_ratio 1) cut to the toy: embed 16, mem 4,
# atten 6; stddev 0.1 so that the attention's softmaxes are not flat.
TRAIN = {"epoches": "2", "batch_size": "64", "embed_size": "16",
         "mem_size": "4", "atten_size": "6", "reg1": "0.01", "reg2": "0.03",
         "lr": "0.05", "neg_ratio": "1", "optimizer": "Adagrad",
         "is_pairwise": "True", "loss_func": "bpr", "stddev": "0.1",
         "social_file": "trusts.csv"}
# A trained epoch, port against JAX: f32 sums in another order, carried
# through Adagrad's normalisation.
EPOCH_RTOL, EPOCH_ATOL = 1e-3, 1e-5


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _both(toy, name="SAMN", **overrides):
    jcfg = base_config(toy, **{**TRAIN, "recommender": name, **overrides})
    cfg = Config(jcfg.to_dict())
    jdata, data = j_load_ranking_data(jcfg), load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return (jcfg, jdata, jmodel), (cfg, data, model)


def _params(jmodel, seed):
    """JAX's initial parameters with every attention leaf away from 0."""
    params = dict(jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("i_b", "b", "h"):
        params[name] = jnp.asarray(rng.normal(
            size=params[name].shape).astype(np.float32) * 0.3)
    return params


def _aux(data):
    fp = data.friends_padded
    return {"friends_padded": jnp.asarray(fp)}, {
        "friends_padded": torch.as_tensor(fp)}


def _flat_batch(rng, data, n=40):
    return {"u": rng.integers(0, data.user_nums, n).astype(np.int32),
            "i": rng.integers(0, data.item_nums, n).astype(np.int32),
            "j": rng.integers(0, data.item_nums, n).astype(np.int32),
            "w": (rng.random(n) < 0.8).astype(np.float32)}


def _grouped_batch(rng, data, g=6, t=8):
    gw = (rng.random((g, t)) < 0.8).astype(np.float32)
    gi = rng.integers(0, data.item_nums, (g, t)).astype(np.int32)
    gi[gw == 0] = data.item_nums                      # pad cells, as the grid
    return {"gu": rng.integers(0, data.user_nums, g).astype(np.int32),
            "gi": gi,
            "gj": rng.integers(0, data.item_nums, (g, t)).astype(np.int32),
            "gw": gw}


def test_relu_mlp_logits_matches_jax():
    from cleverrec_tpu.models.modules import relu_mlp_logits as j_logits
    rng = np.random.default_rng(0)
    x, w, b, h = (rng.normal(size=s).astype(np.float32)
                  for s in ((3, 5, 8), (8, 4), (4,), (4,)))
    np.testing.assert_allclose(
        relu_mlp_logits(*map(torch.as_tensor, (x, w, b, h))).numpy(),
        _np(j_logits(*map(jnp.asarray, (x, w, b, h)))), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("name", MODELS)
def test_parameters_match_jax(toy_social_dataset, name):
    (_, _, jmodel), (_, data, model) = _both(toy_social_dataset, name)
    params = jmodel.init(jax.random.PRNGKey(0))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(v.shape) for n, v in params.items()}
    assert list(got) == list(params)
    assert got["P"] == (data.user_nums + 1, 16)    # the sentinel friend row
    assert model.sampler == "pairwise" and model.pairwise_grouped
    assert model.fused_protocol is None


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax(toy_social_dataset, name, grouped):
    (_, _, jmodel), (_, data, model) = _both(toy_social_dataset, name)
    params = _params(jmodel, 3)
    load_params(model, {k: _np(v) for k, v in params.items()})
    j_aux, aux = _aux(data)
    rng = np.random.default_rng(8)
    batch = (_grouped_batch if grouped else _flat_batch)(rng, data)
    j_loss = jmodel.loss_grouped_pairwise if grouped else jmodel.loss
    want, grads = jax.value_and_grad(j_loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, j_aux)
    loss_fn = model.loss_grouped_pairwise if grouped else model.loss
    loss = loss_fn({k: torch.as_tensor(v) for k, v in batch.items()}, aux)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(grads[n]), rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    # The sentinel friend row is read (a zero row's share of attention)
    # but takes no gradient.
    assert float(model.P.grad[-1].abs().max()) == 0.0


@pytest.mark.parametrize("name", MODELS)
def test_scores_match_jax(toy_social_dataset, name):
    (_, _, jmodel), (_, data, model) = _both(toy_social_dataset, name,
                                             stddev="0.5")
    params = _params(jmodel, 4)
    load_params(model, {k: _np(v) for k, v in params.items()})
    j_aux, aux = _aux(data)
    rng = np.random.default_rng(9)
    u = rng.integers(0, data.user_nums, 12).astype(np.int32)
    i = rng.integers(0, data.item_nums, 12).astype(np.int32)
    cand = rng.integers(0, data.item_nums, (12, 7)).astype(np.int32)
    ju, tu = jnp.asarray(u), torch.as_tensor(u).long()

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-7)

    with torch.no_grad():
        close(model.score_pairs(tu, torch.as_tensor(i).long(), aux),
              jmodel.score_pairs(params, ju, jnp.asarray(i), j_aux))
        close(model.score_candidates(tu, torch.as_tensor(cand).long(), aux),
              jmodel.score_candidates(params, ju, jnp.asarray(cand), j_aux))
        close(model.score_all(tu, aux), jmodel.score_all(params, ju, j_aux))
        for got, want in zip(model.dot_decomposition(tu, aux),
                             jmodel.dot_decomposition(params, ju, j_aux)):
            close(got, want)


def test_grouped_loss_equals_flat(toy_social_dataset):
    """The grouped loss on one grouped batch equals the flat loss on its
    cells as flat rows (tests/test_models.py:285-310), and so do their
    gradients: the port against itself."""
    (_, _, _), (_, data, model) = _both(toy_social_dataset)
    _, aux = _aux(data)
    model.init(torch.Generator().manual_seed(3))
    b = _grouped_batch(np.random.default_rng(3), data)
    t = b["gi"].shape[1]
    flat = {"u": np.repeat(b["gu"], t),
            "i": np.minimum(b["gi"], data.item_nums - 1).reshape(-1),
            "j": b["gj"].reshape(-1), "w": b["gw"].reshape(-1)}
    losses, grads = [], []
    for fn, batch in ((model.loss_grouped_pairwise, b), (model.loss, flat)):
        loss = fn({k: torch.as_tensor(v) for k, v in batch.items()}, aux)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
        losses.append(float(loss.detach()))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    for g, f in zip(*grads):
        np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=1e-4,
                                   atol=1e-7)


def test_samn_needs_social_file(toy_dataset):
    cfg = Config(base_config(toy_dataset, **{
        k: v for k, v in TRAIN.items() if k != "social_file"},
        recommender="SAMN").to_dict())
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    with pytest.raises(ValueError, match="social_file"):
        Trainer(model, data, cfg, device="cpu")


@pytest.mark.parametrize("batch_size", ["64", "256", "6144"])
def test_grouped_grid_matches_jax(toy_social_dataset, batch_size):
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(
        toy_social_dataset, neg_ratio="3", batch_size=batch_size)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    for name in ("pg_user", "pg_pos", "pg_w"):
        np.testing.assert_array_equal(tr._grid[name], _np(j_tr.arrays[name]),
                                      err_msg=name)
    per_step = max(int(batch_size) // 128, 1)
    assert tr.steps_per_epoch * per_step == tr._grid["pg_user"].shape[0]
    # Every train pair fills neg_ratio valid cells of its user's groups.
    w = tr._grid["pg_w"]
    assert w.sum() == 3 * len(data_pairs(data))
    users = np.repeat(tr._grid["pg_user"], w.shape[1])[w.reshape(-1) > 0]
    items = tr._grid["pg_pos"].reshape(-1)[w.reshape(-1) > 0]
    assert sorted(zip(users, items)) == sorted(3 * data_pairs(data))


def data_pairs(data):
    return [(u, i) for u, items in data.ui_train.items() for i in items]


def _jax_grouped_draws(j_tr, key):
    """The draws of JAX's grouped epoch for ``key``
    (cleverrec_tpu/train/trainer.py:1895-1912): a negative a cell from
    the complement table, and the groups' permutation."""
    arrays = j_tr.arrays
    jkey, pkey, _ = jax.random.split(key, 3)
    seen = arrays["seen"]
    assert seen.complement is not None
    gus, pos = arrays["pg_user"], arrays["pg_pos"]
    g_pad, tc = pos.shape
    r = jax.random.randint(jkey, (g_pad, tc), 0, jnp.iinfo(jnp.int32).max,
                           dtype=jnp.int32)
    idx = r % arrays["pg_nun"][:, None]
    j = seen.complement.reshape(-1)[gus[:, None] * seen.complement.shape[1]
                                    + idx]
    j = jnp.where(arrays["pg_w"] > 0, j, j_tr.dd.item_nums)
    return idx, j, jax.random.permutation(pkey, g_pad)


@pytest.mark.parametrize("name", MODELS)
def test_grouped_step_on_jax_draws_matches_jax(toy_social_dataset, name):
    """One grouped step (batch 6144: every toy group in one step) from
    JAX's parameters and Adagrad state, on JAX's negatives and
    permutation: the port's parameters, accumulators and loss follow
    JAX's.  The port's rank draw resolves JAX's ranks to JAX's ids."""
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(
        toy_social_dataset, name, batch_size="6144")
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    assert tr.steps_per_epoch == 1
    params, state = j_tr.init_state()
    params, state, _ = j_tr.train_epoch(params, state)
    p0 = {k: np.array(v) for k, v in params.items()}
    s0 = {k: np.array(v) for k, v in state[0].sum_of_squares.items()}
    key = jax.random.PRNGKey(11)
    idx, j, perm = _jax_grouped_draws(j_tr, key)
    w = _np(j_tr.arrays["pg_w"])
    got_j = sampling.unseen_by_rank(tr._neg_rows, tr._neg_lens,
                                    torch.as_tensor(tr._grid["pg_user"]),
                                    _t(idx))
    np.testing.assert_array_equal(got_j.numpy()[w > 0], _np(j)[w > 0])
    want_p, want_s, want_loss = j_tr._epoch_body(
        {k: jnp.asarray(v) for k, v in p0.items()}, state, key, j_tr.arrays)

    load_params(model, p0)
    t_state = adagrad_state_from_jax(s0, "cpu", model=model)
    got_p, got_s, loss = tr._run_epoch(
        dict(model.named_parameters()), t_state,
        {"j": _t(j), "perm": _t(perm).reshape(1, -1)})
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k in p0:
        np.testing.assert_allclose(got_p[k].detach().numpy(), _np(want_p[k]),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(got_s.sum_of_squares[k].numpy(),
                                   _np(want_s[0].sum_of_squares[k]),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                   err_msg=k)


def test_flat_epoch_on_jax_draws_matches_jax(toy_social_dataset):
    """``train.grouped_pairs=False``: the flat scan tier with the pairwise
    sampler, one epoch on JAX's draw, from JAX's state one epoch in."""
    flat = {"train.grouped_pairs": "False"}
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(toy_social_dataset,
                                                      **flat)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    assert "pg_user" not in j_tr.arrays
    tr = Trainer(model, data, cfg, device="cpu")
    assert tr._grid is None and not tr.fused
    assert tr.steps_per_epoch == j_tr.steps_per_epoch
    params, state = j_tr.init_state()
    params, state, _ = j_tr.train_epoch(params, state)
    p0 = {k: np.array(v) for k, v in params.items()}
    s0 = {k: np.array(v) for k, v in state[0].sum_of_squares.items()}
    key = jax.random.PRNGKey(5)
    build_xs, run_scan = j_tr._scan_parts[:2]
    xs = build_xs(key, j_tr.arrays)
    want_p, want_s, losses = run_scan(
        {k: jnp.asarray(v) for k, v in p0.items()}, state, xs, j_tr.arrays,
        lambda batch: batch)
    load_params(model, p0)
    got_p, got_s, loss = tr._run_epoch(
        dict(model.named_parameters()),
        adagrad_state_from_jax(s0, "cpu", model=model),
        {k: _t(v) for k, v in xs[0].items()})
    assert float(loss) == pytest.approx(float(jnp.mean(losses)), rel=1e-5)
    for k in p0:
        np.testing.assert_allclose(got_p[k].detach().numpy(), _np(want_p[k]),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(got_s.sum_of_squares[k].numpy(),
                                   _np(want_s[0].sum_of_squares[k]),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("grouped", ["True", "False"])
@pytest.mark.parametrize("name", MODELS)
def test_trains_and_evaluates(toy_social_dataset, name, grouped):
    """Both epochs train (tests/test_models.py:312): the loss falls, the
    grouped draw leaves pad cells at item_nums and valid ones unseen, and
    the metrics are finite."""
    (_, _, _), (cfg, data, model) = _both(
        toy_social_dataset, name, **{"train.grouped_pairs": grouped})
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = tr.init_state()
    if grouped == "True":
        draw = tr.sample_epoch()
        w = tr._grid["pg_w"] > 0
        j = draw["j"].numpy()
        assert (j[~w] == data.item_nums).all()
        users = np.repeat(tr._grid["pg_user"], w.shape[1]).reshape(w.shape)
        assert not any(jj in data.ui_train[uu]
                       for uu, jj in zip(users[w], j[w]))
        assert sorted(draw["perm"].reshape(-1).tolist()) == list(
            range(len(tr._grid["pg_user"])))
    params, state, losses = tr.train_epochs(params, state, 3)
    assert losses[-1] < losses[0], losses
    for hr, mrr, ndcg in tr.evaluate().values():
        assert 0.0 <= hr <= 1.0 and np.isfinite(ndcg)


def test_cli_trains_samn(toy_social_dataset, tmp_path, capsys):
    """SAMN through the CLI on conf/SAMN.properties, cut to the toy."""
    props = tmp_path / "global.properties"
    props.write_text("\n".join([
        "[default]", "recommender=BPR", "model_type=ranking",
        f"data.root_dir={toy_social_dataset['root']}",
        f"data.dataset={toy_social_dataset['name']}",
        "data.file_name=ratings.csv", "data.sep=,", "data.format=UIRT",
        "data.split_way=loo", "test.neg_samples=10", "test.batch_size=16",
        "topk=[5,10]", f"log.dir={tmp_path / 'logs'}", "seed=7", ""]))
    logger = logging.getLogger("cleverrec_tpu_torch.SAMN")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    def drop():
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()

    drop()
    try:
        get_logger(str(tmp_path / "logs"), "SAMN")
        logger.addHandler(Keep())
        rc = cli.main(["--config", str(props), "--conf-dir",
                       os.path.join(REPO, "conf"), "--model", "SAMN",
                       "--device", "cpu", "--set", "epoches=3",
                       "--set", "batch_size=256", "--set", "embed_size=16"])
    finally:
        drop()
    assert rc == 0
    out = capsys.readouterr().out
    assert "grouped pairwise epoch" in out and "best_epoch: " in out
    epochs = [r.train for r in records if hasattr(r, "train")]
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    assert epochs[-1]["losses"][-1] < epochs[0]["losses"][0]
