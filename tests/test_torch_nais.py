"""NAIS and NAIS_single on their two tiers in the port against the JAX
package: one cold and one warm-started bucketed epoch on JAX's own draws
under Adagrad, one epoch of the flat pointwise tier on JAX's draw, both
tiers training, and the warm start from FISM through the CLI.
The files, configs, tolerances and helpers are tests/test_torch_itemsim.py's
(split from it to spread the tier-1 run's load)."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu.train.checkpoint import graft_nais as j_graft_nais
from cleverrec_tpu_torch import cli
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.checkpoint import (copy_into, load_params,
                                                  save_checkpoint)
from cleverrec_tpu_torch.utils.logging import get_logger
from cleverrec_tpu_torch.weights import adagrad_state_from_jax
from cleverrec_tpu_torch.weights import load_params as load_jax_params
from tests.test_torch_itemsim import (EPOCH_ATOL, EPOCH_RTOL, FISM_TRAIN,
                                      NAIS_MODELS, _both,
                                      _hold_bucketed_epoch, _nais_both, _np,
                                      _t)
from tests.test_torch_itemsim import histories  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drop_handlers(logger):
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


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
