"""Checkpoints, resume, warm starts and tuning in the port: a save/load
round trip, a resumed run equal to an uninterrupted one bit for bit on
the CPU (generators included), ``save.best``, the crash-safe write, the
NeuMF and NAIS grafts against the JAX package's, the warm-started NeuMF,
and ``tuning.py`` against the JAX package's grid and order."""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu import tuning as j_tuning
from cleverrec_tpu.config import Config as JConfig
from cleverrec_tpu.train import checkpoint as j_checkpoint
from cleverrec_tpu_torch import tuning
from cleverrec_tpu_torch.common import AdagradState, AdamState
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.train import Trainer, checkpoint
from tests.conftest import base_config

BPR = {"epoches": "4", "batch_size": "64", "embed_size": "8", "lr": "0.05",
       "neg_ratio": "2", "reg": "0.01", "stddev": "0.1"}
SAMN = {**BPR, "recommender": "SAMN", "optimizer": "Adagrad",
        "mem_size": "4", "atten_size": "4", "reg1": "0.01", "reg2": "0.01",
        "social_file": "trusts.csv", "neg_ratio": "1"}
NCF = {"is_pairwise": "False", "loss_func": "cross_entropy", "reg": "0.01",
       "reg1": "0.01", "reg2": "0.01", "epoches": "1", "batch_size": "64",
       "lr": "0.05", "neg_ratio": "1", "stddev": "0.1", "layers": "[16,8]"}


def _trainer(toy, tmp_path=None, **overrides):
    values = dict(overrides)
    if tmp_path is not None:
        values["saved_dir"] = str(tmp_path / "saved")
    cfg = Config(base_config(toy, **values).to_dict())
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return Trainer(model, data, cfg, device="cpu")


def _params(trainer):
    return {k: p.detach().clone()
            for k, p in trainer.model.named_parameters()}


def test_save_load_round_trip(toy_dataset, tmp_path):
    tr = _trainer(toy_dataset, **BPR)
    params, state = tr.init_state()
    params, state, _ = tr.train_epoch(params, state)
    path = tr.save(str(tmp_path / "ck"), params, state, 1)
    saved = checkpoint.load_checkpoint(path)
    assert saved["epoch"] == 1 and saved["opt_state"]["count"] == state.count
    for k, p in params.items():
        assert torch.equal(saved["params"][k], p.detach())
        assert torch.equal(saved["opt_state"]["mu"][k], state.mu[k])
        assert torch.equal(checkpoint.load_params(path)[k], p.detach())
    assert torch.equal(saved["rng"]["sampler"], tr._gen.get_state())
    # Into a fresh trainer of the same model: everything as saved.
    tr2 = _trainer(toy_dataset, **BPR)
    p2, s2, epoch = tr2.resume(path)
    assert epoch == 1 and isinstance(s2, AdamState)
    assert s2.count == state.count
    for k in params:
        assert torch.equal(p2[k].detach(), params[k].detach())
        assert torch.equal(s2.nu[k], state.nu[k])
    assert torch.equal(tr2._gen.get_state(), tr._gen.get_state())


def test_adagrad_state_round_trips(toy_social_dataset, tmp_path):
    tr = _trainer(toy_social_dataset, **SAMN)
    params, state = tr.init_state()
    params, state, _ = tr.train_epoch(params, state)
    path = tr.save(str(tmp_path / "ck"), params, state, 1)
    p2, s2, _ = _trainer(toy_social_dataset, **SAMN).resume(path)
    assert isinstance(s2, AdagradState)
    for k in params:
        assert torch.equal(s2.sum_of_squares[k], state.sum_of_squares[k])


def test_resume_refuses_another_model(toy_dataset, tmp_path):
    tr = _trainer(toy_dataset, **BPR)
    params, state = tr.init_state()
    path = tr.save(str(tmp_path / "ck"), params, state, 0)
    with pytest.raises(ValueError, match="shape"):
        _trainer(toy_dataset, **{**BPR, "embed_size": "16"}).resume(path)
    with pytest.raises(ValueError, match="adagrad"):
        _trainer(toy_dataset, **{**BPR, "optimizer": "Adagrad"}).resume(path)
    with pytest.raises(FileNotFoundError):
        tr.resume(str(tmp_path / "missing"))


@pytest.mark.parametrize("case", ["BPR_scan", "BPR_fused", "SAMN"])
def test_resumed_run_equals_uninterrupted(toy_dataset, toy_social_dataset,
                                          tmp_path, case):
    """Two epochs with ``save.best``, then ``run(resume_from=...)`` from
    the saved epoch to 4, against 4 epochs in one run: the same
    parameters and optimizer state, bit for bit."""
    toy, opts = {"BPR_scan": (toy_dataset, BPR),
                 "BPR_fused": (toy_dataset, {**BPR,
                                             "train.fused_kernel": "True"}),
                 "SAMN": (toy_social_dataset, SAMN)}[case]
    whole = _trainer(toy, **opts)
    whole.run()
    first = _trainer(toy, tmp_path, **{**opts, "epoches": "2",
                                       "save.best": "True"})
    best = first.run()
    path = os.path.join(str(tmp_path / "saved"), first.model.name)
    assert checkpoint.load_checkpoint(path)["epoch"] == best["epoch"] >= 1
    rest = _trainer(toy, **opts)
    rest.run(resume_from=path)
    assert rest.fused == whole.fused == (case == "BPR_fused")
    for k, v in _params(whole).items():
        assert torch.equal(rest.model.state_dict()[k], v), k
    got, want = (checkpoint.optimizer_state_dict(t.opt_state)
                 for t in (rest, whole))
    for part in ("mu", "nu", "sum_of_squares"):
        for k, v in want.get(part, {}).items():
            assert torch.equal(got[part][k], v), (part, k)
    assert got.get("count") == want.get("count")


def test_save_best_writes_the_best_epoch(toy_dataset, tmp_path):
    tr = _trainer(toy_dataset, tmp_path, **{**BPR, "save.best": "True"})
    best = tr.run()
    path = os.path.join(str(tmp_path / "saved"), "BPR")
    saved = checkpoint.load_checkpoint(path)
    assert saved["epoch"] == best["epoch"] > 0
    # The best epoch's parameters: a run cut there ends with them.
    cut = _trainer(toy_dataset, **{**BPR, "epoches": str(best["epoch"])})
    cut.run()
    for k, v in _params(cut).items():
        assert torch.equal(saved["params"][k], v), k
    assert sorted(os.listdir(tmp_path / "saved")) == ["BPR"]


def test_save_is_crash_safe(toy_dataset, tmp_path):
    """A stale in-progress copy is replaced; the old checkpoint is swapped
    out only after the new one is written; nothing else is left."""
    tr = _trainer(toy_dataset, **BPR)
    params, state = tr.init_state()
    where = tmp_path / "ckpts"
    path = str(where / "ck")
    os.makedirs(path + ".inprogress")
    (where / "ck.inprogress" / "junk").write_text("x")
    tr.save(path, params, state, 1)
    tr.save(path, params, state, 2)
    assert sorted(os.listdir(where)) == ["ck"]
    assert os.listdir(path) == [checkpoint.STATE_FILE]
    assert checkpoint.load_checkpoint(path)["epoch"] == 2


def _np_tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


def test_graft_neumf_matches_jax():
    rng = np.random.default_rng(0)
    neumf = _np_tree(rng, {"P_gmf": (5, 4), "Q_gmf": (7, 4), "P_mlp": (5, 8),
                           "Q_mlp": (7, 8), "W_0": (16, 8), "b_0": (8,),
                           "W_1": (8, 4), "b_1": (4,), "h_gmf": (4,),
                           "h_mlp": (4,), "h_neumf": (8,)})
    gmf = _np_tree(rng, {"P": (5, 4), "Q": (7, 4), "h_gmf": (4,)})
    mlp = _np_tree(rng, {"P": (5, 8), "Q": (7, 8), "W_0": (16, 8),
                         "b_0": (8,), "W_1": (8, 4), "b_1": (4,),
                         "h_mlp": (4,)})

    def tree(d, f):
        return {k: f(v) for k, v in d.items()}

    want = j_checkpoint.graft_neumf(*(tree(d, jnp.asarray)
                                      for d in (neumf, gmf, mlp)))
    got = checkpoint.graft_neumf(*(tree(d, torch.as_tensor)
                                   for d in (neumf, gmf, mlp)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    deeper = {**mlp, "W_2": np.zeros((4, 2), np.float32)}
    for bad in (deeper, {**mlp, "W_1": np.zeros((8, 3), np.float32)}):
        with pytest.raises(ValueError, match="layers config mismatch"):
            checkpoint.graft_neumf(*(tree(d, torch.as_tensor)
                                     for d in (neumf, gmf, bad)))


def test_graft_nais_matches_jax():
    rng = np.random.default_rng(1)
    nais = _np_tree(rng, {"P": (6, 4), "Q": (6, 4), "bias": (6,),
                          "W": (4, 3), "h": (3,)})
    fism = _np_tree(rng, {"P": (6, 4), "Q": (6, 4), "b": (6,)})
    want = j_checkpoint.graft_nais({k: jnp.asarray(v) for k, v in
                                    nais.items()},
                                   {k: jnp.asarray(v) for k, v in
                                    fism.items()})
    got = checkpoint.graft_nais({k: torch.as_tensor(v) for k, v in
                                 nais.items()},
                                {k: torch.as_tensor(v) for k, v in
                                 fism.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def _pretrained(toy, tmp_path, name, **extra):
    tr = _trainer(toy, **{**NCF, "recommender": name, "embed_size": "8",
                          **extra})
    params, state = tr.init_state()
    params, state, _ = tr.train_epoch(params, state)
    return tr.save(str(tmp_path / name), params, state, 1), _params(tr)


def test_warm_started_neumf_trains(toy_dataset, tmp_path):
    """NeuMF from a GMF and an MLP trained an epoch each: its initial
    parameters are the graft, it trains, and its first epoch's loss is
    below a cold start's."""
    gmf_path, gmf = _pretrained(toy_dataset, tmp_path, "GMF")
    mlp_path, mlp = _pretrained(toy_dataset, tmp_path, "MLP")
    opts = {**NCF, "recommender": "NeuMF", "embed_size": "8", "epoches": "3"}
    warm = _trainer(toy_dataset, **opts, gmf_pretrain=gmf_path,
                    mlp_pretrain=mlp_path)
    params, state = warm.init_state()
    want = checkpoint.graft_neumf(_params(_trainer(toy_dataset, **opts)),
                                  gmf, mlp)
    for k, v in want.items():
        assert torch.equal(params[k].detach(), v), k
    params, state, losses = warm.train_epochs(params, state, 3)
    assert losses[-1] < losses[0]
    cold = _trainer(toy_dataset, **opts)
    p, s = cold.init_state()
    assert losses[0] < cold.train_epoch(p, s)[2]


@pytest.mark.parametrize("name,keys", [
    ("NeuMF", ("gmf_pretrain",)), ("NeuMF", ("mlp_pretrain",)),
    ("GMF", ("gmf_pretrain",)), ("MLP", ("gmf_pretrain", "mlp_pretrain"))])
def test_warm_start_keys_the_model_does_not_take_raise(toy_dataset, name,
                                                        keys):
    """Half of NeuMF's pair, or a warm-start key on a model without a
    warm start, raises rather than train from a cold start (the JAX
    package ignores them)."""
    with pytest.raises(ValueError, match=f"{keys[0]}.*{name} warm-starts"):
        _trainer(toy_dataset, **NCF, recommender=name, embed_size="8",
                 **{k: "ckpt" for k in keys})


GRIDS = ({"embed_size": "[8,16]"}, {"embed_size": "8", "reg": "[0.1,0.01]"},
         {"embed_size": "[8, 16]", "reg": "0.01", "neg_ratio": "[1,2,4]"},
         {"embed_size": "8"}, {"reg": "0.1,0.2"})


@pytest.mark.parametrize("values", GRIDS)
def test_grid_from_config_matches_jax(values):
    base = {"recommender": "BPR", "lr": "0.01"}
    assert tuning.grid_from_config(Config({**base, **values})) == \
        j_tuning.grid_from_config(JConfig({**base, **values}))


def test_run_grid_order_and_pick(toy_dataset, monkeypatch):
    """Every combination in the JAX package's order (the product over the
    sorted axes), the best by NDCG@topk[0]; then one real 2 x 1 grid."""
    grid = {"reg": [0.1, 0.01], "embed_size": [8, 16]}
    cfg = Config(base_config(toy_dataset, **BPR).to_dict())
    want = [dict(zip(sorted(grid), c)) for c in itertools.product(
        *(grid[k] for k in sorted(grid)))]
    seen = []

    def fake_run(self, seed=None, resume_from=None):
        seen.append((self.cfg.float("reg"), self.cfg.int("embed_size")))
        return {"epoch": 1, "ndcg": self.cfg.int("embed_size")
                - self.cfg.float("reg"), "metrics": {}}

    monkeypatch.setattr(Trainer, "run", fake_run)
    top, results = tuning.run_grid(cfg, grid=grid, device="cpu")
    assert [r["params"] for r in results] == want
    assert seen == [(p["reg"], p["embed_size"]) for p in want]
    assert top["params"] == {"embed_size": 16, "reg": 0.01}
    monkeypatch.undo()
    top, results = tuning.run_grid(cfg.with_overrides(
        embed_size="[8,16]", epoches="2"), device="cpu")
    assert [r["params"] for r in results] == [{"embed_size": 8},
                                              {"embed_size": 16}]
    assert top["best"]["ndcg"] == max(r["best"]["ndcg"] for r in results)
    assert all(0 < r["best"]["ndcg"] <= 1 for r in results)
    with pytest.raises(ValueError, match="no grid axes"):
        tuning.run_grid(cfg, device="cpu")
