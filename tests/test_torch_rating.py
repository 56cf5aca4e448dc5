"""The rating path in the port against the JAX package: the libFM loader
in both token modes on ragged rows, the featurizer's files byte for
byte, FM's and FFM's predictions, losses and gradients on carried
weights (FFM also against its O(F^2) pair loop), one epoch on JAX's own
order and weights, both packages' whole runs on the same toy files, the
CLI on ``model_type=rating`` and tuning over a rating grid."""

import itertools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cleverrec_tpu import rating as j_rating
from cleverrec_tpu.config import Config as JConfig
from cleverrec_tpu.data import fm_convert as j_fm_convert
from cleverrec_tpu.data.libfm import load_rating_data as j_load_rating_data
from cleverrec_tpu_torch import cli, rating, tuning
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import fm_convert
from cleverrec_tpu_torch.data.libfm import load_rating_data
from cleverrec_tpu_torch.metrics import rmse_mae
from cleverrec_tpu_torch.weights import load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("FM", "FFM")
# The confs cut to the toy: embed 4, batch 128; lr 0.01 and stddev 0.1 so
# that a toy epoch moves the tables past Adam's first-step lr * sign(g).
TOY = {"model_type": "rating", "dataset": "toyfm", "train": ".train.libfm",
       "test": ".test.libfm", "is_real_valued": "True", "epoches": "10",
       "batch_size": "128", "test.batch_size": "100", "embed_size": "4",
       "reg": "0.001", "lr": "0.01", "optimizer": "Adam",
       "loss_func": "square", "init_method": "normal", "stddev": "0.1",
       "seed": "3"}
# Predictions, losses and gradients: f32 sums of a few terms in another
# order.
RTOL, ATOL = 1e-5, 1e-6
# One epoch of 16 Adam steps: the rounding above carried through them.
EPOCH_RTOL, EPOCH_ATOL = 1e-4, 1e-5
# Whole runs, port against JAX: other draws from the same seed, each run
# taken to the toy's noise floor (label noise 0.1), lr as
# tests/test_rating.py's.
RUN = {"epoches": "15", "lr": "0.05"}
RUN_BAND = 0.02
RAGGED = {"train": "3.5,1:0.5,7:1,x\n4,2:1\n\n1.0,a,b:2,c:0.25,1:1\n"
                   "2.25,7:3\n",
          "test": "5,z:1,1:2\n1.5,x\n"}


def _values(root, name, **overrides):
    values = dict(TOY, recommender=name, **{"data.root_dir": root,
                                            "data.dataset": TOY["dataset"]})
    values.pop("dataset")
    values.update(overrides)
    return values


def _configs(root, name, **overrides):
    values = _values(root, name, **overrides)
    return JConfig(values), Config(values)


def _write_toy(ds, n_users=20, n_items=30, seed=0):
    """One-hot (user, item) rows with planted biases, as
    tests/test_rating.py's toy."""
    r = np.random.default_rng(seed)
    u_bias, i_bias = r.normal(0, 1, n_users), r.normal(0, 1, n_items)

    def gen(n_rows):
        lines = []
        for _ in range(n_rows):
            u, i = r.integers(n_users), r.integers(n_items)
            y = 3.0 + u_bias[u] + i_bias[i] + r.normal(0, 0.1)
            lines.append(f"{y:.3f},{u}:1,{n_users + i}:1")
        return "\n".join(lines) + "\n"

    (ds / "toyfm.train.libfm").write_text(gen(2000))
    (ds / "toyfm.test.libfm").write_text(gen(300))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("rating")
    (base / "toyfm").mkdir()
    _write_toy(base / "toyfm")
    (base / "ragged").mkdir()
    for part, text in RAGGED.items():
        (base / "ragged" / f"ragged.{part}.libfm").write_text(text)
    return str(base)


def _np(x):
    return np.asarray(x)


def _batch(n_feat, width, bsz=6, seed=7):
    """Random real-valued rows wider than FFM's fields, the pad id among
    them (value 0 there, as the loader pads)."""
    rng = np.random.default_rng(seed)
    x_idx = rng.integers(0, n_feat + 1, (bsz, width)).astype(np.int32)
    x_val = rng.normal(size=(bsz, width)).astype(np.float32)
    x_val[x_idx == n_feat] = 0.0
    y = rng.normal(3.0, 1.0, bsz).astype(np.float32)
    w = np.ones(bsz, np.float32)
    w[-1] = 0.0
    return x_idx, x_val, y, w


N_FEAT, N_FIELDS, WIDTH = 12, 3, 5


def _j_model(jcfg, name):
    if name == "FFM":
        return j_rating.FFM(jcfg, N_FEAT, N_FIELDS)
    return j_rating.FM(jcfg, N_FEAT)


@pytest.fixture(scope="module")
def jax_runs(root):
    """Every JAX run the tests read, once: its loader on the ragged files,
    FM's and FFM's predictions, losses and gradients on one batch, one
    epoch of each from its initial parameters (with its own order and
    weights), and each whole run on the toy files."""
    out = {"loaders": {}, "models": {}, "epochs": {}, "runs": {}}
    for real in (True, False):
        out["loaders"][real] = j_load_rating_data(JConfig(_values(
            root, "FM", **{"data.dataset": "ragged",
                           "is_real_valued": str(real)})))
    batch = _batch(N_FEAT, WIDTH)
    for name in MODELS:
        jcfg, _ = _configs(root, name)
        jmodel = _j_model(jcfg, name)
        params = jmodel.init(jax.random.PRNGKey(0))
        xi, xv, y, w = map(jnp.asarray, batch)
        (loss, y_pre), grads = jax.value_and_grad(
            lambda p: jmodel.loss(p, xi, xv, y, w), has_aux=True)(params)
        out["models"][name] = {
            "params": {k: _np(v) for k, v in params.items()},
            "predict": _np(jmodel.predict(params, xi, xv)),
            "loss": float(loss), "y_pre": _np(y_pre),
            "grads": {k: _np(v) for k, v in grads.items()}}

        data = j_load_rating_data(jcfg)
        jmodel = j_rating.make_rating_model(jcfg, data)
        tr = j_rating.FMTrainer(jmodel, data, jcfg)
        params = jmodel.init(jax.random.PRNGKey(1))
        # The epoch donates params and opt_state: copy them out first.
        start = {k: _np(v).copy() for k, v in params.items()}
        params, _, loss, order, w, y_pres = tr._epoch(
            params, tr.optimizer.init(params), jax.random.PRNGKey(2),
            tr._xi, tr._xv, tr._y)
        order, w, y_pres = _np(order), _np(w), _np(y_pres)
        keep = w.reshape(-1) > 0
        out["epochs"][name] = {
            "start": start, "order": order, "w": w,
            "params": {k: _np(v) for k, v in params.items()},
            "loss": float(loss),
            "rmse": rmse_mae(data.y_tr[order.reshape(-1)[keep]],
                             y_pres.reshape(-1)[keep])}
        out["runs"][name] = j_rating.run_rating(
            jcfg.with_overrides(**RUN))
    return out


@pytest.mark.parametrize("real", [True, False])
def test_loader_matches_jax(root, jax_runs, real):
    """One feature map over train then test, bare tokens (and, in one-hot
    mode, every token) at value 1, ragged rows padded with feature_nums
    and value 0; the same dtypes."""
    want = jax_runs["loaders"][real]
    got = load_rating_data(Config(_values(
        root, "FM", **{"data.dataset": "ragged",
                       "is_real_valued": str(real)})))
    assert got.feature_nums == want.feature_nums == (8 if real else 11)
    assert got.is_real_valued == want.is_real_valued == real
    for key in ("x_idx_tr", "x_val_tr", "y_tr", "x_idx_t", "x_val_t",
                "y_t"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert got.x_idx_tr.shape == (4, 4)


TABLES = {
    # A header line, integer ratings: labels written "5".
    "header": ("ratings.csv", ",", "u_id,i_id,rating,time\n",
               lambda r, u, i: f"{u},{i},{r.integers(1, 6)},{r.integers(9)}"),
    # Headerless (u.data's layout): the first row is a rating, kept.
    "headerless": ("u.data", "\t", "",
                   lambda r, u, i: f"{u}\t{i}\t{r.integers(1, 6)}\t7"),
    # Fractional ratings (labels "4.0", "3.5"), '::', CRLF, extra fields.
    "fractional": ("ratings.dat", "::", "",
                   lambda r, u, i: f"{u}::{i}::{r.integers(2, 11) / 2}"
                                   "::1::x\r"),
}


@pytest.mark.parametrize("kind", sorted(TABLES))
def test_featurizer_writes_the_jax_files(tmp_path, kind):
    file_name, sep, head, line = TABLES[kind]
    r = np.random.default_rng(4)
    rows = [line(r, 100 + r.integers(15), 7 * r.integers(20))
            for _ in range(90)]
    out = {}
    for who, mod in (("jax", j_fm_convert), ("port", fm_convert)):
        ds = tmp_path / who / "ds"
        ds.mkdir(parents=True)
        (ds / file_name).write_text(head + "\n".join(rows) + "\n")
        paths = mod.convert_dataset(str(tmp_path / who), "ds", file_name,
                                    sep, test_size=0.25, seed=5)
        out[who] = [open(p, "rb").read() for p in paths]
    assert out["port"] == out["jax"]
    lines = b"".join(out["port"]).decode().splitlines()
    assert len(lines) == 90                 # no row taken for a header
    labels = {ln.split(",")[0] for ln in lines}
    assert any("." in x for x in labels) == (kind == "fractional")


def test_interactions_to_libfm_matches_jax(tmp_path):
    """The columns' own dtypes: int64 ids, float64 labels."""
    r = np.random.default_rng(0)
    cols = {"u_id": r.integers(0, 25, 200), "i_id": r.integers(5, 45, 200),
            "rating": r.integers(1, 6, 200).astype(np.float64)}
    got = fm_convert.interactions_to_libfm(
        cols, str(tmp_path / "p" / "tr"), str(tmp_path / "p" / "t"),
        test_size=0.2, seed=1)
    want = j_fm_convert.interactions_to_libfm(
        pd.DataFrame(cols), str(tmp_path / "j" / "tr"),
        str(tmp_path / "j" / "t"), test_size=0.2, seed=1)
    assert got == want == (160, 40)
    for part in ("tr", "t"):
        assert (tmp_path / "p" / part).read_bytes() == \
            (tmp_path / "j" / part).read_bytes()


def _port_model(root, name):
    _, cfg = _configs(root, name)
    if name == "FFM":
        return rating.FFM(cfg, N_FEAT, N_FIELDS)
    return rating.FM(cfg, N_FEAT)


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(root, jax_runs, name):
    """predict, loss (its y_pre too) and every gradient on JAX's
    parameters, carried across by load_params."""
    want = jax_runs["models"][name]
    model = _port_model(root, name)
    load_params(model, want["params"])
    xi, xv, y, w = (torch.as_tensor(a) for a in _batch(N_FEAT, WIDTH))
    xi = xi.long()
    np.testing.assert_allclose(model.predict(xi, xv).detach().numpy(),
                               want["predict"], rtol=RTOL, atol=ATOL)
    loss, y_pre = model.loss(xi, xv, y, w)
    np.testing.assert_allclose(float(loss.detach()), want["loss"],
                               rtol=RTOL)
    np.testing.assert_allclose(y_pre.detach().numpy(), want["y_pre"],
                               rtol=RTOL, atol=ATOL)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert sorted(names) == sorted(want["grads"]) == ["vif", "w0", "wi"]
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want["grads"][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_ffm_matches_the_pair_loop(root):
    """FFM's field-grouped einsums equal the O(F^2) definition
    sum_{a<b} <v[x_a, field_b], v[x_b, field_a]> x_a x_b on rows with more
    positions than fields (tests/test_rating.py:74)."""
    model = _port_model(root, "FFM")
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p in (model.wi, model.vif):
            p.copy_(torch.as_tensor(rng.normal(size=p.shape),
                                    dtype=torch.float32))
    xi, xv, _, _ = (torch.as_tensor(a) for a in _batch(N_FEAT, WIDTH))
    xi = xi.long()
    with torch.no_grad():
        v = model.vif[xi]
        want = model.w0 + (model.wi[xi] * xv).sum(dim=1)
        for a, b in itertools.combinations(range(WIDTH), 2):
            fa, fb = min(a, N_FIELDS - 1), min(b, N_FIELDS - 1)
            inter = (v[:, a, fb, :] * v[:, b, fa, :]).sum(dim=1)
            want = want + inter * xv[:, a] * xv[:, b]
        np.testing.assert_allclose(model.predict(xi, xv).numpy(),
                                   want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", MODELS)
def test_init_shapes_and_zero_rows(root, name):
    """The JAX shapes (rows: feature_nums + 1 rounded up to 8), w0 zero,
    rows past the pad row zero, and one seed one draw."""
    _, cfg = _configs(root, name)
    data = load_rating_data(cfg)
    model = rating.make_rating_model(cfg, data)
    rows = -(-(data.feature_nums + 1) // 8) * 8
    want = {"w0": (), "wi": (rows,), "vif": (rows, 4) if name == "FM"
            else (rows, 2, 4)}
    model.init(torch.Generator().manual_seed(0))
    first = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert {n: tuple(p.shape) for n, p in first.items()} == want
    assert float(first["w0"]) == 0.0
    live = data.feature_nums + 1
    assert not first["wi"][live:].any() and not first["vif"][live:].any()
    assert first["vif"][:live].std() > 0.05
    model.init(torch.Generator().manual_seed(0))
    for n, p in model.named_parameters():
        assert torch.equal(p, first[n])


def test_load_params_takes_the_jax_names(root, jax_runs):
    """weights.load_params carries FM's and FFM's parameters by name and
    refuses a wrong shape."""
    for name in MODELS:
        model = _port_model(root, name)
        params = jax_runs["models"][name]["params"]
        load_params(model, params)
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), params[n])
    with pytest.raises(ValueError, match="vif"):
        load_params(_port_model(root, "FM"),
                    jax_runs["models"]["FFM"]["params"])


@pytest.mark.parametrize("name", MODELS)
def test_one_epoch_on_jax_draws(root, jax_runs, name):
    """From JAX's initial parameters, on JAX's own order and weights
    (padded slots weigh 0 and read row n - 1): the parameters, the mean
    loss and the in-flight training RMSE."""
    want = jax_runs["epochs"][name]
    _, cfg = _configs(root, name)
    data = load_rating_data(cfg)
    tr = rating.FMTrainer(rating.make_rating_model(cfg, data), data, cfg,
                          device="cpu")
    assert tr.steps == want["order"].shape[0] == 16
    assert (want["w"] == 0).sum() == 16 * 128 - 2000
    load_params(tr.model, want["start"])
    params = dict(tr.model.named_parameters())
    state = tr.optimizer.init(params)
    params, state, loss, order, w, y_pres = tr.train_epoch(
        params, state, order=want["order"].copy(), w=want["w"].copy())
    assert state.count == 16
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want["params"][n],
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                   err_msg=n)
    np.testing.assert_allclose(float(loss), want["loss"], rtol=EPOCH_RTOL,
                               atol=EPOCH_ATOL)
    np.testing.assert_allclose(tr.train_rmse(order, w, y_pres),
                               want["rmse"], rtol=EPOCH_RTOL,
                               atol=EPOCH_ATOL)


def test_epoch_order_pads_like_jax(root):
    """The port's own draw: a permutation of steps * batch slots, the
    slots >= n at weight 0 and clamped to row n - 1."""
    _, cfg = _configs(root, "FM")
    data = load_rating_data(cfg)
    tr = rating.FMTrainer(rating.make_rating_model(cfg, data), data, cfg,
                          device="cpu")
    tr.init_state()
    order, w = tr.epoch_order()
    assert order.shape == w.shape == (16, 128)
    n = len(data.y_tr)
    assert int((w == 0).sum()) == 16 * 128 - n
    assert (order[w == 0] == n - 1).all()
    assert sorted(order[w > 0].tolist()) == list(range(n))


@pytest.mark.parametrize("name", MODELS)
def test_run_matches_jax(root, jax_runs, name, caplog):
    """Both packages' whole runs on the same files: the best test RMSE
    within RUN_BAND, the loss falling, JAX's log lines."""
    _, cfg = _configs(root, name, **RUN)
    logger = logging.getLogger(f"test_torch_rating.{name}")
    with caplog.at_level(logging.INFO, logger=logger.name):
        best = rating.run_rating(cfg, logger=logger, device="cpu")
    want = jax_runs["runs"][name]
    assert abs(best["rmse"] - want["rmse"]) <= RUN_BAND, (best, want)
    assert 1 <= best["epoch"] <= 15 and best["rmse"] < 0.2
    records = caplog.records
    train = [r.train for r in records if hasattr(r, "train")]
    assert [t["epoch"] for t in train] == list(range(1, 16))
    assert train[-1]["loss"] < train[0]["loss"]
    assert train[-1]["rmse"] < train[0]["rmse"]
    assert records[-1].getMessage() == (
        f"best_epoch={best['epoch']}, best_rmse={best['rmse']:.4f}, "
        f"best_mae={best['mae']:.4f}")
    assert records[-1].best == best


def _drop_handlers(name):
    logger = logging.getLogger(f"cleverrec_tpu_torch.{name}")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


def test_cli_runs_rating_and_ignores_resume(root, tmp_path):
    """``model_type=rating`` trains and tests through the CLI on the CPU;
    --resume and --export-serving are ignored with a log line, as the JAX
    CLI ignores them; --mesh 2x1 in a world of one rank exits 2."""
    argv = ["--config", os.path.join(REPO, "CleverRec.properties"),
            "--conf-dir", os.path.join(REPO, "conf"), "--model", "FM",
            "--device", "cpu", "--set", "model_type=rating",
            "--set", f"data.root_dir={root}", "--set", "data.dataset=toyfm",
            "--set", "epoches=2", "--set", f"log.dir={tmp_path}"]
    _drop_handlers("FM")
    try:
        assert cli.main(argv + ["--resume", "nowhere",
                                "--export-serving", "out"]) == 0
    finally:
        _drop_handlers("FM")
    log = (tmp_path / "FM.log").read_text()
    assert "--resume/--export-serving are ignored with model_type=rating" \
        in log
    assert "Training epoch 2" in log and "best_epoch=" in log
    assert cli.main(argv + ["--mesh", "2x1"]) == 2


def test_tuning_ranks_a_rating_grid_by_rmse(root, monkeypatch):
    """A 2 x 1 grid of embed_size: one trial each in the JAX package's
    order, the best the lowest RMSE; then one real grid."""
    _, cfg = _configs(root, "FM", epoches="2")
    seen = []

    def fake_run(self, seed=None):
        seen.append(self.model.embed_size)
        return {"rmse": 1.0 / self.model.embed_size, "mae": 0.0, "epoch": 1}

    monkeypatch.setattr(rating.FMTrainer, "run", fake_run)
    top, results = tuning.run_grid(cfg, grid={"embed_size": [4, 8]},
                                   device="cpu")
    assert seen == [4, 8]
    assert top["params"] == {"embed_size": 8}
    monkeypatch.undo()
    top, results = tuning.run_grid(
        cfg.with_overrides(embed_size="[4,8]"), device="cpu")
    assert [r["params"] for r in results] == [{"embed_size": 4},
                                              {"embed_size": 8}]
    assert top["best"]["rmse"] == min(r["best"]["rmse"] for r in results)


def test_trainer_needs_a_card_by_default(root, monkeypatch):
    """The rating trainer's default device is the card: without one it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs(root, "FM")
    data = load_rating_data(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rating.FMTrainer(rating.make_rating_model(cfg, data), data, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rating.run_rating(cfg)
