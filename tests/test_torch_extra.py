"""WMF, DMF, SML and EATNN in the port against the JAX package: the
parameters, losses, gradients and scorers, one scan epoch on JAX's own
draws (SML's postprocess inside it, clipping margins onto the bounds;
EATNN at social_weight 0, where the edge draws cannot matter), SML's
gradient at margins exactly on its clip's bounds, DMF with a dead tower
row, EATNN's keyless hash and its per-step draws, an EATNN run resumed
equal to the uninterrupted one, and the decompositions of WMF, SML
(ascending) and EATNN through the fused rankers' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.evalx import Evaluator
from cleverrec_tpu_torch.models import extra, make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.models.extra import EATNN
from cleverrec_tpu_torch.serving import build_retrieval_fn
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.train.checkpoint import load_checkpoint
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config

MODELS = ("WMF", "DMF", "SML", "EATNN")
# The confs cut to the toy: embed 16 (DMF's towers [16, 8]); lr 0.01 and
# stddev 0.1 so that a toy epoch moves the tables.
TRAIN = {"epoches": "2", "batch_size": "64", "embed_size": "16",
         "lr": "0.01", "stddev": "0.1", "social_file": "trusts.csv"}
CONF = {"WMF": {"is_pairwise": "False", "loss_func": "square",
                "alpha": "10.0", "reg": "0.001", "neg_ratio": "4"},
        "DMF": {"is_pairwise": "False", "loss_func": "cross_entropy",
                "layers": "[16,8]", "reg": "0.0001", "neg_ratio": "4"},
        "SML": {"loss_func": "hinge", "reg": "0.01", "gamma": "1.0",
                "margin_cap": "1.0", "margin_reg": "0.01", "neg_ratio": "4",
                "cml_like": "True"},
        "EATNN": {"reg": "0.001", "social_weight": "0.5", "neg_ratio": "4"}}
# Losses and scores, port against JAX: f32 sums of width 16 in another
# order.
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


def _params(jmodel, model, seed, **fixed):
    """JAX's initial parameters from ``seed`` (with ``fixed`` arrays in
    place of some), loaded into the port's model."""
    params = {**jmodel.init(jax.random.PRNGKey(seed)),
              **{k: jnp.asarray(v, jnp.float32) for k, v in fixed.items()}}
    load_params(model, {k: _np(v) for k, v in params.items()})
    return params


def _batch(model, data, n=40, seed=4):
    rng = np.random.default_rng(seed)
    batch = {"u": rng.integers(0, data.user_nums, n).astype(np.int32),
             "i": rng.integers(0, data.item_nums, n).astype(np.int32),
             "w": (rng.random(n) < 0.8).astype(np.float32)}
    if model.sampler == "pointwise":
        batch["y"] = (rng.random(n) < 0.3).astype(np.float32)
    else:
        batch["j"] = rng.integers(0, data.item_nums, n).astype(np.int32)
    return batch


def _loss_and_grads(jmodel, params, j_aux, model, aux, batch):
    """(JAX's loss and gradients, the port's loss) on ``batch``; the
    port's gradients are left in its parameters' ``grad``."""
    want, grads = jax.value_and_grad(jmodel.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, j_aux)
    loss = model.loss({k: torch.as_tensor(v) for k, v in batch.items()}, aux)
    loss.backward()
    return want, grads, loss.detach()


def _close_grads(model, grads):
    for k, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), k
        np.testing.assert_allclose(p.grad.numpy(), _np(grads[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_parameters_match_jax(toy_social_dataset, name):
    (_, _, jmodel), (_, data, model) = _both(toy_social_dataset, name)
    params = jmodel.init(jax.random.PRNGKey(0))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(v.shape) for n, v in params.items()}
    assert list(got) == list(params)
    assert model.fused_protocol is None
    assert model.sampler == ("pointwise" if name in ("WMF", "DMF")
                             else "pairwise")
    assert model.cml_like == (name == "SML")
    assert hasattr(model, "dot_decomposition") == (name != "DMF")
    if name == "SML":
        assert torch.equal(model.m_u, torch.full((data.user_nums,), 0.5))
        assert torch.equal(model.m_i, torch.full((data.item_nums,), 0.5))


@pytest.mark.parametrize("name", MODELS)
def test_loss_grads_and_scores_match_jax(toy_social_dataset, name):
    """The loss, every parameter's gradient and the three scorers (and
    the decomposition) from one set of JAX parameters.  EATNN's social
    term picks its edges by the keyless hash in both packages."""
    (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset, name)
    params = _params(jmodel, model, 3)
    j_aux, aux = _aux(jmodel, jdata, model, data)
    batch = _batch(model, data)
    want, grads, loss = _loss_and_grads(jmodel, params, j_aux, model, aux,
                                        batch)
    assert float(loss) == pytest.approx(float(want), rel=LOSS_RTOL)
    _close_grads(model, grads)

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
        if name != "DMF":
            got = model.dot_decomposition(tu, aux)
            want = jmodel.dot_decomposition(params, jnp.asarray(u), j_aux)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    close(g, w)


@pytest.mark.parametrize("margin", [0.0, 1.0])
def test_sml_margins_on_the_clip_bounds(toy_social_dataset, monkeypatch,
                                        margin):
    """Margins exactly at 0 or at margin_cap (where postprocess leaves
    them): jnp.clip passes half their gradient there, and so does the
    port's clip, where torch.clamp would pass all of it."""
    (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset, "SML")
    m_u = np.full(data.user_nums, margin, np.float32)
    m_i = np.full(data.item_nums, margin, np.float32)
    m_u[::5], m_i[::5] = 0.5, 0.5
    params = _params(jmodel, model, 3, m_u=m_u, m_i=m_i)
    j_aux, aux = _aux(jmodel, jdata, model, data)
    batch = _batch(model, data, n=60)
    want, grads, loss = _loss_and_grads(jmodel, params, j_aux, model, aux,
                                        batch)
    assert float(loss) == pytest.approx(float(want), rel=LOSS_RTOL)
    _close_grads(model, grads)
    model.zero_grad()
    monkeypatch.setattr(extra, "_clip",
                        lambda x, lo, hi: torch.clamp(x, lo, hi))
    model.loss({k: torch.as_tensor(v) for k, v in batch.items()},
               aux).backward()
    for k in ("m_u", "m_i"):
        assert not np.allclose(model.get_parameter(k).grad.numpy(),
                               _np(grads[k]), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL), k


def test_dmf_dead_tower_row_has_a_finite_gradient(toy_social_dataset):
    """A user tower whose ReLUs are all dead gives an exactly-zero row;
    the cosine's sqrt(sum + 1e-12) keeps the gradient finite in both
    packages, and equal."""
    (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset, "DMF")
    bias = np.full(8, -50.0, np.float32)
    params = _params(jmodel, model, 3, bu_1=bias)
    j_aux, aux = _aux(jmodel, jdata, model, data)
    batch = _batch(model, data)
    with torch.no_grad():
        ue, _ = model._towers(model.P[torch.as_tensor(batch["u"]).long()],
                              model.Q[torch.as_tensor(batch["i"]).long()])
    assert torch.count_nonzero(ue) == 0
    want, grads, loss = _loss_and_grads(jmodel, params, j_aux, model, aux,
                                        batch)
    assert np.isfinite(float(want)) and np.isfinite(float(loss))
    assert float(loss) == pytest.approx(float(want), rel=LOSS_RTOL)
    assert all(np.isfinite(_np(g)).all() for g in grads.values())
    _close_grads(model, grads)


def _sml_off_bounds(p0, data):
    """SML's margins spread over [-0.3, 1.3], so that the first step's
    postprocess clips some onto 0 and some onto the cap, where the loss's
    clip then meets them at its ties."""
    rng = np.random.default_rng(8)
    for k, n in (("m_u", data.user_nums), ("m_i", data.item_nums)):
        p0[k] = rng.uniform(-0.3, 1.3, n).astype(np.float32)


@pytest.mark.parametrize("name", MODELS)
def test_scan_epoch_on_jax_draws_matches_jax(toy_social_dataset, name):
    """One scan epoch from JAX's parameters and Adam state one epoch in,
    on JAX's sampled batches: parameters, moments and loss.  SML starts
    with margins outside [0, margin_cap], so its postprocess clips them
    onto the bounds inside the epoch; EATNN runs at social_weight 0."""
    over = {"social_weight": "0"} if name == "EATNN" else {}
    (jcfg, jdata, jmodel), (cfg, data, model) = _both(toy_social_dataset,
                                                      name, **over)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    tr = Trainer(model, data, cfg, device="cpu")
    assert not tr.fused and tr._grid is None and tr._buckets is None
    assert tr.steps_per_epoch == j_tr.steps_per_epoch
    p0, o0 = j_tr.init_state()
    p0, o0, _ = j_tr.train_epoch(p0, o0)
    p0 = {k: np.array(v) for k, v in p0.items()}
    if name == "SML":
        _sml_off_bounds(p0, data)
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
    if name == "SML":
        for k in ("m_u", "m_i"):
            m = got_p[k].detach()
            assert float(m.max()) <= 1.0 and float(m.min()) == 0.0, k


def test_eatnn_keyless_hash_matches_jax():
    """The keyless edge pick, (u * 2654435761) mod 2^32 mod n_f, computed
    in int64 here and in uint32 arithmetic in JAX, over ids whose
    products wrap."""
    u = np.concatenate([np.arange(0, 3000), [2 ** 20 + 7, 2 ** 31 - 1]])
    for n_f in (1, 7, 7106, 65537):
        want = (jnp.asarray(u).astype(jnp.uint32) * jnp.uint32(2654435761)
                ) % jnp.uint32(n_f)
        got = EATNN.edge_draw(torch.as_tensor(u), n_f)
        np.testing.assert_array_equal(got.numpy(), _np(want).astype(np.int64))


def test_eatnn_step_draws_are_uniform_and_fresh():
    """With the trainer's generator every step draws a new batch of edges,
    uniform over them: 200 draws of 600 rows over 50 edges sit within a
    chi-square bound, and two steps' draws differ."""
    gen = torch.Generator().manual_seed(3)
    u = torch.arange(600)
    draws = [EATNN.edge_draw(u, 50, gen) for _ in range(200)]
    assert not torch.equal(draws[0], draws[1])
    assert all(not torch.equal(draws[0], d) for d in draws[1:])
    counts = torch.bincount(torch.cat(draws), minlength=50).double()
    expected = counts.sum() / 50
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # chi-square with 49 degrees of freedom: P(X > 90) is below 1e-3.
    assert counts.min() > 0 and chi2 < 90, chi2


def test_eatnn_loss_reads_the_generator(toy_social_dataset):
    """The loss's social term draws from ``batch["dropout_gen"]``: two
    generators in one state give one loss, later draws other losses, and
    without one the keyless hash gives JAX's keyless loss."""
    (_, jdata, jmodel), (_, data, model) = _both(toy_social_dataset, "EATNN")
    params = _params(jmodel, model, 3)
    j_aux, aux = _aux(jmodel, jdata, model, data)
    batch = {k: torch.as_tensor(v) for k, v in _batch(model, data).items()}
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    with torch.no_grad():
        first = [model.loss({**batch, "dropout_gen": g}, aux) for g in gens]
        later = model.loss({**batch, "dropout_gen": gens[0]}, aux)
        keyless = model.loss(batch, aux)
    assert torch.equal(first[0], first[1])
    assert not torch.equal(first[0], later)
    want = jmodel.loss(params, {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()}, j_aux)
    assert float(keyless) == pytest.approx(float(want), rel=LOSS_RTOL)


def test_eatnn_needs_friend_edges(toy_dataset, toy_social_dataset, tmp_path):
    """Without social_file, or with a trust file that keeps no edge,
    build_aux raises in both packages."""
    (_, jdata, jmodel), (_, data, model) = _both(toy_dataset, "EATNN",
                                                 social_file=None)
    for m, d, dd in ((jmodel, jdata, j_build_device_data),
                     (model, data, build_device_data)):
        with pytest.raises(ValueError, match="requires social_file"):
            m.build_aux(dd(d), d)
    ds = tmp_path / "nofriends"
    ds.mkdir()
    src = tmp_path.joinpath("toysoc")
    (ds / "ratings.csv").write_text((src / "ratings.csv").read_text())
    (ds / "trusts.csv").write_text("u_id,v_id\n")
    (_, jdata, jmodel), (_, data, model) = _both(
        {"root": str(tmp_path), "name": "nofriends"}, "EATNN")
    for m, d, dd in ((jmodel, jdata, j_build_device_data),
                     (model, data, build_device_data)):
        with pytest.raises(ValueError, match="no friend edges"):
            m.build_aux(dd(d), d)


def test_eatnn_resume_equals_the_whole_run(toy_social_dataset, tmp_path):
    """EATNN with its social term, 2 epochs saved and resumed to 4,
    against 4 in one run: equal on the CPU, the edge draws' generator
    being in the checkpoint."""
    (_, _, _), (cfg, data, model) = _both(toy_social_dataset, "EATNN")
    tr = Trainer(model, data, cfg, device="cpu")
    params, state = tr.init_state()
    params, state, _ = tr.train_epochs(params, state, 2)
    ckpt = tr.save(str(tmp_path / "EATNN"), params, state, 2)
    assert "dropout" in load_checkpoint(ckpt)["rng"]
    params, state, _ = tr.train_epochs(params, state, 2)
    whole = {k: v.detach().clone() for k, v in params.items()}
    again = Trainer(model, data, cfg, device="cpu")
    params, state, epoch = again.resume(ckpt)
    assert epoch == 2
    params, state, _ = again.train_epochs(params, state, 2)
    for k, v in params.items():
        assert torch.equal(v.detach(), whole[k]), k


@pytest.mark.parametrize("name", ("WMF", "SML", "EATNN"))
def test_decomposition_ranks_as_score_all(toy_social_dataset, name):
    """The decomposition through the fused rankers' plain versions ranks
    as score_all does: full_fused eval equals full, fused retrieval
    equals dense; SML's answers are its smallest distances."""
    (_, _, _), (cfg, data, model) = _both(
        toy_social_dataset, name,
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
    answers = {}
    for backend in ("fused", "dense"):
        fn = build_retrieval_fn(model, tr.aux, tr.dd, k=5, backend=backend,
                                device="cpu")
        answers[backend] = fn(users)
    (fi, fv), (di, dv) = answers["fused"], answers["dense"]
    assert torch.equal(fi, di)
    u = torch.as_tensor(users)
    with torch.no_grad():
        full_scores = model.score_all(u, tr.aux)
    if name != "SML":
        np.testing.assert_allclose(fv.numpy(), dv.numpy(), rtol=1e-5,
                                   atol=1e-6)
        return
    # Ascending: each answer's distance is at most that of every unseen
    # item left out, and the distances rise along the list.
    picked = torch.gather(full_scores, 1, fi)
    assert bool((picked[:, 1:] >= picked[:, :-1] - 1e-6).all())
    seen = torch.zeros_like(full_scores, dtype=torch.bool)
    for user, items in data.ui_train.items():
        seen[user, list(items)] = True
    rest = full_scores.masked_fill(seen, float("inf"))
    rest.scatter_(1, fi, float("inf"))
    assert bool((picked[:, -1] <= rest.min(dim=1).values + 1e-6).all())
