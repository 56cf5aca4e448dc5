"""BPR training in the port against the JAX package: the epoch kernel's
plain version against the Pallas kernel in interpret mode, the
optimizers against optax, the pairwise sampler's exact rank draw and its
invariants, BPR's loss, and one epoch of each trainer tier from the same
parameters, Adam state and sampled tensors."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch

from cleverrec_tpu import sampling as j_sampling
from cleverrec_tpu.common import make_optimizer as j_make_optimizer
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.ops.pallas_train import fused_bpr_epoch as j_fused_bpr_epoch
from cleverrec_tpu.ops.pallas_train import sentinel_dims as j_sentinel_dims
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import sampling
from cleverrec_tpu_torch.common import make_optimizer
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import train as T
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config

# The kernel's plain version against the Pallas kernel: f32 sums in
# another order (tests/test_fused_train.py's oracle tolerances).
LOSS_RTOL = 1e-5
TABLE_RTOL, TABLE_ATOL = 2e-4, 2e-6
MOMENT_ATOL = 2e-7
# One trainer epoch, port against JAX (tests/test_fused_train.py:95-106).
EPOCH_LOSS_RTOL = 1e-4
EPOCH_RTOL, EPOCH_ATOL = 1e-3, 1e-5

TRAIN = {"epoches": "2", "batch_size": "64", "embed_size": "16",
         "lr": "0.05", "neg_ratio": "2", "reg": "0.01"}


def _np(x):
    return np.asarray(x)


def _kernel_inputs(seed, t0):
    """tests/test_fused_train.py's shapes: 37 x 53 x 16, 4 steps x 64,
    15% sentinel slots; moments zero at t0 = 0, else random."""
    rng = np.random.default_rng(seed)
    u_n, i_n, d, steps, b = 37, 53, 16, 4, 64
    u_pad, i_pad = j_sentinel_dims(u_n, i_n)
    assert (u_pad, i_pad) == T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.15
    ids = [np.where(invalid, sent - 1,
                    rng.integers(0, n, (steps, b))).astype(np.int32)
           for n, sent in ((u_n, u_pad), (i_n, i_pad), (i_n, i_pad))]
    tables = [rng.normal(size=(n, d)).astype(np.float32) * 0.1
              for n in (u_n, i_n)]
    if t0 == 0:
        moments = [np.zeros((n, d), np.float32) for n in (u_n, u_n, i_n, i_n)]
    else:
        moments = [rng.normal(size=(n, d)).astype(np.float32) * s
                   for n, s in ((u_n, 1e-2), (u_n, 1e-4), (i_n, 1e-2),
                                (i_n, 1e-4))]
        moments = [np.abs(m) if k % 2 else m for k, m in enumerate(moments)]
    return tables, moments, ids, int(invalid.sum())


@pytest.mark.parametrize("t0", [0, 7])
def test_epoch_plain_version_matches_pallas(t0):
    (p0, q0), (mp, vp, mq, vq), (u, i, j), n_sent = _kernel_inputs(0, t0)
    lr, reg = 0.01, 0.02
    want = j_fused_bpr_epoch(*(jnp.asarray(x) for x in (p0, q0, mp, vp, mq,
                                                        vq, u, i, j)),
                             jnp.asarray(t0, jnp.int32), lr=lr, reg=reg,
                             blk=8, interpret=True)
    state = [torch.as_tensor(x.copy()) for x in (p0, q0, mp, vp, mq, vq)]
    before = dict(T.launches)
    loss = T.fused_bpr_epoch(*state, *(torch.as_tensor(x) for x in (u, i, j)),
                             t0, lr=lr, reg=reg)
    assert T.launches == before                  # CPU tensors: plain path
    assert float(loss) == pytest.approx(float(want[6]), rel=LOSS_RTOL)
    assert float(loss) - n_sent * T.LOG2 > 0
    for got, exp in zip(state[:2], want[:2]):
        np.testing.assert_allclose(got.numpy(), _np(exp), rtol=TABLE_RTOL,
                                   atol=TABLE_ATOL)
    for got, exp in zip(state[2:], want[2:6]):
        np.testing.assert_allclose(got.numpy(), _np(exp), rtol=0,
                                   atol=MOMENT_ATOL)


def test_epoch_sentinel_slots_change_nothing_but_the_loss():
    (p0, q0), (mp, vp, mq, vq), (u, i, j), _ = _kernel_inputs(1, 0)
    u_pad, i_pad = T.sentinel_dims(*p0.shape[:1], *q0.shape[:1])
    sent = [np.full_like(x, pad - 1) for x, pad in ((u, u_pad), (i, i_pad),
                                                    (j, i_pad))]
    state = [torch.as_tensor(x.copy()) for x in (p0, q0, mp, vp, mq, vq)]
    loss = T.fused_bpr_epoch(*state, *(torch.as_tensor(x) for x in sent), 0,
                             lr=0.01, reg=0.02)
    assert float(loss) == pytest.approx(u.size * T.LOG2, rel=1e-6)
    for got, exp in zip(state, (p0, q0, mp, vp, mq, vq)):
        np.testing.assert_array_equal(got.numpy(), exp)


def test_epoch_wrapper_rejects_bad_input():
    (p0, q0), moments, (u, i, j), _ = _kernel_inputs(2, 0)
    state = [torch.as_tensor(x) for x in (p0, q0, *moments)]
    ids = [torch.as_tensor(x) for x in (u, i, j)]
    with pytest.raises(TypeError):
        T.fused_bpr_epoch(*state, *(x.long() for x in ids), 0, lr=0.1, reg=0)
    with pytest.raises(ValueError):
        T.fused_bpr_epoch(*state[:2], state[3].T, *state[3:], *ids, 0,
                          lr=0.1, reg=0)
    with pytest.raises(ValueError):
        T.fused_bpr_epoch(*state, ids[0][:, :5], *ids[1:], 0, lr=0.1, reg=0)


@pytest.mark.parametrize("name", ["SGD", "Adam", "Adagrad"])
def test_optimizers_match_optax(name):
    rng = np.random.default_rng(3)
    params = {"P": rng.normal(size=(7, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    j_opt, opt = j_make_optimizer(name, 0.03), make_optimizer(name, 0.03)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = j_opt.init(j_params)
    t_params = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    state = opt.init(t_params)
    for _ in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, j_state = j_opt.update({k: jnp.asarray(g) for k, g in
                                     grads.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        state = opt.update(t_params, {k: torch.as_tensor(g) for k, g in
                                      grads.items()}, state)
        # A few f32 ulps a step: Adam's bias corrections round from
        # double here and are computed in f32 by optax.
        for k in params:
            np.testing.assert_allclose(t_params[k].numpy(), _np(j_params[k]),
                                       rtol=1e-5, atol=1e-6)
    if name == "Adam":
        assert state.count == int(j_state[0].count) == 5


def _member_table(seed=4, n=25, id_range=300):
    rng = np.random.default_rng(seed)
    sets = {e: rng.choice(id_range, rng.integers(1, 120), replace=False)
            .tolist() for e in range(n) if e != 3}
    sets[0] = list(range(40)) + [id_range - 1]    # dense head and the tail
    return sampling.build_member_table(sets, n, id_range), id_range


def test_unseen_by_rank_is_the_jax_complement_entry():
    table, id_range = _member_table()
    comp = _np(j_sampling.complement_from_bits(
        table.bits.view(np.uint32), id_range))
    rng = np.random.default_rng(5)
    e = rng.integers(0, table.lens.shape[0], 4000)
    r = (rng.random(4000) * (id_range - table.lens[e])).astype(np.int64)
    got = sampling.unseen_by_rank(torch.as_tensor(table.rows),
                                  torch.as_tensor(table.lens),
                                  torch.as_tensor(e), torch.as_tensor(r))
    np.testing.assert_array_equal(got.numpy(), comp[e, r])
    # The JAX function itself, on the same ranks.
    want = j_sampling.unseen_by_rank(
        j_sampling.MemberTable(jnp.asarray(table.rows),
                               jnp.asarray(table.lens), None),
        jnp.asarray(e, jnp.int32), jnp.asarray(r, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_pairwise_epoch_invariants(toy_dataset):
    cfg = Config(base_config(toy_dataset, **TRAIN).to_dict())
    dd = build_device_data(load_ranking_data(cfg))
    neg_ratio, b = 3, 64
    rows_total = dd.num_pairs * neg_ratio
    steps = -(-rows_total // b)
    static = {k: torch.as_tensor(v) for k, v in sampling.pairwise_epoch_static(
        dd.pos_u, dd.pos_i, dd.seen.lens, dd.item_nums, steps * b,
        neg_ratio).items()}
    j_static = j_sampling.pairwise_epoch_static(
        dd.pos_u, dd.pos_i, dd.seen.lens, dd.item_nums, steps * b, neg_ratio)
    for k, v in static.items():
        np.testing.assert_array_equal(v.numpy(), j_static[k])
    gen = torch.Generator().manual_seed(0)
    t = sampling.pairwise_epoch_tensors(
        gen, static, torch.as_tensor(dd.seen.rows),
        torch.as_tensor(dd.seen.lens), rows_total, steps, b)
    u, i, j, w = (t[k].reshape(-1).numpy() for k in "uijw")
    real = w == 1
    assert set(np.unique(w)) <= {0.0, 1.0} and real.sum() == rows_total
    assert t["j"].dtype == torch.int32 and t["u"].shape == (steps, b)
    # The JAX sampler's epoch holds the same (u, i, w) rows, shuffled.
    seen = j_sampling.MemberTable(*(jnp.asarray(x) for x in dd.seen[:2]),
                                  None)
    jt = j_sampling.pairwise_epoch_tensors(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in
                                j_static.items()}, seen, dd.item_nums,
        steps, b)
    rows = lambda *cols: np.unique(np.stack(cols, 1), axis=0,  # noqa: E731
                                   return_counts=True)
    for got, want in zip(rows(u, i, w), rows(*(_np(jt[k]).reshape(-1)
                                               for k in "uiw"))):
        np.testing.assert_array_equal(got, want)
    # Every train pair appears neg_ratio times; no negative is seen.
    got = np.unique(np.stack([u[real], i[real]], 1), axis=0,
                    return_counts=True)
    want = np.unique(np.stack([dd.pos_u, dd.pos_i], 1), axis=0,
                     return_counts=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1] * neg_ratio)
    words = dd.seen.bits.view(np.uint32)[u[real], j[real] >> 5]
    assert not ((words >> (j[real] & 31).astype(np.uint32)) & 1).any()
    assert ((j >= 0) & (j < dd.item_nums)).all()


def test_negatives_are_uniform_over_the_complement():
    table, id_range = _member_table()
    n_rows, user = 60000, 0
    n_unseen = id_range - int(table.lens[user])
    static = {"ord_u": torch.full((n_rows,), user, dtype=torch.int32),
              "ord_nun": torch.full((n_rows,), n_unseen, dtype=torch.int32)}
    j = sampling.epoch_negatives(torch.Generator().manual_seed(6), static,
                                 torch.as_tensor(table.rows),
                                 torch.as_tensor(table.lens)).numpy()
    unseen = np.setdiff1d(np.arange(id_range), table.rows[user])
    assert np.isin(j, unseen).all()
    counts = np.bincount(np.searchsorted(unseen, j), minlength=unseen.size)
    assert scipy.stats.chisquare(counts).pvalue > 1e-3


def _both_models(toy, **overrides):
    jcfg = base_config(toy, **TRAIN, **overrides)
    cfg = Config(jcfg.to_dict())
    jdata, data = j_load_ranking_data(jcfg), load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return (jcfg, jdata, jmodel), (cfg, data, model)


def test_bpr_loss_and_grads_match_jax(toy_dataset):
    (jcfg, _, jmodel), (_, data, model) = _both_models(toy_dataset)
    params = jmodel.init(jax.random.PRNGKey(3))
    load_params(model, {k: _np(v) for k, v in params.items()})
    rng = np.random.default_rng(8)
    batch = {"u": rng.integers(0, data.user_nums, 50).astype(np.int32),
             "i": rng.integers(0, data.item_nums, 50).astype(np.int32),
             "j": rng.integers(0, data.item_nums, 50).astype(np.int32),
             "w": (rng.random(50) < 0.8).astype(np.float32)}
    want, grads = jax.value_and_grad(jmodel.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, {})
    loss = model.loss({k: torch.as_tensor(v) for k, v in batch.items()}, {})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(grads[name]),
                                   rtol=1e-5, atol=1e-9)


def _close_epoch(trainer_out, jax_out):
    (params, state, loss), (j_params, j_state, j_loss) = trainer_out, jax_out
    assert float(loss) == pytest.approx(float(j_loss), rel=EPOCH_LOSS_RTOL)
    assert state.count == int(j_state[0].count)
    for name in ("P", "Q"):
        for got, want in ((params[name], j_params[name]),
                          (state.mu[name], j_state[0].mu[name]),
                          (state.nu[name], j_state[0].nu[name])):
            np.testing.assert_allclose(got.detach().numpy(), _np(want),
                                       rtol=EPOCH_RTOL, atol=EPOCH_ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_one_epoch_matches_jax(toy_dataset, fused):
    """From the same params and Adam state (one JAX epoch in) and the same
    sampled (u, i, j, w): the port's scan tier against the JAX scan tier,
    and its fused tier (the plain version on the CPU) against the Pallas
    kernel in interpret mode."""
    kernel = {"train.fused_kernel": str(fused)}
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(toy_dataset,
                                                             **kernel)
    j_scan = JTrainer(jmodel, jdata, base_config(
        toy_dataset, **TRAIN, **{"train.fused_kernel": "False"}))
    p0, o0 = j_scan.init_state()
    p0, o0, _ = j_scan.train_epoch(p0, o0)
    key = jax.random.PRNGKey(11)
    build_xs, run_scan = j_scan._scan_parts[:2]
    epoch_batch, step_keys = build_xs(key, j_scan.arrays)
    if fused:
        j_fused = JTrainer(jmodel, jdata, jcfg)
        sample, apply, correct = j_fused._fused_parts
        ids = sample(key, j_fused.arrays)
        p1, o1, raw = apply(p0, o0, ids)
        want = (p1, o1, correct(raw))
    else:
        p1, o1, losses = run_scan(p0, o0, (epoch_batch, step_keys),
                                  j_scan.arrays, lambda batch: batch)
        want = (p1, o1, jnp.mean(losses))

    trainer = Trainer(model, data, cfg, device="cpu")
    assert trainer.fused == fused
    assert trainer.steps_per_epoch == j_scan.steps_per_epoch
    load_params(model, {k: _np(v) for k, v in p0.items()})
    state = adam_state_from_jax(o0[0].count,
                                {k: _np(v) for k, v in o0[0].mu.items()},
                                {k: _np(v) for k, v in o0[0].nu.items()},
                                "cpu")
    tensors = {k: torch.as_tensor(np.array(v)) for k, v in epoch_batch.items()}
    if fused:                    # the JAX sampler's sentinel mapping agrees
        u_sent = T.sentinel_dims(data.user_nums, data.item_nums)[0] - 1
        np.testing.assert_array_equal(
            _np(ids[0]), np.where(_np(epoch_batch["w"]) == 0, u_sent,
                                  _np(epoch_batch["u"])))
    got = trainer._run_epoch(dict(model.named_parameters()), state, tensors)
    _close_epoch(got, want)


def test_fused_tier_eligibility(toy_dataset):
    (_, _, _), (cfg, data, model) = _both_models(toy_dataset)
    assert not Trainer(model, data, cfg, device="cpu").fused    # CPU default
    on = {"train.fused_kernel": "True"}
    for extra, fused in (({}, True), ({"optimizer": "SGD"}, False),
                         ({"loss_func": "hinge", "margin": "0.5"}, False)):
        c = cfg.with_overrides(**on, **extra)
        assert Trainer(model, data, c, device="cpu").fused == fused


@pytest.mark.parametrize("key,value,item", [
    ("profile.dir", "trace", "item 4"),
])
def test_unported_options_raise(toy_dataset, tmp_path, key, value, item):
    """The options once refused (``item``: where ROADMAP.md queued them)
    are ported: ``profile.dir`` traces the second block of a run (the
    first is not traced) into one Chrome trace, ``BPR_rank0.json``, that
    names the block's ops."""
    import json
    (_, _, _), (cfg, data, model) = _both_models(toy_dataset)
    out = tmp_path / value
    tr = Trainer(model, data, cfg.with_overrides(
        **{key: str(out), "epoches": "3"}), device="cpu")
    tr.run()
    assert sorted(os.listdir(out)) == ["BPR_rank0.json"], item
    with open(out / "BPR_rank0.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert "aten::index" in names             # BPR's row gathers


@pytest.mark.parametrize("key,value,groups,dtype", [
    ("train.fused_bf16", "True", 0, torch.bfloat16),
    ("train.fused_groups", "4", 4, torch.float32),
    ("train.fused_grouped", "True", 0, torch.float32),
])
def test_capacity_options_select_their_tier(toy_dataset, key, value, groups,
                                            dtype):
    """The JAX trainer's capacity options, once refused, select the fused
    tier's form: bf16 storage, the grouped epoch of that many user
    groups, or (``train.fused_grouped``, which has no VMEM ceiling to
    react to on the card) the resident f32 epoch as without it."""
    (_, _, _), (cfg, data, model) = _both_models(toy_dataset)
    tr = Trainer(model, data, cfg.with_overrides(
        **{key: value, "train.fused_kernel": "True"}), device="cpu")
    assert tr.fused and tr._groups == groups and tr.table_dtype == dtype
    assert (tr._group_plan is not None) == bool(groups)
    params, state = tr.init_state()
    params, state, losses = tr.train_epochs(params, state, 2)
    assert losses[1] < losses[0] and state.count == 2 * tr.steps_per_epoch


def test_popularity_negatives_are_ported(toy_dataset):
    """``neg_sampling=popularity``, once refused, is ported: the trainer
    holds the popularity CDF and trains BPR on both tiers (the fused one
    through the epoch kernel's plain version here); uniform, the default,
    holds none; another value raises."""
    (_, _, _), (cfg, data, model) = _both_models(toy_dataset)
    pop = cfg.with_overrides(neg_sampling="popularity")
    for fused in ("False", "True"):
        tr = Trainer(model, data, pop.with_overrides(
            **{"train.fused_kernel": fused}), device="cpu")
        assert tr.fused == (fused == "True") and tr._pop_cdf is not None
        assert float(tr._pop_cdf[-1]) == pytest.approx(1.0)
        params, state = tr.init_state()
        _, _, losses = tr.train_epochs(params, state, 2)
        assert np.all(np.isfinite(losses))
    assert Trainer(model, data, cfg, device="cpu")._pop_cdf is None
    with pytest.raises(ValueError, match="neg_sampling=hard"):
        Trainer(model, data, cfg.with_overrides(neg_sampling="hard"),
                device="cpu")


def test_unported_runs_raise(toy_dataset, tmp_path):
    """A mesh's model axis and the explicit exchange, once refused, are
    ported: on a 1 x 2 mesh the trainer takes the scan tier and holds
    rank 0's rows of P and Q; the explicit exchange on a 1 x 1 mesh trains
    an epoch equal to the unmeshed one within 1e-6 (rows summed through
    embedding's backward); a missing checkpoint raises."""
    from cleverrec_tpu_torch.parallel import Mesh
    (_, _, _), (cfg, data, model) = _both_models(toy_dataset)
    tr = Trainer(model, data, cfg, device="cpu", mesh=Mesh(1, 2, "cpu"))
    assert tr.tier == "scan" and tr._row_names == ["P", "Q"]
    params, _ = tr.init_state()
    assert params["P"].shape[0] * 2 == data.user_nums
    assert params["Q"].shape[0] * 2 == data.item_nums
    runs = []
    for mesh, extra in ((None, {}), (Mesh(1, 1, "cpu"),
                                     {"parallel.exchange": "explicit"})):
        tr = Trainer(model, data, cfg.with_overrides(**extra), device="cpu",
                     mesh=mesh)
        params, state = tr.init_state()
        params, state, loss = tr.train_epoch(params, state)
        runs.append((loss, {k: p.detach().clone()
                            for k, p in params.items()}))
    assert runs[1][0] == pytest.approx(runs[0][0], rel=1e-6)
    for k, p in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][k].numpy(), p.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    with pytest.raises(FileNotFoundError):
        Trainer(model, data, cfg, device="cpu").run(
            resume_from=str(tmp_path / "ckpt"))


def test_trainer_runs_both_tiers(toy_dataset):
    (_, _, _), (cfg, data, model) = _both_models(toy_dataset)
    for fused in ("False", "True"):
        tr = Trainer(model, data, cfg.with_overrides(
            **{"train.fused_kernel": fused}), device="cpu")
        params, state = tr.init_state()
        params, state, losses = tr.train_epochs(params, state, 3)
        assert losses[-1] < losses[0]
        assert state.count == 3 * tr.steps_per_epoch
        res = tr.evaluate()
        assert sorted(res) == cfg.topk


@pytest.mark.parametrize("fused", [False, True])
def test_three_epochs_on_the_jax_draws_match_jax(toy_dataset, fused):
    """Three epochs from JAX's initial parameters, each on the JAX
    sampler's draw, then eval: the port's parameters, loss and metrics
    follow the JAX trainer's epoch by epoch."""
    kernel = {"train.fused_kernel": str(fused)}
    (jcfg, jdata, jmodel), (cfg, data, model) = _both_models(toy_dataset,
                                                             **kernel)
    j_tr = JTrainer(jmodel, jdata, jcfg)
    build_xs = JTrainer(jmodel, jdata, base_config(
        toy_dataset, **TRAIN, **{"train.fused_kernel": "False"})
    )._scan_parts[0]
    params, state = j_tr.init_state()
    trainer = Trainer(model, data, cfg, device="cpu")
    load_params(model, {k: _np(v) for k, v in params.items()})
    t_params = dict(model.named_parameters())
    t_state = trainer.optimizer.init(t_params)
    for epoch in range(3):
        key = jax.random.PRNGKey(100 + epoch)
        params, state, loss = j_tr._epoch_body(params, state, key,
                                               j_tr.arrays)
        batch, _ = build_xs(key, j_tr.arrays)
        tensors = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
        t_params, t_state, t_loss = trainer._run_epoch(t_params, t_state,
                                                       tensors)
        _close_epoch((t_params, t_state, t_loss), (params, state, loss))
        want, got = j_tr.evaluate(params), trainer.evaluate()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-4)
