"""The grouped fused epoch (``train.fused_groups``) in the port against the
JAX package: the plan (the users' permutation, each group's static
layout, steps, padding and real users), one grouped epoch of BPR, GMF,
NeuMF and CML fed the JAX trainer's own per-group draws (the Pallas
kernels in interpret mode on the JAX side, the kernels' plain versions
here), CML's frozen partial sums against the Pallas kernel, the options
that select the tier, and a resumed grouped run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu import sampling as j_sampling
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.ops.pallas_train import fused_cml_epoch as j_cml_epoch
from cleverrec_tpu.train import Trainer as JTrainer
from cleverrec_tpu_torch import sampling
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import train as T
from cleverrec_tpu_torch.train import Trainer
from cleverrec_tpu_torch.weights import adam_state_from_jax, load_params
from tests.conftest import base_config, make_toy_interactions

# One grouped epoch, port against JAX: f32 sums in another order.
LOSS_RTOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
# CML's frozen sums on one kernel call (tests/test_torch_metric.py's).
CML_RTOL, CML_ATOL = 2e-4, 2e-6

# tests/test_fused_train.py:374-385's shapes: 300 users, 60 items, embed
# 8, batch 64, two groups, one epoch.
BASE = {"epoches": "1", "batch_size": "64", "embed_size": "8",
        "lr": "0.01", "neg_ratio": "2", "reg": "0.01", "stddev": "0.1",
        "train.fused_kernel": "True", "train.fused_groups": "2"}
MODELS = {
    "BPR": {"is_pairwise": "True", "loss_func": "bpr"},
    # tests/test_fused_train.py:483-488: lr 0.001 keeps the h chain's f32
    # order noise far below the tolerance (at lr 0.01 Adam turns it into
    # steps of lr on near-zero gradients: 5% of NeuMF's P_gmf parts by
    # up to 8e-5 in one epoch).
    "GMF": {"is_pairwise": "False", "loss_func": "cross_entropy",
            "lr": "0.001"},
    "NeuMF": {"is_pairwise": "False", "loss_func": "cross_entropy",
              "layers": "[16,8]", "reg1": "0.02", "reg2": "0.03",
              "lr": "0.001"},
    "CML": {"is_pairwise": "True", "loss_func": "hinge", "margin": "1.0",
            "reg": "0.05", "neg_ratio": "3"},
}
CASES = ("BPR", "GMF", "NeuMF", "CML", "BPR_popularity")


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("grouped")
    (root / "big").mkdir()
    make_toy_interactions(root / "big" / "ratings.csv", n_users=300,
                          n_items=60, n_rows=4000)
    return {"root": str(root), "name": "big"}


def _overrides(case, **extra):
    name = case.split("_")[0]
    ov = {**BASE, **MODELS[name], "recommender": name, **extra}
    if case.endswith("popularity"):
        ov["neg_sampling"] = "popularity"
    return ov


def _jax_draws(tr, key, neg_ratio):
    """The JAX grouped epoch's per-group draws (tests/test_fused_train.py:
    399-430): group g's key is the first half of split(key, G)[g]'s
    split."""
    statics = tr.arrays["grouped_static"]
    g_n, _, _ = tr._fused_grouped_plan
    b = tr.batch_size
    steps = statics["ord_u"].shape[1] // b
    fn = {"pairwise_bpr": j_sampling.pairwise_epoch_tensors,
          "cml_hinge": lambda *a, **k: j_sampling.cml_epoch_tensors(
              *a, **k, neg_ratio=neg_ratio)}.get(
                  tr.model.fused_protocol, j_sampling.pointwise_epoch_tensors)
    draws = []
    for g, gkey in enumerate(jax.random.split(key, g_n)):
        pkey, _ = jax.random.split(gkey)
        batch = fn(pkey, {k: v[g] for k, v in statics.items()},
                   tr.arrays["grouped_seen"], tr.dd.item_nums, steps, b,
                   pop_cdf=tr.arrays.get("pop_cdf"))
        draws.append({k: torch.as_tensor(np.array(v))
                      for k, v in batch.items()})
    return draws


@pytest.fixture(scope="module")
def jax_runs(toy):
    """Per case: the JAX trainer, its initial state, one grouped epoch of
    it and that epoch's per-group draws."""
    out = {}
    for case in CASES:
        jcfg = base_config(toy, **_overrides(case))
        jdata = j_load_ranking_data(jcfg)
        jmodel = j_make_model(jcfg, JMeta(jdata.user_nums, jdata.item_nums))
        tr = JTrainer(jmodel, jdata, jcfg)
        p0, o0 = tr.init_state()
        init = (jax.tree_util.tree_map(np.array, p0),
                jax.tree_util.tree_map(np.array, o0))
        key = jax.random.PRNGKey(123)
        draws = _jax_draws(tr, key, jcfg.neg_ratio)
        out[case] = {"cfg": jcfg, "trainer": tr, "init": init,
                     "draws": draws,
                     "epoch": jax.tree_util.tree_map(
                         np.asarray, tr._epoch_body(p0, o0, key, tr.arrays))}
    return out


def _port(jcfg, **extra):
    cfg = Config({**jcfg.to_dict(), **extra})
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return cfg, data, model, Trainer(model, data, cfg, device="cpu")


@pytest.mark.parametrize("case", ["BPR", "CML", "NeuMF"])
def test_plan_equals_the_jax_plan(jax_runs, case):
    """The permutation, each group's static layout, the step count, the
    padding rows and the real users of each group equal the JAX
    trainer's exactly."""
    run = jax_runs[case]
    tr = run["trainer"]
    _, _, _, trainer = _port(run["cfg"])
    plan = trainer._group_plan
    g_n, rows, _ = tr._fused_grouped_plan
    assert (trainer._groups, plan["rows"]) == (g_n, rows)
    assert plan["rows"] == T.grouped_rows(tr.dd.user_nums, g_n)
    new_of_old, old_of_new = tr._grouped_perm
    np.testing.assert_array_equal(plan["new_of_old"], new_of_old)
    np.testing.assert_array_equal(plan["old_of_new"], old_of_new)
    statics = {k: _np(v) for k, v in tr.arrays["grouped_static"].items()}
    b = tr.batch_size
    assert plan["steps_eq"] == statics["ord_u"].shape[1] // b
    assert trainer.steps_per_epoch == g_n * plan["steps_eq"]
    for g, static in enumerate(plan["statics"]):
        for k, v in static.items():
            np.testing.assert_array_equal(v, statics[k][g], err_msg=k)
        real = int(statics["ord_w"][g].sum())
        assert plan["rows_total"][g] == real
        assert plan["n_sents"][g] == plan["steps_eq"] * b - real
    un = tr.dd.user_nums
    counts = [(old_of_new[g * rows:(g + 1) * rows] < un).sum()
              for g in range(g_n)]
    np.testing.assert_array_equal(plan["grp_counts"], counts)
    # The permuted seen table: a user's set moves with it, and a filler
    # slot holds an empty set.
    seen, j_seen = plan["seen"], tr.arrays["grouped_seen"]
    real = old_of_new < un
    np.testing.assert_array_equal(seen.lens[real], _np(j_seen.lens)[real])
    np.testing.assert_array_equal(
        seen.rows[real], trainer.dd.seen.rows[old_of_new[real]])
    assert (seen.lens[~real] == 0).all()


def _load_jax_state(model, trainer, init):
    p0, o0 = init
    load_params(model, {k: _np(v) for k, v in p0.items()})
    state = adam_state_from_jax(o0[0].count,
                                {k: _np(v) for k, v in o0[0].mu.items()},
                                {k: _np(v) for k, v in o0[0].nu.items()},
                                "cpu", model=model)
    return dict(model.named_parameters()), state


@pytest.mark.parametrize("case", CASES)
def test_grouped_epoch_on_the_jax_draws_matches_jax(jax_runs, case):
    """From JAX's initial parameters and its per-group draws, one grouped
    epoch of the port (the epoch kernels' plain versions) against the
    JAX trainer's (the Pallas kernels in interpret mode): every parameter
    and moment, the count and the loss, within 1e-5 + 1e-4 |x| (loss
    1e-5 relative)."""
    run = jax_runs[case]
    _, _, model, trainer = _port(run["cfg"])
    assert trainer.fused and trainer._group_plan is not None
    params, state = _load_jax_state(model, trainer, run["init"])
    before = dict(T.launches)
    params, state, loss = trainer._run_epoch(params, state,
                                             {"groups": run["draws"]})
    assert T.launches == before                  # CPU tensors: plain path
    p1, o1, l1 = run["epoch"]
    assert float(loss) == pytest.approx(float(l1), rel=LOSS_RTOL)
    assert state.count == int(o1[0].count) == trainer.steps_per_epoch
    for name, want in p1.items():
        for got, exp in ((params[name], want),
                         (state.mu[name], o1[0].mu[name]),
                         (state.nu[name], o1[0].nu[name])):
            np.testing.assert_allclose(got.detach().numpy(), _np(exp),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["BPR_popularity", "CML"])
def test_grouped_trainer_draws_and_trains(jax_runs, case):
    """The port's own grouped draw: each group's rows hold its own users
    (permuted ids in its slice), negatives outside the user's seen set
    under popularity negatives too, and whole epochs train."""
    run = jax_runs[case]
    _, _, _, trainer = _port(run["cfg"])
    plan = trainer._group_plan
    params, state = trainer.init_state()
    groups = trainer.sample_epoch()["groups"]
    assert len(groups) == trainer._groups
    for g, draw in enumerate(groups):
        real = draw["w"] > 0
        u = draw["u"][real].long()
        assert int(real.sum()) == plan["rows_total"][g]
        assert (u // plan["rows"] == g).all()
        negs = draw["j"] if "j" in draw else draw["negs"]
        seen = sampling.table_to(plan["seen"], "cpu")
        hit = sampling.member(seen, u, negs[real])
        assert float(hit.float().mean()) < 0.01
    _, state, losses = trainer.train_epochs(params, state, 2)
    assert np.all(np.isfinite(losses)) and losses[1] < losses[0]
    assert state.count == 2 * trainer.steps_per_epoch


def _cml_kernel_inputs(rng, u_n, i_n, d, steps, b, k, ur):
    """CML's epoch on a group slice of u_n rows whose first ur are real
    (the rest are random too, to show the masking), with moments from a
    step count of 7, ids of real rows only, 15% sentinel rows, and the
    partial sums of 40 frozen rows."""
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.15
    u = np.where(invalid, u_pad - 1, rng.integers(0, ur, (steps, b)))
    i = np.where(invalid, i_pad - 1, rng.integers(0, i_n, (steps, b)))
    n = np.where(invalid[..., None], i_pad - 1,
                 rng.integers(0, i_n, (steps, b, k)))
    ids = [x.astype(np.int32) for x in (u, i, n)]
    tables = [rng.normal(size=(m, d)).astype(np.float32) * 0.3
              for m in (u_n, i_n)]
    moments = []
    for m in (u_n, i_n):
        mu = rng.normal(size=(m, d)).astype(np.float32) * 1e-2
        moments += [mu, np.abs(mu) * 1e-2]
    frozen_rows = rng.normal(size=(40, d)).astype(np.float32) * 0.3
    a = frozen_rows.sum(axis=1)
    stats = (np.float32(a.sum()), np.float32((a * a).sum()),
             np.float32((frozen_rows ** 2).sum()),
             frozen_rows.sum(axis=0))
    return ids, [tables[0], tables[1], moments[0], moments[1], moments[2],
                 moments[3]], (ur, 40, *stats)


def test_cml_frozen_sums_match_pallas():
    """fused_cml_epoch's plain version with ``frozen`` against the Pallas
    kernel's ``frozen`` in interpret mode: the regulariser over the
    slice's real rows, the items and the frozen rows' partial sums."""
    rng = np.random.default_rng(21)
    u_n, i_n, d, steps, b, k, ur = 24, 37, 8, 3, 32, 4, 17
    ids, state, frozen = _cml_kernel_inputs(rng, u_n, i_n, d, steps, b, k,
                                            ur)
    opts = dict(lr=0.01, reg=0.3, margin=0.5, item_nums=i_n)
    want = j_cml_epoch(*(jnp.asarray(x) for x in (*state, *ids)),
                       jnp.asarray(7, jnp.int32), **opts, blk=8,
                       interpret=True,
                       frozen=tuple(jnp.asarray(x, jnp.float32)
                                    for x in frozen))
    got = [torch.as_tensor(x.copy()) for x in state]
    t_frozen = (ur, 40, *(torch.as_tensor(x) for x in frozen[2:]))
    loss = T.fused_cml_epoch(*got, *(torch.as_tensor(x) for x in ids), 7,
                             **opts, frozen=t_frozen)
    bias = T.cml_sentinel_bias(0.5, i_n, k)
    n_sent = int((ids[0] == T.sentinel_dims(u_n, i_n)[0] - 1).sum())
    assert float(loss) - n_sent * bias == pytest.approx(
        float(want[6]) - n_sent * bias, rel=1e-5)
    for name, g, w in zip(("P", "Q", "mP", "vP", "mQ", "vQ"), got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=CML_RTOL,
                                   atol=CML_ATOL, err_msg=name)
    # Without frozen rows the same inputs give another result.
    other = [torch.as_tensor(x.copy()) for x in state]
    T.fused_cml_epoch(*other, *(torch.as_tensor(x) for x in ids), 7, **opts)
    assert not torch.equal(other[0], got[0])


def _cml_epoch_before_frozen(p, q, mp, vp, mq, vq, u_idx, i_idx, n_idx, t0,
                             *, lr, reg, margin, item_nums):
    """The plain CML epoch as it was before the frozen sums, operation for
    operation: the pin of "frozen=None changes nothing"."""
    steps, _, k = n_idx.shape
    n_users, n_rows = p.shape[0], p.shape[0] + q.shape[0]
    width = T.cml_width(p, q, mp, vp, mq, vq)
    bcs = T._epoch_bias_corrections(t0, steps, 0.9, 0.999)
    big = torch.iinfo(torch.int64).max
    losses = torch.zeros(steps, dtype=torch.float32)
    for s in range(steps):
        pe, u = T._rows(p, u_idx[s].long())
        qi, i = T._rows(q, i_idx[s].long())
        negs = n_idx[s].long()
        qn = T._rows(q, negs.reshape(-1))[0].reshape(*negs.shape, q.shape[1])
        d_ui = T._lane_sq_dist(pe, qi, width)
        d_un = T._lane_sq_dist(pe[:, None], qn, width)
        d_min = d_un.min(dim=1).values
        sel = torch.where(d_un == d_min[:, None], negs, big).min(dim=1).values
        cnt = ((d_ui[:, None] + margin - d_un) > 0).sum(dim=1).float()
        wlog = torch.log(cnt / k * item_nums / k + 1.0)
        slack = d_ui + margin - d_min
        c = (2.0 * wlog * (slack > 0))[:, None]
        qs, sel = T._rows(q, sel)
        x = torch.cat([q, p])
        xc = x - x.sum(dim=0) / n_rows
        s_r = xc.sum(dim=1, keepdim=True)
        g_cov = (2.0 * reg / n_rows) * (s_r - xc)
        losses[s] = torch.sum(wlog * torch.clamp(slack, min=0.0)) + reg * (
            torch.sum(s_r * s_r) - torch.sum(xc * xc)) / n_rows
        dp = T._scatter(p, (u, c * (qs - qi))) + g_cov[-n_users:]
        dq = T._scatter(q, (i, -c * (pe - qi)), (sel, c * (pe - qs))) + (
            g_cov[:-n_users])
        T._adam_dense(((p, mp, vp, dp), (q, mq, vq, dq)), t0 + s + 1, lr,
                      0.9, 0.999, 1e-8, bcs[s])
    return losses.sum()


def test_cml_without_frozen_sums_is_unchanged():
    """``frozen=None`` gives the ungrouped epoch's numbers bit for bit."""
    rng = np.random.default_rng(22)
    ids, state, _ = _cml_kernel_inputs(rng, 24, 37, 8, 3, 32, 4, 24)
    opts = dict(lr=0.01, reg=0.3, margin=0.5, item_nums=37)
    got = [torch.as_tensor(x.copy()) for x in state]
    want = [torch.as_tensor(x.copy()) for x in state]
    ids = [torch.as_tensor(x) for x in ids]
    loss = T.fused_cml_epoch(*got, *ids, 7, **opts)
    ref = _cml_epoch_before_frozen(*want, *ids, 7, **opts)
    assert torch.equal(loss, ref)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_frozen_sums_are_checked():
    rng = np.random.default_rng(23)
    ids, state, frozen = _cml_kernel_inputs(rng, 24, 37, 8, 2, 16, 3, 17)
    state = [torch.as_tensor(x) for x in state]
    ids = [torch.as_tensor(x) for x in ids]
    opts = dict(lr=0.01, reg=0.3, margin=0.5, item_nums=37)
    with pytest.raises(ValueError, match="real rows"):
        T.fused_cml_epoch(*state, *ids, 0, **opts,
                          frozen=(25, *frozen[1:]))
    with pytest.raises(ValueError, match="col_sum"):
        T.fused_cml_epoch(*state, *ids, 0, **opts,
                          frozen=(*frozen[:5], frozen[5][:3]))


def test_fused_groups_on_the_rows_protocol_raises(toy_social_dataset):
    """The JAX package has no grouped rows epoch: SBPR refuses
    ``train.fused_groups`` by name instead of running another tier."""
    jcfg = base_config(toy_social_dataset, recommender="SBPR",
                       social_file="trusts.csv", is_pairwise="True",
                       loss_func="bpr", **{"train.fused_kernel": "True",
                                           "train.fused_groups": "2"})
    with pytest.raises(ValueError, match="train.fused_groups"):
        _port(jcfg)


def test_group_rows_is_the_planners_formula():
    """ceil(U / G) rounded up to 128 (pallas_train.py:1766): ml-1m's 6,040
    users in 4 groups of 1,536 rows, grouped_scale.py's 98,304 in 32 of
    3,072 (benchmarks/GROUPED_SCALE.jsonl's plan)."""
    assert T.grouped_rows(6040, 4) == 1536
    assert T.grouped_rows(98304, 32) == 3072
    assert T.grouped_rows(300, 2) == 256
    assert T.grouped_rows(1, 7) == 128


def test_permute_rows_moves_sets_and_empties_fillers():
    sets = {0: [1, 4], 1: [2], 2: [0, 3, 5]}
    table = sampling.build_member_table(sets, 3, 6)
    out = sampling.permute_rows(table, np.array([2, 3, 0, 3, 1]), 6)
    np.testing.assert_array_equal(out.lens, [3, 0, 2, 0, 1])
    np.testing.assert_array_equal(out.rows[0], table.rows[2])
    assert (out.rows[1] == 6).all() and (out.bits[1] == 0).all()
    np.testing.assert_array_equal(out.bits[4], table.bits[1])


def test_grouped_run_resumes_to_the_same_state(toy, tmp_path):
    """A grouped run checkpointed after one epoch and resumed for the
    second ends with the state of a run of two epochs: the checkpoint
    holds the state in user order and the sampler's generator."""
    jcfg = base_config(toy, **_overrides("BPR", epoches="2"))
    _, _, model, tr = _port(jcfg)
    params, state = tr.init_state(seed=5)
    params, state, _ = tr.train_epochs(params, state, 1)
    tr.save(str(tmp_path / "ckpt"), params, state, 1)
    params, state, _ = tr.train_epochs(params, state, 1)
    whole = {k: v.detach().clone() for k, v in params.items()}
    whole_mu = {k: v.clone() for k, v in state.mu.items()}

    _, _, _, again = _port(jcfg)
    p2, s2, epoch = again.resume(str(tmp_path / "ckpt"))
    assert epoch == 1
    p2, s2, _ = again.train_epochs(p2, s2, 1)
    assert s2.count == state.count == 2 * tr.steps_per_epoch
    for k, v in whole.items():
        assert torch.equal(p2[k].detach(), v), k
        assert torch.equal(s2.mu[k], whole_mu[k]), k
    # Evaluation reads the un-permuted tables.
    assert sorted(again.evaluate()) == jcfg.topk
