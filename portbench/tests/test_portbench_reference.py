"""The reference against straightforward loops at a tiny size."""

import math

import numpy as np
import pytest
import torch

from portbench import compare
from portbench.reference import models, ranking
from portbench.reference.split import split


def _raw(seed=3, n=150, users=12, items=15):
    rng = np.random.default_rng(seed)
    key = rng.choice(users * items, n, replace=False)
    return {"u": 100 + key // items, "i": 50 + key % items,
            "t": rng.integers(0, 1000, n)}


CONF = {"data.split_way": "rs", "data.split_ratio": "[0.7,0.2,0.1]",
        "data.split_by_time": "True", "seed": "11"}


def test_split_is_the_seeded_permutation_of_rows_sorted_by_user_and_time():
    raw = _raw()
    sp = split(raw, CONF)
    users, items = sorted(set(raw["u"])), sorted(set(raw["i"]))
    rows = sorted(zip((users.index(u) for u in raw["u"]), raw["t"],
                      range(len(raw["u"])),
                      (items.index(i) for i in raw["i"])))
    perm = np.random.default_rng(11).permutation(len(rows))
    n_train, n_test = round(0.7 * len(rows)), round(0.1 * len(rows))
    train = [(rows[p][0], rows[p][3]) for p in perm[:n_train]]
    test = [(rows[p][0], rows[p][3]) for p in perm[len(rows) - n_test:]]
    assert list(zip(sp.train_u, sp.train_i)) == train
    assert list(zip(sp.test_u, sp.test_i)) == test
    indptr, ids = sp.seen()
    for u in range(sp.users):
        assert list(ids[indptr[u]:indptr[u + 1]]) == sorted(
            i for uu, i in train if uu == u)


def _batch(u, i, j, w):
    return {"u": torch.tensor(u), "i": torch.tensor(i), "j": torch.tensor(j),
            "w": torch.tensor(w, dtype=torch.float32)}


def test_bpr_loss_is_the_sum_over_rows():
    g = torch.Generator().manual_seed(0)
    w = {"P": torch.randn(4, 3, generator=g), "Q": torch.randn(6, 3,
                                                             generator=g)}
    m = models.BPR(w, reg=0.1)
    b = _batch([0, 1, 3, 0], [2, 5, 1, 0], [3, 0, 4, 5], [1, 1, 0, 1])
    want = 0.0
    for u, i, j, wt in zip(*(b[k].tolist() for k in ("u", "i", "j", "w"))):
        p, qi, qj = (x * wt for x in (w["P"][u], w["Q"][i], w["Q"][j]))
        d = float(p @ qi - p @ qj)
        want += wt * math.log1p(math.exp(-d)) + 0.1 * 0.5 * float(
            p @ p + qi @ qi + qj @ qj)
    assert float(m.loss(b).detach()) == pytest.approx(want, rel=1e-5)


def test_lightgcn_tables_are_the_mean_of_normalised_adjacency_powers():
    g = torch.Generator().manual_seed(1)
    w = {"P": torch.randn(3, 2, generator=g), "Q": torch.randn(4, 2,
                                                             generator=g)}
    tu, ti = np.array([0, 0, 1, 2, 2]), np.array([1, 3, 0, 2, 3])
    m = models.LightGCN(w, 0.0, models.bipartite_graph(tu, ti, 3, 4, "cpu"),
                        layers=2)
    a = np.zeros((7, 7))
    for u, i in zip(tu, ti):
        a[u, 3 + i] = a[3 + i, u] = 1.0
    deg = a.sum(1)
    norm = a / np.sqrt(np.outer(deg, deg))
    e0 = torch.cat([w["P"], w["Q"]]).numpy().astype(np.float64)
    want = (e0 + norm @ e0 + norm @ norm @ e0) / 3
    pf, qf = m.tables()
    got = torch.cat([pf, qf]).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_adam_follows_the_update_rule_step_by_step():
    g = torch.Generator().manual_seed(2)
    w = {"P": torch.randn(3, 2, generator=g), "Q": torch.randn(3, 2,
                                                             generator=g)}
    batches = [_batch([0, 1], [1, 2], [2, 0], [1, 1]),
               _batch([2, 2], [0, 1], [1, 2], [1, 0])]
    out = models.follow(models.BPR(w, 0.01), batches, lr=0.1)
    p = {k: v.clone().double() for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    for t, b in enumerate(batches, start=1):
        leaves = {k: x.clone().requires_grad_(True) for k, x in p.items()}
        loss = models.BPR.loss(type("M", (), {"tables": lambda s: (
            leaves["P"], leaves["Q"]), "reg": 0.01})(), b)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if t == 1:
            assert out["grad_norm"]["P"] == pytest.approx(
                float(grads[0].norm()), rel=1e-5)
        for (k, x), gr in zip(p.items(), grads):
            m[k] = 0.9 * m[k] + 0.1 * gr
            v2[k] = 0.999 * v2[k] + 0.001 * gr * gr
            p[k] = x - 0.1 * (m[k] / (1 - 0.9 ** t)) / (
                torch.sqrt(v2[k] / (1 - 0.999 ** t)) + 1e-8)
    for k in p:
        assert out["change_norm"][k] == pytest.approx(
            float((p[k] - w[k].double()).norm()), rel=1e-4)


def test_topk_and_metrics_against_a_sort_and_the_formulas():
    g = torch.Generator().manual_seed(3)
    ut, it = torch.randn(5, 4, generator=g), torch.randn(9, 4, generator=g)
    indptr = np.array([0, 2, 2, 3, 5, 6])
    seen = np.array([1, 4, 0, 2, 8, 3])
    users = np.array([0, 2, 3, 4])
    got = ranking.topk_ids(ut, it, users, (indptr, seen), 3)
    for row, u in zip(got, users):
        s = (ut[u] @ it.T).tolist()
        order = [i for i in sorted(range(9), key=lambda i: -s[i])
                 if i not in seen[indptr[u]:indptr[u + 1]]]
        assert list(row) == order[:3]
    # Users 0 and 1 have no test ids, 2 has [6, 7], 3 [4], 4 [9].
    rec = np.array([[5, 6, 7], [6, 1, 7], [0, 1, 2], [9, 9, 9]])
    real = (np.array([0, 0, 0, 2, 3, 4]), np.array([6, 7, 4, 9]))
    sums = ranking.metric_sums(rec, np.array([0, 2, 3, 4]), real, [1, 3])
    hand = {1: np.zeros(3), 3: np.zeros(3)}
    for row, u in zip(rec, [0, 2, 3, 4]):
        reals = real[1][real[0][u]:real[0][u + 1]]
        if len(reals) == 0:
            continue
        idcg = sum(1 / math.log2(s + 2) for s in range(len(reals)))
        for k in (1, 3):
            ranks = [list(row[:k]).index(x) for x in reals if x in row[:k]]
            hand[k] += (len(ranks) / min(k, len(reals)),
                        sum(1 / (r + 1) for r in ranks),
                        sum(1 / math.log2(r + 2) for r in ranks) / idcg)
    for k in (1, 3):
        np.testing.assert_allclose(sums[k], hand[k])


def test_rank_numbers_are_nought_on_the_exact_answer_and_count_bad_ids():
    g = torch.Generator().manual_seed(4)
    ut, it = torch.randn(4, 3, generator=g), torch.randn(20, 3, generator=g)
    indptr, seen = np.array([0, 1, 3, 3, 4]), np.array([5, 0, 7, 11])
    users = np.arange(4)
    exact = ranking.topk_ids(ut, it, users, (indptr, seen), 5)
    scores = np.take_along_axis((ut @ it.T).numpy(), exact, 1)
    out = compare.rank_numbers(exact, users, ut, it, (indptr, seen), scores)
    assert out == {"bad_ids": 0.0, "rank_gap": 0.0, "score_gap": 0.0}
    bad = exact.copy()
    bad[0, 1] = 5          # seen by user 0
    bad[1, 2] = bad[1, 0]  # repeated
    bad[2, 4] = -1         # outside the catalog
    assert compare.rank_numbers(bad, users, ut, it,
                                (indptr, seen))["bad_ids"] == 3
    swapped = exact.copy()
    swapped[3, [0, 4]] = swapped[3, [4, 0]]
    assert compare.rank_numbers(swapped, users, ut, it,
                                (indptr, seen))["rank_gap"] > 0


def test_draw_numbers_count_missing_pairs_and_seen_negatives():
    pu, pi = np.array([0, 0, 1]), np.array([1, 2, 0])
    indptr, ids = np.array([0, 2, 3]), np.array([1, 2, 0])
    draw = {"u": np.array([[0, 0, 1, 0], [0, 1, 0, 0]]),
            "i": np.array([[1, 2, 0, 1], [2, 0, 0, 0]]),
            "j": np.array([[3, 3, 1, 2], [4, 2, 0, 0]]),
            "w": np.array([[1, 1, 1, 1], [1, 1, 0, 0]], np.float32)}
    out = compare.draw_numbers(draw, pu, pi, 5, 2, (indptr, ids))
    assert out == {"draw_pairs": 0.0, "draw_negatives": 1.0}
    draw["i"][0, 0] = 3
    draw["j"][1, 1] = 5
    out = compare.draw_numbers(draw, pu, pi, 5, 2, (indptr, ids))
    assert out["draw_pairs"] >= 1 and out["draw_negatives"] == 2.0
