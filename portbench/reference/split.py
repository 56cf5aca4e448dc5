"""The repo's random split, worked out again from the raw columns.

The CleverRec preprocessing (model/RankingPreprocess.py:12-134) as the
configuration states it: the user-min then item-min filters, sorted ids
mapped to 0..n-1, a stable sort by (user, time) when
``data.split_by_time`` is true, then a seeded permutation's head (train)
and tail (test) at ``data.split_ratio``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Split:
    users: int
    items: int
    train_u: np.ndarray        # [n_train] int64, split order
    train_i: np.ndarray
    test_u: np.ndarray         # [n_test] int64, split order
    test_i: np.ndarray
    _made: dict = field(default_factory=dict, repr=False)

    def seen(self):
        """(indptr [U + 1], ids): each user's train items, sorted."""
        if "seen" not in self._made:
            self._made["seen"] = _csr(self.train_u, self.train_i,
                                      self.users, sort_ids=True)
        return self._made["seen"]

    def tests(self):
        """(test users ascending, indptr, ids): each test user's test
        items in split order."""
        if "tests" not in self._made:
            self._made["tests"] = (np.unique(self.test_u), *_csr(
                self.test_u, self.test_i, self.users))
        return self._made["tests"]


def _csr(u, i, n, sort_ids=False):
    order = np.lexsort((i, u)) if sort_ids else np.argsort(u, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=n), out=indptr[1:])
    return indptr, i[order]


def _truthy(v) -> bool:
    return str(v).strip().lower() in ("true", "1", "yes")


def _counts_at_least(x, m):
    _, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
    return counts[inv] >= m


def split(raw: dict, conf: dict) -> Split:
    """``raw`` {u, i, t} as written by ``synth``; ``conf`` the
    configuration's ``conf`` block."""
    u, i, t = raw["u"], raw["i"], raw["t"]
    for key, col in (("data.user_min", "u"), ("data.item_min", "i")):
        m = int(conf.get(key, 0))
        if m > 0:
            keep = _counts_at_least({"u": u, "i": i}[col], m)
            u, i, t = u[keep], i[keep], t[keep]
    u = np.searchsorted(np.unique(u), u)
    uniq_i = np.unique(i)
    i = np.searchsorted(uniq_i, i)
    users, items = int(u.max()) + 1, len(uniq_i)
    if _truthy(conf.get("data.split_by_time", False)):
        order = np.lexsort((t, u))
        u, i = u[order], i[order]
    if conf["data.split_way"] != "rs":
        raise ValueError("the reference splits data.split_way=rs only")
    r1, _, r3 = json.loads(conf["data.split_ratio"])
    n = len(u)
    perm = np.random.default_rng(int(conf["seed"])).permutation(n)
    train = perm[:int(round(r1 * n))]
    test = perm[n - int(round(r3 * n)):]
    return Split(users, items, u[train], i[train], u[test], i[test])
