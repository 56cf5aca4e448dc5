"""Synthetic implicit-feedback datasets with a public dataset's statistics.

A configuration's ``dataset`` block names a public dataset and gives its
exact user, item and interaction counts, its k-core floor (every user
and every item has at least ``min_user`` / ``min_item`` interactions),
power-law exponents for the per-user and per-item counts, and a fixed
``data_seed``.  ``generate`` builds such a dataset in NumPy:

- degrees: the floor plus the rest of the interactions shared in
  proportion to (rank + offset)^-exponent - (n + offset)^-exponent, a
  power law whose last rank sits on the floor (largest remainders,
  capped at the other side's size), then assigned to ids in a seeded
  random order;
- edges: a configuration model (user stubs paired with shuffled item
  stubs), then seeded swaps of item ends until no (user, item) pair
  repeats.  Swaps keep every degree, so the counts and the k-core hold
  exactly.

``ensure`` writes it once into a fixed directory inside the checkout,
as the UIRT CSV the port's loader reads (header line first; rating 1;
a seeded time) and as ``raw.npz`` (the same columns) for the harness
and the reference.  A directory whose ``spec.json`` matches is reused.
"""

from __future__ import annotations

import json
import os

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache",
                     "data")
CSV_NAME = "ratings.csv"
RAW_NAME = "raw.npz"
SPEC_NAME = "spec.json"
SWAP_ROUNDS = 200


def degrees(n: int, total: int, floor: int, exponent: float, offset: float,
            cap: int) -> np.ndarray:
    """[n] int64 counts, rank order (largest first): ``floor`` each plus
    ``total - n * floor`` shared in proportion to (rank + offset)^-exponent
    less its value at rank n, none above ``cap``; they sum to ``total``."""
    if n * floor > total or n * cap < total:
        raise ValueError(f"{n} ids cannot hold {total} interactions "
                         f"between {floor} and {cap} each")
    rank = np.arange(1, n + 1, dtype=np.float64)
    weight = (rank + offset) ** -exponent - (n + offset) ** -exponent
    deg = np.full(n, floor, np.int64)
    left = total - n * floor
    while left > 0:
        free = deg < cap
        share = np.where(free, weight, 0.0)
        share = share / share.sum() * left
        add = np.floor(share).astype(np.int64)
        short = left - int(add.sum())
        add[np.argsort(-(share - add), kind="stable")[:short]] += 1
        new = np.minimum(deg + add, cap)
        left -= int((new - deg).sum())
        deg = new
    return deg


def _in_sorted(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    at = np.searchsorted(sorted_keys, keys)
    at = np.minimum(at, len(sorted_keys) - 1)
    return sorted_keys[at] == keys


def simple_bipartite(du: np.ndarray, di: np.ndarray,
                     rng: np.random.Generator):
    """(u, i) int64 edges with user degrees ``du`` and item degrees
    ``di`` and no repeated pair: a configuration model, then swaps of
    the item ends of repeated pairs with random partner edges, each
    taken only where neither new pair exists yet."""
    n_items = len(di)
    u = np.repeat(np.arange(len(du), dtype=np.int64), du)
    i = np.repeat(np.arange(n_items, dtype=np.int64), di)
    rng.shuffle(i)
    for _ in range(SWAP_ROUNDS):
        key = u * n_items + i
        order = np.argsort(key, kind="stable")
        ks = key[order]
        repeat = np.zeros(len(ks), bool)
        repeat[1:] = ks[1:] == ks[:-1]
        dup = order[repeat]
        if len(dup) == 0:
            return u, i
        part = rng.integers(0, len(u), len(dup))
        new1 = u[dup] * n_items + i[part]
        new2 = u[part] * n_items + i[dup]
        ok = ~_in_sorted(ks, new1) & ~_in_sorted(ks, new2) & (new1 != new2)
        dup, part, new1, new2 = dup[ok], part[ok], new1[ok], new2[ok]
        # Each edge and each new pair at most once in a round.
        keep = np.ones(len(dup), bool)
        for cols in (np.stack([dup, part], 1), np.stack([new1, new2], 1)):
            flat = cols.ravel()
            first = np.zeros(len(flat), bool)
            first[np.unique(flat, return_index=True)[1]] = True
            keep &= first.reshape(-1, 2).all(axis=1)
        dup, part = dup[keep], part[keep]
        i[dup], i[part] = i[part], i[dup].copy()
    raise RuntimeError(f"pairs still repeat after {SWAP_ROUNDS} rounds")


def generate(spec: dict) -> dict:
    """The dataset of ``spec`` (a configuration's ``dataset`` block) as
    columns u, i, t (int64), rows in a seeded order."""
    rng = np.random.default_rng(spec["data_seed"])
    n_u, n_i, n = spec["users"], spec["items"], spec["interactions"]
    off = spec["rank_offset"]
    du = degrees(n_u, n, spec["min_user"], spec["user_exponent"], off, n_i)
    di = degrees(n_i, n, spec["min_item"], spec["item_exponent"], off, n_u)
    du, di = du[rng.permutation(n_u)], di[rng.permutation(n_i)]
    u, i = simple_bipartite(du, di, rng)
    order = rng.permutation(n)
    t = rng.integers(1_000_000_000, 1_600_000_000, n)
    return {"u": u[order], "i": i[order], "t": t}


def ensure(spec: dict, root: str = CACHE) -> str:
    """The directory holding ``spec``'s dataset (``ratings.csv``,
    ``raw.npz``), written on first use under ``root``/<name>."""
    out = os.path.join(root, spec["name"])
    spec_path = os.path.join(out, SPEC_NAME)
    if os.path.exists(spec_path):
        with open(spec_path) as f:
            if json.load(f) == spec:
                return out
    os.makedirs(out, exist_ok=True)
    cols = generate(spec)
    tmp = os.path.join(out, f"{CSV_NAME}.part")
    with open(tmp, "w") as f:
        f.write("u_id,i_id,rating,time\n")
        f.write("".join(f"{a},{b},1,{c}\n" for a, b, c in zip(
            cols["u"].tolist(), cols["i"].tolist(), cols["t"].tolist())))
    os.replace(tmp, os.path.join(out, CSV_NAME))
    tmp = os.path.join(out, "raw.part.npz")
    np.savez(tmp, **cols)
    os.replace(tmp, os.path.join(out, RAW_NAME))
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return out


def load_raw(directory: str) -> dict:
    with np.load(os.path.join(directory, RAW_NAME)) as z:
        return {k: z[k] for k in z.files}
