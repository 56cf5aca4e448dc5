"""Host-side ranking-data preprocessing, with numpy alone.

The same load/filter/reindex/split/candidate pipeline as
``cleverrec_tpu/data/dataset.py`` (reference:
model/RankingPreprocess.py:12-134), on a dict of numpy columns in place
of a DataFrame:

- UI / UIR / UIRT files with a configurable separator; the first line is
  a header,
- user-min filter before item-min filter,
- sorted original ids map to 0..n-1,
- optional stable sort by (user, time),
- leave-one-out keeps users with <= 3 rows entirely in train; the random
  split takes a seeded permutation's head and tail,
- ``ui_train`` / ``ui_test`` list users in ascending order and each
  user's items in row order,
- candidate lists: ``neg_samples`` unseen items drawn without
  replacement, ground truth appended LAST.

Every random draw is the same ``numpy.random.Generator`` call, in the
same order, as in the JAX package's loader, so one seed gives identical
splits and candidate lists.

With ``social_file`` (a ``u_id,v_id`` trust list in the dataset's
directory, header line first, the ratings' separator) the edges whose
endpoints both survive the filters are reindexed with the user map:
``user_friends`` is ``{u: [v, ...]}`` with users ascending and each
user's friends in file order, and ``friends_padded`` the same lists as
a [U, F] matrix padded with the sentinel ``user_nums``, F capped by
``social.max_friends`` (the first F friends are kept).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from cleverrec_tpu_torch.config import Config

Columns = dict[str, np.ndarray]


@dataclass
class RankingData:
    """Preprocessed interactions in host memory."""

    user_nums: int
    item_nums: int
    ui_train: dict[int, list[int]]
    ui_test: dict[int, list[int]]          # candidate lists when candidate_eval
    ratings_num: int
    candidate_eval: bool
    neg_samples: int
    user_friends: dict[int, list[int]] | None = None
    friends_padded: np.ndarray | None = None  # [U, F] int32, pad user_nums

    def stats_line(self) -> str:
        return (f"user_nums={self.user_nums}, item_nums={self.item_nums}, "
                f"ratings_num={self.ratings_num}")


def _read_interactions(cfg: Config) -> Columns:
    from cleverrec_tpu_torch.data import fastcsv
    path = os.path.join(cfg.str("data.root_dir"), cfg.str("data.dataset"),
                        cfg.str("data.file_name"))
    fmt = cfg.str("data.format", "UI")
    names = {"UI": ["u_id", "i_id"],
             "UIR": ["u_id", "i_id", "rating"],
             "UIRT": ["u_id", "i_id", "rating", "time"]}[fmt]
    cols = dict(zip(names, fastcsv.read_columns(
        path, cfg.str("data.sep", ","), len(names))))
    for key in ("u_id", "i_id", "time"):
        if key in cols:
            cols[key] = cols[key].astype(np.int64)
    return cols


def _take(df: Columns, idx) -> Columns:
    return {k: v[idx] for k, v in df.items()}


def _sizes(values: np.ndarray) -> np.ndarray:
    """Per row: how many rows share its value (groupby().transform('size'))."""
    _, inverse, counts = np.unique(values, return_inverse=True,
                                   return_counts=True)
    return counts[inverse]


def _filter_min_counts(df: Columns, user_min: int, item_min: int) -> Columns:
    # Order matters and matches the reference: users first, then items.
    if user_min > 0:
        df = _take(df, _sizes(df["u_id"]) >= user_min)
    if item_min > 0:
        df = _take(df, _sizes(df["i_id"]) >= item_min)
    return df


def _reindex(values: np.ndarray) -> tuple[np.ndarray, int]:
    uniq = np.unique(values)
    return np.searchsorted(uniq, values), len(uniq)


def _split_loo(df: Columns) -> tuple[Columns, Columns]:
    """Last interaction per user to test; users with <= 3 rows stay in train."""
    u = df["u_id"]
    last = np.zeros(len(u), bool)
    # Index of each user's last row: first occurrence in the reversed array.
    _, first_rev = np.unique(u[::-1], return_index=True)
    last[len(u) - 1 - first_rev] = True
    to_test = last & (_sizes(u) > 3)
    return _take(df, ~to_test), _take(df, to_test)


def _split_random(df: Columns, ratios: tuple[float, float, float],
                  rng: np.random.Generator) -> tuple[Columns, Columns]:
    r1, r2, r3 = ratios
    if r1 < 0 or r3 < 0 or r1 + r3 > 1 + 1e-9:
        raise ValueError(
            f"data.split_ratio train+test = {r1}+{r3} > 1: the slices "
            "would overlap and leak train rows into the test set")
    n = len(df["u_id"])
    perm = rng.permutation(n)
    n_train = int(round(r1 * n))
    n_test = int(round(r3 * n))
    return _take(df, perm[:n_train]), _take(df, perm[n - n_test:])


def _group_lists(u: np.ndarray, i: np.ndarray) -> dict[int, list[int]]:
    """{user: [items in row order]}, users ascending
    (groupby('u_id')['i_id'].apply(list))."""
    order = np.argsort(u, kind="stable")
    users, starts = np.unique(u[order], return_index=True)
    groups = np.split(i[order], starts[1:])
    return {int(k): g.tolist() for k, g in zip(users, groups)}


def _sample_candidates(ui_train: dict, ui_test: dict, item_nums: int,
                       neg_samples: int, rng: np.random.Generator) -> dict:
    """Per test user: ``neg_samples`` unseen-in-train items without
    replacement, ground truth appended LAST (RankingPreprocess.py:120-129)."""
    all_items = np.arange(item_nums, dtype=np.int64)
    mask = np.ones(item_nums, dtype=bool)
    out = {}
    for u, truth in ui_test.items():
        seen = np.asarray(ui_train.get(u, []), dtype=np.int64)
        if seen.size == 0:
            pool = all_items
        else:
            mask[seen] = False
            pool = np.flatnonzero(mask)
            mask[seen] = True
        negs = rng.choice(pool, size=neg_samples, replace=False)
        out[u] = negs.tolist() + list(truth)
    return out


def _read_social(cfg: Config, user_ids: np.ndarray):
    """(user_friends, friends_padded) of ``social_file`` over the sorted
    original user ids ``user_ids`` (RankingPreprocess.py:52-67)."""
    from cleverrec_tpu_torch.data import fastcsv
    path = os.path.join(cfg.str("data.root_dir"), cfg.str("data.dataset"),
                        cfg.str("social_file"))
    u, v = (c.astype(np.int64) for c in fastcsv.read_columns(
        path, cfg.str("data.sep", ","), 2))
    keep = np.isin(u, user_ids) & np.isin(v, user_ids)
    user_friends = _group_lists(np.searchsorted(user_ids, u[keep]),
                                np.searchsorted(user_ids, v[keep]))
    max_f = max((len(fs) for fs in user_friends.values()), default=1)
    cap = cfg.int("social.max_friends", 0)
    if cap and max_f > cap:
        max_f = cap
    n = len(user_ids)
    friends_padded = np.full((n, max_f), n, dtype=np.int32)
    for uu, fs in user_friends.items():
        friends_padded[uu, : min(len(fs), max_f)] = fs[:max_f]
    return user_friends, friends_padded


def load_ranking_data(cfg: Config, rng: np.random.Generator | None = None,
                      logger=None) -> RankingData:
    rng = rng if rng is not None else np.random.default_rng(cfg.seed)
    df = _read_interactions(cfg)
    df = _filter_min_counts(df, cfg.int("data.user_min", 0),
                            cfg.int("data.item_min", 0))
    user_ids = np.unique(df["u_id"])
    df["u_id"], user_nums = _reindex(df["u_id"])
    df["i_id"], item_nums = _reindex(df["i_id"])
    ratings_num = len(df["u_id"])
    user_friends = friends_padded = None
    if "social_file" in cfg:
        user_friends, friends_padded = _read_social(cfg, user_ids)

    if cfg.bool("data.split_by_time", False) and "time" in df:
        df = _take(df, np.lexsort((df["time"], df["u_id"])))
    if cfg.split_way == "loo":
        train_df, test_df = _split_loo(df)
    else:
        ratios = tuple(cfg.float_list("data.split_ratio", [0.7, 0.2, 0.1]))
        train_df, test_df = _split_random(df, ratios, rng)

    ui_train = _group_lists(train_df["u_id"], train_df["i_id"])
    ui_test = _group_lists(test_df["u_id"], test_df["i_id"])

    neg_samples = cfg.neg_samples
    candidate_eval = cfg.candidate_eval
    if candidate_eval:
        ui_test = _sample_candidates(ui_train, ui_test, item_nums,
                                     neg_samples, rng)

    data = RankingData(
        user_nums=user_nums, item_nums=item_nums,
        ui_train=ui_train, ui_test=ui_test, ratings_num=ratings_num,
        candidate_eval=candidate_eval, neg_samples=neg_samples,
        user_friends=user_friends, friends_padded=friends_padded,
    )
    if logger is not None:
        logger.info(" Data: dataset=%s, split_way=%s, neg_samples=%d, %s",
                    cfg.str("data.dataset", "?"), cfg.split_way,
                    neg_samples, data.stats_line())
    return data
