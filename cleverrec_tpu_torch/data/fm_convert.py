"""Interaction file -> libFM featurizer (as
``cleverrec_tpu/data/fm_convert.py``, the reference's utils/fm_to_libfm.py
analog), with numpy in place of pandas.

Each rating becomes ``label,uidx:1,iidx:1``: users reindexed densely in
sorted order first, items after them, offset by the user count (the
layout of the bundled ml-1m.test.libfm).  The split is one
``np.random.default_rng(seed).permutation``, so a seed writes the same
bytes as the JAX package.  Columns are typed as pandas types them: int64
when every field is an integer, else float64, else text, so an integer
rating is written ``5`` and a fractional column ``4.0``.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np


def interactions_to_libfm(cols: Mapping[str, np.ndarray], out_train: str,
                          out_test: str, test_size: float = 0.2,
                          seed: int = 0,
                          label_col: str = "rating") -> tuple[int, int]:
    """Write train/test libFM files from the columns ``u_id``, ``i_id``
    and ``label_col`` of one table.  Returns (train_rows, test_rows)."""
    rng = np.random.default_rng(seed)
    users, u = np.unique(np.asarray(cols["u_id"]), return_inverse=True)
    _, i = np.unique(np.asarray(cols["i_id"]), return_inverse=True)
    u = u.reshape(-1).astype(np.int64)
    i = i.reshape(-1).astype(np.int64) + len(users)
    y = np.asarray(cols[label_col])

    perm = rng.permutation(len(y))
    n_test = int(round(test_size * len(y)))
    test_idx, train_idx = perm[:n_test], perm[n_test:]

    def write(path, sel):
        rows = np.char.add(
            np.char.add(y[sel].astype(str), ","),
            np.char.add(np.char.add(u[sel].astype(str), ":1,"),
                        np.char.add(i[sel].astype(str), ":1")))
        with open(path, "w") as f:
            f.write("\n".join(rows.tolist()))
            f.write("\n")

    os.makedirs(os.path.dirname(os.path.abspath(out_train)), exist_ok=True)
    write(out_train, train_idx)
    write(out_test, test_idx)
    return len(train_idx), len(test_idx)


def _typed(tokens: list[str]) -> np.ndarray:
    """One column as pandas' reader types it: int64, float64 or text."""
    for cast, dtype in ((int, np.int64), (float, np.float64)):
        try:
            return np.asarray([cast(t) for t in tokens], dtype=dtype)
        except ValueError:
            pass
    return np.asarray(tokens, dtype=object)


def _numeric(line: str, sep: str) -> bool:
    try:
        [float(x) for x in line.split(sep)[:2]]
        return True
    except ValueError:
        return False


def read_table(path: str, sep: str) -> dict[str, np.ndarray]:
    """``u_id``, ``i_id``, ``rating`` (and ``time`` where the file has a
    fourth field) of a delimited file, blank lines skipped.  The first
    line is a header unless its first two fields are numbers: a headerless
    file (ml-100k's u.data) keeps its first row."""
    with open(path) as f:
        first = f.readline().rstrip("\r\n")
        n_fields = len(f.readline().rstrip("\r\n").split(sep))
        f.seek(0)
        lines = [ln for ln in f.read().splitlines() if ln]
    names = ["u_id", "i_id", "rating", "time"][: max(min(n_fields, 4), 3)]
    if not _numeric(first, sep):
        lines = lines[1:]
    rows = [ln.split(sep) for ln in lines]
    return {name: _typed([r[c] for r in rows]) for c, name in enumerate(names)}


def convert_dataset(root_dir: str, dataset: str, file_name: str, sep: str,
                    out_dir: str | None = None, test_size: float = 0.2,
                    seed: int = 0) -> tuple[str, str]:
    """Reads a UIR(T) file and writes <dataset>.train.libfm /
    <dataset>.test.libfm next to it (or in ``out_dir``)."""
    cols = read_table(os.path.join(root_dir, dataset, file_name), sep)
    out_dir = out_dir or os.path.join(root_dir, dataset)
    out_train = os.path.join(out_dir, f"{dataset}.train.libfm")
    out_test = os.path.join(out_dir, f"{dataset}.test.libfm")
    interactions_to_libfm(cols, out_train, out_test, test_size, seed)
    return out_train, out_test
