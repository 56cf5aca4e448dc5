"""Numeric columns of a delimited file, with numpy alone.

Same contract as ``cleverrec_tpu/data/fastcsv.py``'s ``read_columns``:
the first line is a header and is skipped (the reference reads with
``header=0``), the first ``n_cols`` fields of every other line are parsed
as float64, and extra fields are ignored.  Ids must be numeric; a field
that is not a number raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np


def read_columns(path: str, sep: str, n_cols: int,
                 skip_header: bool = True) -> list[np.ndarray]:
    """The first ``n_cols`` columns of ``path`` as float64 arrays."""
    if len(sep) == 1:
        table = np.loadtxt(path, delimiter=sep, skiprows=int(skip_header),
                           usecols=range(n_cols), dtype=np.float64,
                           ndmin=2, comments=None)
    else:
        # numpy's parser takes one-character delimiters; '::' files
        # (ml-1m) are split here instead.
        with open(path) as f:
            lines = f.read().splitlines()[int(skip_header):]
        rows = [ln.split(sep)[:n_cols] for ln in lines if ln]
        table = np.asarray(rows, dtype=np.float64).reshape(-1, n_cols)
    return [np.ascontiguousarray(table[:, c]) for c in range(n_cols)]
