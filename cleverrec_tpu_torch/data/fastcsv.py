"""Numeric columns of a delimited file (as
``cleverrec_tpu/data/fastcsv.py``'s ``read_columns``).

The first line is a header and is skipped (the reference reads with
``header=0``), the first ``n_cols`` fields of every other line are parsed
as float64, and extra fields are ignored.  Where the JAX package takes
its native parser, a one-byte separator and a first data line whose
first ``n_cols`` fields are numbers, the port takes its own copy of it
(``csrc/fastcsv.cpp``, built with ``g++`` on first use and called through
ctypes); a build or parse failure raises.  numpy parses every other file,
the role pandas plays in the JAX package; there a field that is not a
number raises ``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


def _native():
    from cleverrec_tpu_torch.ops import build
    lib = build.load_host("fastcsv")
    lib.fastcsv_count_rows.restype = ctypes.c_int64
    lib.fastcsv_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                       ctypes.c_int]
    lib.fastcsv_parse.restype = ctypes.c_int64
    lib.fastcsv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_DOUBLE_P), ctypes.c_int64]
    return lib


def available() -> bool:
    """Whether the native parser loads (``csrc/fastcsv.cpp``, built with
    ``g++`` on first use); ``read_columns`` raises where it is needed and
    does not."""
    try:
        _native()
    except (OSError, RuntimeError):
        return False
    return True


def _numeric_first_line(path: str, sep: str, n_cols: int,
                        skip_header: bool) -> bool:
    """The JAX package's probe: are the first ``n_cols`` fields of the
    first data line numbers?"""
    with open(path) as f:
        if skip_header:
            f.readline()
        probe = f.readline().rstrip("\r\n").split(sep)
    if len(probe) < n_cols:
        return False
    try:
        for tok in probe[:n_cols]:
            float(tok)
    except ValueError:
        return False
    return True


def _native_columns(path: str, sep: str, n_cols: int,
                    skip_header: bool) -> list[np.ndarray]:
    lib = _native()
    bpath, bsep = path.encode(), sep.encode()
    rows = lib.fastcsv_count_rows(bpath, bsep, int(skip_header))
    if rows < 0:
        raise OSError(f"fastcsv: cannot read {path}")
    cols = [np.empty(rows, dtype=np.float64) for _ in range(n_cols)]
    ptrs = (_DOUBLE_P * n_cols)(*[c.ctypes.data_as(_DOUBLE_P) for c in cols])
    got = lib.fastcsv_parse(bpath, bsep, int(skip_header), n_cols, ptrs,
                            rows)
    if got < 0:
        raise OSError(f"fastcsv: cannot parse {path}")
    return [c[:got] for c in cols]


def _numpy_columns(path: str, sep: str, n_cols: int,
                   skip_header: bool) -> list[np.ndarray]:
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


def read_columns(path: str, sep: str, n_cols: int,
                 skip_header: bool = True) -> list[np.ndarray]:
    """The first ``n_cols`` columns of ``path`` as float64 arrays."""
    if len(sep.encode()) == 1 and _numeric_first_line(path, sep, n_cols,
                                                      skip_header):
        return _native_columns(path, sep, n_cols, skip_header)
    return _numpy_columns(path, sep, n_cols, skip_header)
