"""libFM-format loader for the rating models (as
``cleverrec_tpu/data/libfm.py``).

Parity with the reference's rating preprocess (model/RatingPreprocess.py):
lines are ``label,feat,feat,...`` where each feat is ``idx:val``
(real-valued mode) or a bare token (one-hot mode); feature ids are
remapped on the fly, train file first, test file continuing the same map
(:56-85).  Ragged rows are padded to the widest row with the pad id
``feature_nums`` and value 0, so a padded slot adds nothing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from cleverrec_tpu_torch.config import Config


@dataclass
class RatingData:
    feature_nums: int
    is_real_valued: bool
    x_idx_tr: np.ndarray      # [N, F] int32, pad == feature_nums
    x_val_tr: np.ndarray      # [N, F] float32 (ones when one-hot)
    y_tr: np.ndarray          # [N] float32
    x_idx_t: np.ndarray
    x_val_t: np.ndarray
    y_t: np.ndarray


def _read_libfm(path: str, feature_map: dict, real_valued: bool):
    xs, vs, ys = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if not parts or parts[0] == "":
                continue
            ys.append(float(parts[0]))
            row_i, row_v = [], []
            for col in parts[1:]:
                if real_valued and ":" in col:
                    tok, val = col.rsplit(":", 1)
                    row_v.append(float(val))
                else:
                    tok = col
                    row_v.append(1.0)
                if tok not in feature_map:
                    feature_map[tok] = len(feature_map)
                row_i.append(feature_map[tok])
            xs.append(row_i)
            vs.append(row_v)
    return xs, vs, ys


def _pad(xs, vs, width, pad_id):
    n = len(xs)
    xi = np.full((n, width), pad_id, dtype=np.int32)
    xv = np.zeros((n, width), dtype=np.float32)
    for r, (row_i, row_v) in enumerate(zip(xs, vs)):
        xi[r, : len(row_i)] = row_i
        xv[r, : len(row_v)] = row_v
    return xi, xv


def load_rating_data(cfg: Config) -> RatingData:
    """``<root>/<dataset>/<dataset><train>`` and ``...<test>`` (the confs:
    ``.train.libfm``, ``.test.libfm``) as padded arrays."""
    base = os.path.join(cfg.str("data.root_dir"), cfg.str("data.dataset"))
    train = os.path.join(base, cfg.str("data.dataset") + cfg.str("train"))
    test = os.path.join(base, cfg.str("data.dataset") + cfg.str("test"))
    real_valued = cfg.bool("is_real_valued", False)
    fmap: dict = {}
    xs_tr, vs_tr, y_tr = _read_libfm(train, fmap, real_valued)
    xs_t, vs_t, y_t = _read_libfm(test, fmap, real_valued)
    f_nums = len(fmap)
    width = max(max((len(r) for r in xs_tr), default=1),
                max((len(r) for r in xs_t), default=1))
    xi_tr, xv_tr = _pad(xs_tr, vs_tr, width, f_nums)
    xi_t, xv_t = _pad(xs_t, vs_t, width, f_nums)
    return RatingData(feature_nums=f_nums, is_real_valued=real_valued,
                      x_idx_tr=xi_tr, x_val_tr=xv_tr,
                      y_tr=np.asarray(y_tr, np.float32),
                      x_idx_t=xi_t, x_val_t=xv_t,
                      y_t=np.asarray(y_t, np.float32))
