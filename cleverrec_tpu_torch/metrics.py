"""Ranking metrics (a numpy-only copy of cleverrec_tpu/metrics.py).

Parity target: the reference's *nonstandard* formulas
(utils/metrics.py:9-29), reproduced exactly but vectorized over users:

- HR@K   = hits / min(K, |real_items|)
- "MRR"@K = sum over hit items of 1/(rank+1)   (sum of reciprocal ranks,
            NOT first-hit MRR — SURVEY.md section 2.5 item 7)
- NDCG@K = sum 1/log2(rank+2)  /  IDCG over |real_items| ideal slots

Standard first-hit MRR is available behind ``standard_mrr=True`` for users
who want textbook definitions; parity runs keep the default.

Inputs are padded numpy arrays so the whole test set is evaluated with a
handful of vector ops instead of the reference's per-user Python loops
(RankingRecommender.py:227-246).
"""

from __future__ import annotations

import numpy as np

PAD_ITEM = -1  # padding sentinel in real/rec item arrays


def pad_lists(lists, pad_value: int = PAD_ITEM, width: int | None = None) -> np.ndarray:
    """Pad a list of int lists to a [N, width] int32 array."""
    n = len(lists)
    width = width if width is not None else max((len(x) for x in lists), default=1)
    width = max(width, 1)
    out = np.full((n, width), pad_value, dtype=np.int32)
    for r, xs in enumerate(lists):
        if len(xs):
            out[r, : len(xs)] = np.asarray(xs, dtype=np.int32)
    return out


def _real_ranks(real: np.ndarray, rec: np.ndarray, k: int):
    """First-occurrence rank of each real item in the top-k list.

    Returns (rank [B, T] with k = miss, valid [B, T], n_real [B]).  The
    [B, T, k] match tensor is the expensive part — callers evaluating
    several cutoffs build it ONCE at max(topks) and derive each cutoff
    with ``rank < k``."""
    real = np.asarray(real)
    rec = np.asarray(rec)[:, :k]
    valid = real != PAD_ITEM                              # [B, T]
    matches = real[:, :, None] == rec[:, None, :]         # [B, T, k]
    matches &= valid[:, :, None] & (rec != PAD_ITEM)[:, None, :]
    found = matches.any(axis=2)                           # [B, T]
    rank = np.where(found, matches.argmax(axis=2), k)     # [B, T], k = miss
    return rank, valid, valid.sum(axis=1)


def _metrics_at(rank: np.ndarray, valid: np.ndarray, n_real: np.ndarray,
                k: int, standard_mrr: bool):
    """HR/MRR/NDCG at cutoff ``k`` from precomputed first-hit ranks."""
    T = valid.shape[1]
    n_real_safe = np.maximum(n_real, 1)
    found = rank < k
    hit = found.sum(axis=1).astype(np.float64)
    dcg = np.where(found, 1.0 / np.log2(rank + 2.0), 0.0).sum(axis=1)

    # IDCG over |real| ideal slots (reference accumulates 1/log2(id+2) for
    # every real item id, hit or not — utils/metrics.py:18).
    slot = np.arange(T, dtype=np.float64)
    idcg = np.where(valid, 1.0 / np.log2(slot + 2.0), 0.0).sum(axis=1)
    idcg = np.maximum(idcg, 1e-12)

    hr = hit / np.minimum(k, n_real_safe)
    if standard_mrr:
        # Textbook MRR: reciprocal rank of the FIRST hit only.
        best = np.where(found, rank, k).min(axis=1)
        mrr = np.where(best < k, 1.0 / (best + 1.0), 0.0)
    else:
        mrr = np.where(found, 1.0 / (rank + 1.0), 0.0).sum(axis=1)
    ndcg = dcg / idcg
    # Users with zero real items (shouldn't happen; defensive): zero out.
    empty = n_real == 0
    hr[empty] = 0.0
    mrr[empty] = 0.0
    ndcg[empty] = 0.0
    return hr, mrr, ndcg


def ranking_metrics(real: np.ndarray, rec: np.ndarray, k: int,
                    standard_mrr: bool = False):
    """Vectorized HR/MRR/NDCG at cutoff ``k``.

    Args:
      real: [B, T] ground-truth item ids, PAD_ITEM-padded.
      rec:  [B, R] recommended item ids in rank order (R >= k),
            PAD_ITEM-padded; only the first ``k`` columns are considered.
    Returns:
      (hr, mrr, ndcg): three float64 arrays of shape [B].
    """
    rank, valid, n_real = _real_ranks(real, rec, k)
    return _metrics_at(rank, valid, n_real, k, standard_mrr)


def ranking_metrics_topks(real: np.ndarray, rec: np.ndarray, topks,
                          standard_mrr: bool = False):
    """Metrics at several cutoffs: returns {k: (hr, mrr, ndcg)}.

    The [B, T, kmax] match tensor is built once; each cutoff is a cheap
    ``rank < k`` slice (a per-k rebuild tripled the compare work and
    memory at ml-1m scale)."""
    kmax = max(topks)
    rank, valid, n_real = _real_ranks(real, rec, kmax)
    return {k: _metrics_at(rank, valid, n_real, k, standard_mrr)
            for k in topks}


def rmse_mae(y: np.ndarray, y_pre: np.ndarray):
    """RMSE / MAE (reference: utils/metrics.py:22-29)."""
    y = np.asarray(y, dtype=np.float64)
    y_pre = np.asarray(y_pre, dtype=np.float64)
    res = y - y_pre
    return float(np.sqrt(np.mean(res ** 2))), float(np.mean(np.abs(res)))
