"""Lazy row-wise Adam for embedding tables (as
``cleverrec_tpu/ops/sparse_adam.py``), plain PyTorch.

Dense Adam rewrites every row of a table and its moments each step,
though a batch touches at most O(B) rows.  These functions update only
the touched rows: duplicate ids' gradients are summed first (as a dense
scatter-add sums them), then one gather, the Adam arithmetic and one
scatter per table.

Semantics: LazyAdam (tf.contrib.opt.LazyAdamOptimizer).  An untouched
row's moments do not decay between its occurrences, and the global step
count drives the bias correction.  That is not the reference's dense
Adam; the trainer takes this tier only when ``train.sparse_rows_force``
asks for it.

Every function updates its tensors in place and returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from cleverrec_tpu_torch.common import ADAM_B1, ADAM_B2, ADAM_EPS


def _segment_sums(ids: torch.Tensor, grads: torch.Tensor):
    """(ids sorted [M], gsum [M, d]): at every position the summed
    gradient of its id's run in sorted order.  No host synchronisation."""
    ids_s, order = torch.sort(ids.long(), stable=True)
    new = torch.ones_like(ids_s, dtype=torch.bool)
    new[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(new, 0) - 1
    sums = torch.zeros_like(grads).index_add_(0, seg, grads[order])
    return ids_s, sums[seg]


def dedup_rows(ids: torch.Tensor, grads: torch.Tensor, n_rows: int):
    """Sum the gradient rows of duplicate ids.

    Returns (rep [M], gsum [M, d]): ``rep`` holds each distinct id once,
    at the last of its run in sorted order, and ``n_rows`` (out of range)
    in every other slot; ``gsum[s]`` is the summed gradient of ``rep[s]``
    where ``rep[s]`` is an id."""
    ids_s, gsum = _segment_sums(ids, grads)
    is_last = torch.ones_like(ids_s, dtype=torch.bool)
    is_last[:-1] = ids_s[1:] != ids_s[:-1]
    return torch.where(is_last, ids_s, n_rows), gsum


def _adam_step(m, v, g, count: int, lr: float, b1: float, b2: float,
               eps: float):
    """(delta, m', v') of one Adam step at the post-step count
    ``count + 1`` (optax's convention), the bias corrections taken in
    float32 as the JAX tier takes them."""
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * (g * g)
    t = np.float32(count + 1)
    bc1, bc2 = (float(np.float32(1) - np.float32(b) ** t) for b in (b1, b2))
    delta = lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + eps))
    return delta, m2, v2


@torch.no_grad()
def sparse_rows_adam(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     ids: torch.Tensor, grads: torch.Tensor, count: int,
                     lr: float, b1: float = ADAM_B1, b2: float = ADAM_B2,
                     eps: float = ADAM_EPS):
    """One LazyAdam step, in place, on the rows of ``table`` [N, d] that
    ``ids`` [M] names, with ``grads`` [M, d] (duplicates summed).
    ``count`` is the global Adam count before the step."""
    # Every duplicate of a row computes the same new row from the same
    # segment sum, so the copies below write each touched row once over.
    rows, g = _segment_sums(ids, grads)
    delta, m2, v2 = _adam_step(mu[rows], nu[rows], g, count, lr, b1, b2, eps)
    table.index_copy_(0, rows, table[rows] - delta)
    mu.index_copy_(0, rows, m2)
    nu.index_copy_(0, rows, v2)
    return table, mu, nu


@torch.no_grad()
def dense_adam_leaf(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, count: int, lr: float,
                    b1: float = ADAM_B1, b2: float = ADAM_B2,
                    eps: float = ADAM_EPS):
    """Plain Adam, in place, on a dense leaf (CUNE_BPR's social scalar)."""
    delta, m2, v2 = _adam_step(m, v, g, count, lr, b1, b2, eps)
    p.sub_(delta)
    m.copy_(m2)
    v.copy_(v2)
    return p, m, v
