"""Full-catalog top-k with the user's train items filtered out, and the
CleverRec ranking metrics, in plain PyTorch and NumPy.

- Scores are <user row, item row> over the whole catalog, a user's seen
  (train) items set to -inf; a product in FP32 with TF32 off, or with
  TF32 on for the control (``tf32``).
- Metrics as the CleverRec reference defines them (utils/metrics.py:9-19):
  HR@K = hits / min(K, |real|); "MRR"@K = the sum over hits of
  1 / (rank + 1); NDCG@K = sum over hits of 1 / log2(rank + 2), over the
  ideal DCG of all |real| items; means over the test users.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

BLOCK = 2048


@contextlib.contextmanager
def precision(tf32: bool):
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def seen_mask(users: np.ndarray, indptr: np.ndarray, ids: np.ndarray,
              items: int, device) -> torch.Tensor:
    """[len(users), items] bool: True at each user's seen items."""
    lens = indptr[users + 1] - indptr[users]
    rows = np.repeat(np.arange(len(users)), lens)
    cols = np.concatenate([ids[indptr[u]:indptr[u + 1]] for u in users]) \
        if len(users) else np.zeros(0, np.int64)
    mask = torch.zeros((len(users), items), dtype=torch.bool, device=device)
    mask[torch.as_tensor(rows, device=device),
         torch.as_tensor(cols, device=device)] = True
    return mask


def masked_scores(user_rows: torch.Tensor, item_table: torch.Tensor,
                  seen: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    with precision(tf32):
        scores = user_rows @ item_table.T
    return scores.float().masked_fill(seen, -torch.inf)


def blocks(n: int, size: int = BLOCK):
    for lo in range(0, n, size):
        yield lo, min(n, lo + size)


def topk_ids(user_table, item_table, users, seen_csr, k: int,
             tf32: bool = False):
    """[len(users), k] int64 ids (numpy): each user's k best unseen items,
    best first."""
    indptr, ids = seen_csr
    out = []
    for lo, hi in blocks(len(users)):
        u = users[lo:hi]
        rows = user_table[torch.as_tensor(u, device=user_table.device)]
        s = masked_scores(rows, item_table, seen_mask(
            u, indptr, ids, item_table.shape[0], user_table.device), tf32)
        out.append(torch.topk(s, k, dim=1).indices.cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, k), np.int64)


def metric_sums(rec: np.ndarray, users: np.ndarray, real_csr, topks):
    """{K: [HR, MRR, NDCG] summed over ``users``} of the rows ``rec``
    [len(users), >= max K] against each user's real (test) items."""
    indptr, ids = real_csr
    out = {k: np.zeros(3) for k in topks}
    for row, u in zip(rec, users):
        real = ids[indptr[u]:indptr[u + 1]]
        if len(real) == 0:
            continue
        idcg = sum(1.0 / np.log2(s + 2.0) for s in range(len(real)))
        pos = {int(item): r for r, item in reversed(list(enumerate(row)))}
        ranks = [pos[int(x)] for x in real if int(x) in pos]
        for k in topks:
            hits = [r for r in ranks if r < k]
            out[k] += (len(hits) / min(k, len(real)),
                       sum(1.0 / (r + 1.0) for r in hits),
                       sum(1.0 / np.log2(r + 2.0) for r in hits) / idcg)
    return out
