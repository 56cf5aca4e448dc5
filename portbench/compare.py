"""The numbers that decide ``correct``: the port's outputs against the
reference's, each a gap that a sound run keeps small.  ``limits/<cell>.json``
holds each number's limit; a run is correct when every number is at or
under its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ranking import blocks, masked_scores, seen_mask

# A leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone and is left out.
QUIET_LEAF = 1e-3


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    median = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in keep)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``follow``-shaped readings of the port (or what stands in its place)
    against the reference's: the worst relative loss gap, the worst
    leaf's gap of first-gradient norms, of change norms, and of the norms
    of either Adam moment after the steps."""
    median = float(np.median(list(ref["grad_norm"].values())))
    keep = [k for k, g in ref["grad_norm"].items()
            if g >= QUIET_LEAF * median]
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                     ref["loss"]))
    moment = max(_leaf_gap({k: v[n] for k, v in prog["moment_norms"].items()},
                           {k: v[n] for k, v in ref["moment_norms"].items()},
                           keep) for n in (0, 1))
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog["grad_norm"], ref["grad_norm"], keep),
            "change_gap": _leaf_gap(prog["change_norm"], ref["change_norm"],
                                    keep),
            "moment_gap": moment}


def draw_numbers(draw: dict, pairs_u, pairs_i, items: int, neg_ratio: int,
                 seen_csr, device="cpu") -> dict:
    """The sampler's epoch draw {u, i, j, w} ([steps, B] numpy) against the
    reference's train pairs, on ``device``: ``draw_pairs`` counts the
    slots by which the real (u, i) slots differ from every train pair
    ``neg_ratio`` times; ``draw_negatives`` counts the real slots whose
    negative is outside the catalog or among the user's train items."""
    def col(k):
        return torch.as_tensor(draw[k].reshape(-1), device=device)

    real = col("w") > 0
    u, i, j = (col(k)[real].long() for k in ("u", "i", "j"))
    got = torch.sort(u * items + i).values
    want = torch.sort((torch.as_tensor(pairs_u, device=device).long() * items
                       + torch.as_tensor(pairs_i, device=device).long())
                      .repeat_interleave(neg_ratio)).values
    n = min(len(got), len(want))
    pairs = abs(len(got) - len(want)) + int((got[:n] != want[:n]).sum())
    indptr, ids = seen_csr
    seen_keys = torch.as_tensor(
        np.repeat(np.arange(len(indptr) - 1), np.diff(indptr)) * items + ids,
        device=device)
    inside = (j >= 0) & (j < items)
    keys = u * items + j.clamp(0, items - 1)
    at = torch.searchsorted(seen_keys, keys).clamp(max=len(seen_keys) - 1)
    seen = seen_keys[at] == keys
    return {"draw_pairs": float(pairs),
            "draw_negatives": float((~inside | seen).sum())}


def rank_numbers(ids: np.ndarray, users: np.ndarray, user_table, item_table,
                 seen_csr, scores: np.ndarray | None = None) -> dict:
    """Top-k answers ``ids`` [n, k] (best first) of ``users`` against the
    reference's FP32 scores from ``user_table`` and ``item_table``:

    - ``bad_ids``: slots outside the catalog, seen in train, or repeated
      in their row;
    - ``rank_gap``: the widest gap, over rows and ranks r, by which the
      reference's score of the r-th answer lies below the reference's
      r-th best score, over the row's largest |score|;
    - ``score_gap`` (where ``scores`` are given): the widest gap between
      an answer's given score and the reference's, on the same scale."""
    indptr, seen_ids = seen_csr
    n_items = item_table.shape[0]
    dev = user_table.device
    bad, rank_gap, score_gap = 0, 0.0, 0.0
    for lo, hi in blocks(len(users)):
        u = users[lo:hi]
        s = masked_scores(user_table[torch.as_tensor(u, device=dev)],
                          item_table, seen_mask(u, indptr, seen_ids,
                                                n_items, dev))
        a = torch.as_tensor(ids[lo:hi], device=dev, dtype=torch.int64)
        k = a.shape[1]
        best = torch.topk(s, k, dim=1).values
        finite = torch.where(torch.isfinite(s), s.abs(),
                             torch.zeros_like(s))
        scale = finite.amax(dim=1, keepdim=True).clamp(min=1e-30)
        inside = (a >= 0) & (a < n_items)
        got = torch.gather(s, 1, a.clamp(0, n_items - 1))
        srt = a.sort(dim=1).values
        repeat = torch.zeros_like(inside)
        repeat[:, 1:] = srt[:, 1:] == srt[:, :-1]
        wrong = ~inside | ~torch.isfinite(got)
        bad += int(wrong.sum()) + int(repeat.sum())
        ok = ~wrong
        gap = torch.where(ok, (best - got) / scale, torch.zeros_like(got))
        rank_gap = max(rank_gap, float(gap.max()))
        if scores is not None:
            given = torch.as_tensor(scores[lo:hi], device=dev,
                                    dtype=torch.float32)
            diff = torch.where(ok, (given - got).abs() / scale,
                               torch.zeros_like(got))
            score_gap = max(score_gap, float(diff.max()))
    out = {"bad_ids": float(bad), "rank_gap": rank_gap}
    if scores is not None:
        out["score_gap"] = score_gap
    return out


def metric_numbers(prog: dict, ref: dict, n_users: int) -> dict:
    """``metric_gap``: the widest gap, over K and HR, MRR and NDCG, between
    the port's means and the reference's, in users' worth (times the
    number of test users)."""
    gap = max(abs(prog[k][m] - ref[k][m] / n_users) * n_users
              for k in ref for m in range(3))
    return {"metric_gap": float(gap)}
