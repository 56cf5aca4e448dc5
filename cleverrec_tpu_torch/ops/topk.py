"""Top-k selection with ``lax.top_k``'s tie rule (as
``cleverrec_tpu/ops/topk.py``): ``topk``, ``merge_topk``, the group-pruned
``grouped_topk`` and the chunked ``streaming_topk``.

``sharded_topk_scores`` merges the local top-k of each rank's slice of
the item axis over a mesh axis (``parallel/mesh.py``).

``lax.top_k`` breaks ties by the LOWEST index, and the JAX package relies
on it (candidate eval puts the ground truth last).  ``torch.topk``
promises no order among equal values, so every selection here orders by
(value descending, index ascending) through a stable sort.
"""

from __future__ import annotations

import torch

from typing import Callable

from cleverrec_tpu_torch.common import cdiv

# Below this width a plain selection wins over the grouped pipeline.
GROUPED_MIN_COLS = 16384
_NEG = -3.0e38   # finite mask sentinel (matches ops/scores.NEG)


def topk(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row, ties to the lowest index: ([B, k], [B, k])."""
    v, idx = torch.sort(values, dim=1, descending=True, stable=True)
    return v[:, :k], idx[:, :k]


def merge_topk(values, ids, k: int):
    """Merge candidate blocks: values/ids [B, M] -> top-k [B, k]."""
    v, idx = topk(values, k)
    return v, torch.gather(ids, 1, idx)


def grouped_topk(scores: torch.Tensor, k: int, group: int = 128,
                 min_cols: int = GROUPED_MIN_COLS):
    """Exact top-k via group-max pruning (cleverrec_tpu/ops/topk.py):

    1. the max of each ``group``-column block,
    2. the top k groups by max,
    3. those groups' columns, gathered in ascending group order,
    4. top-k over the [B, k*group] rescue set.

    Exact, ties included: an item ranked above the k-th in the order
    (value desc, index asc) lies in a group whose max ranks above the
    k-th group in the same order, so step 2 keeps it; step 3's ascending
    order makes step 4's position ties index ties.

    Masked slots must be <= -1e37 (-inf or the kernels' -3e38) and come
    back as exactly -inf; their indices may point past the row.  Rows
    narrower than ``min_cols``, too few groups for k, or a non-float32
    dtype take a plain ``topk``.
    """
    b, n = scores.shape
    g = cdiv(n, group)
    if n < min_cols or g < k or scores.dtype != torch.float32:
        return topk(scores, k)
    s = torch.clamp(scores, min=_NEG)
    if g * group > n:
        s = torch.nn.functional.pad(s, (0, g * group - n), value=_NEG)
    s3 = s.view(b, g, group)
    gi = topk(s3.amax(dim=2), k)[1].sort(dim=1).values          # [B, k]
    cand = torch.gather(s3, 1, gi[:, :, None].expand(b, k, group))
    v, ci = topk(cand.reshape(b, k * group), k)
    cols = (gi[:, :, None] * group
            + torch.arange(group, device=gi.device)).reshape(b, k * group)
    idx = torch.gather(cols, 1, ci)
    return torch.where(v > -1.0e37, v, torch.full_like(v, -torch.inf)), idx


def streaming_topk(score_chunk_fn: Callable[[torch.Tensor], torch.Tensor],
                   item_nums: int, k: int, chunk: int = 4096,
                   approx: bool = False, device=None):
    """Running top-k over item chunks: memory O(B * chunk) instead of the
    whole [B, I] score matrix.

    ``score_chunk_fn(item_ids [chunk])`` -> scores [B, chunk], already
    masked (seen items -inf); the ids are int64 on ``device`` (default
    the CPU), those of the last chunk clamped into the catalog, whose
    columns past it are set to -inf here.  Returns (values, ids) [B, k];
    slots past the catalog's unmasked items are -inf.

    A Python loop over the chunks carries the running top-k.  Each fresh
    chunk is reduced with ``grouped_topk`` where the JAX package takes its
    grouped branch (exact values; its -inf slots may point past the chunk
    and are clamped into it), or kept whole, then merged with the carry.
    The carry comes first in each merge, so ties go to the lowest item id
    throughout.

    ``approx=True``: the JAX package reduces each chunk with
    ``lax.approx_max_k``, the TPU's PartialReduce; off the TPU that is an
    exact selection, and the port selects each chunk with the exact
    ``topk`` (lowest index first), so both give the exact top-k.
    """
    grouped = not approx and chunk > 4 * k and chunk // 128 >= k
    best_v = best_i = None
    for c0 in range(0, item_nums, chunk):
        ids = torch.arange(c0, c0 + chunk, device=device)
        scores = score_chunk_fn(ids.clamp(max=item_nums - 1))
        if best_v is None:
            best_v = torch.full((scores.shape[0], k), -torch.inf,
                                dtype=scores.dtype, device=scores.device)
            best_i = torch.zeros((scores.shape[0], k), dtype=torch.long,
                                 device=scores.device)
        ids = ids.to(scores.device)
        if c0 + chunk > item_nums:
            scores = scores.masked_fill(ids >= item_nums, -torch.inf)
        if approx and chunk > k:
            scores, sel = topk(scores, k)
            cids = ids[sel]
        elif grouped and scores.dtype == torch.float32:
            scores, sel = grouped_topk(scores, k, min_cols=8192)
            cids = c0 + sel.clamp(max=chunk - 1)
        else:
            cids = ids.expand(scores.shape[0], -1)
        best_v, best_i = merge_topk(torch.cat([best_v, scores], dim=1),
                                    torch.cat([best_i, cids], dim=1), k)
    return best_v, best_i


def sharded_topk_scores(scores: torch.Tensor, k: int, mesh,
                        axis: str = "model"):
    """Global top-k of an item-axis-sharded score matrix
    (cleverrec_tpu/ops/topk.py:151-173).

    ``scores``: this rank's slice [B, I / n] of the [B, I] scores, the
    ranks of ``mesh``'s ``axis`` group holding the slices in index order
    (I padded to a multiple of n with -inf).  Each rank takes its slice's
    top-k (ids offset to global ones), the group gathers the k * n
    candidates in rank order, and one merge gives the exact global top-k
    on every rank: ties go to the lowest item id, as each slice's top-k
    and the gathered order both keep the lowest first."""
    shard_i = scores.shape[1]
    v, i = grouped_topk(scores, min(k, shard_i))
    i = i + mesh.index(axis) * shard_i
    return merge_topk(mesh.all_gather(v, axis, dim=1),
                      mesh.all_gather(i, axis, dim=1), k)
