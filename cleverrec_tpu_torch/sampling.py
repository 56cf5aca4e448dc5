"""Per-entity membership tables and the pairwise negative sampler: the
parts of ``cleverrec_tpu/sampling.py`` that ranking and BPR training
need.

Bitmaps are int32 with the bit pattern of the JAX package's uint32
``MemberTable.bits``: id ``i`` is bit ``i & 31`` of word ``i >> 5``.
int32 because torch on the CPU does not shift uint32; the CUDA kernels
read the words as ``uint32_t``.

One pairwise epoch is the reference's layout (utils/sampler.py:46-74):
every train pair repeated ``neg_ratio`` times, each with a uniform
negative drawn from the user's unseen items, globally shuffled and
padded with weight-0 rows to whole batches.  Ranks are drawn with an
explicit ``torch.Generator`` on the tables' device and resolved to ids
by ``unseen_by_rank``, which returns exactly the JAX complement table's
entry ``complement[e, r]``, so no complement table is built.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Bitmaps cost id_range/8 bytes per entity; above this the sorted rows
# are the only membership structure and ranking builds each batch's
# bitmaps on the fly (rows_to_bits).
BITMAP_BUDGET_BYTES = 1 << 30


class MemberTable(NamedTuple):
    """Per-entity membership sets over an id range [0, id_range)."""

    rows: np.ndarray        # [N, L] int32 sorted, padded with sentinel id_range
    lens: np.ndarray        # [N] int32
    bits: np.ndarray | None  # [N, ceil(id_range/32)] int32, or None


def build_member_table(sets: dict[int, list[int]], n_entities: int,
                       id_range: int,
                       bitmap_budget: int = BITMAP_BUDGET_BYTES,
                       ) -> MemberTable:
    """Host-side construction from {entity: [member ids]}."""
    ent = np.repeat(np.fromiter(sets.keys(), np.int64, len(sets)),
                    [len(v) for v in sets.values()])
    ids = np.fromiter((x for v in sets.values() for x in v), np.int64,
                      len(ent))
    pairs = np.unique(np.stack([ent, ids], axis=1), axis=0)   # sorted, unique
    lens = np.bincount(pairs[:, 0], minlength=n_entities).astype(np.int32)

    n_words = -(-id_range // 32)
    bits = None
    if n_entities * n_words * 4 <= bitmap_budget:
        words = np.zeros((n_entities, n_words), dtype=np.uint32)
        np.bitwise_or.at(words, (pairs[:, 0], pairs[:, 1] >> 5),
                         np.uint32(1) << (pairs[:, 1] & 31).astype(np.uint32))
        bits = words.view(np.int32)

    # Width is the longest LIST (duplicates included), as in the JAX table.
    width = max(max((len(v) for v in sets.values()), default=1), 1)
    rows = np.full((n_entities, width), id_range, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    slot = np.arange(len(pairs)) - starts[pairs[:, 0]]
    rows[pairs[:, 0], slot] = pairs[:, 1]
    return MemberTable(rows=rows, lens=lens, bits=bits)


def rows_to_bits(rows: torch.Tensor, id_range: int) -> torch.Tensor:
    """Packed bitmaps from sorted member rows: [B, L] ids (sentinel
    ``id_range`` pads) -> [B, ceil(id_range/32)] int32.  Builds one
    batch's bitmaps where the global table is past its budget.

    Ids within a row are unique, so adding single-bit words is OR; the
    sum is taken in int64 (no carries, below 2^32) and folded to int32's
    two's-complement pattern."""
    n_words = (id_range + 31) // 32
    rows = rows.long()
    words = torch.clamp(rows >> 5, max=n_words - 1)
    bit = torch.where(rows < id_range, torch.ones_like(rows) << (rows & 31),
                      torch.zeros_like(rows))
    out = torch.zeros((rows.shape[0], n_words), dtype=torch.int64,
                      device=rows.device).scatter_add_(1, words, bit)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def unseen_by_rank(rows: torch.Tensor, lens: torch.Tensor, e: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """Exact r-th UNSEEN id per entity, from the sorted rows alone.

    rows [N, L] sorted member ids padded with the sentinel id_range,
    lens [N]; e [B] entity ids; r [B] or [B, K] complement ranks in
    [0, id_range - lens[e]).  The r-th unseen id is ``r + c`` where
    ``c = |{j < lens[e] : rows[e, j] - j <= r}|``: every seen id at or
    below the answer shifts it up by one.  ``rows[e, j] - j`` is
    nondecreasing over the real entries, so c is one binary search,
    clamped to lens[e] (the sentinel pads are not monotone).  Returns
    int32 ids of r's shape."""
    L = rows.shape[1]
    r2 = r.reshape(r.shape[0], -1).long()                # [B, M]
    flat = rows.reshape(-1)
    e = e.long()
    base = (e * L)[:, None].expand_as(r2)
    lo = torch.zeros_like(r2)
    hi = lens[e].long()[:, None].expand_as(r2)
    for _ in range(max(L, 1).bit_length()):
        mid = (lo + hi) >> 1
        sj = flat[base + torch.clamp(mid, max=L - 1)]
        pred = (mid < hi) & ((sj - mid) <= r2)
        lo = torch.where(pred, mid + 1, lo)
        hi = torch.where(pred, hi, mid)
    return (r2 + lo).to(torch.int32).reshape(r.shape)


def epoch_permutation(gen: torch.Generator, epoch_rows: int,
                      padded_rows: int):
    """Shuffled row ids for one epoch with weight-0 padding: (perm
    [padded_rows] int64, valid [padded_rows] float32), where entries of
    perm at or past ``epoch_rows`` are padding."""
    perm = torch.randperm(padded_rows, generator=gen, device=gen.device)
    return perm, (perm < epoch_rows).to(torch.float32)


def pairwise_epoch_static(pos_u: np.ndarray, pos_i: np.ndarray,
                          lens: np.ndarray, item_nums: int, padded: int,
                          neg_ratio: int) -> dict[str, np.ndarray]:
    """Host-side per-run constants of ``pairwise_epoch_tensors``: the
    epoch's rows in PAIR ORDER (pair p occupies rows p*neg_ratio ..),
    padded to the step grid, with each row's unseen count.  The JAX
    layout's weight column is left out: ``epoch_permutation`` gives it."""
    rows_total = len(pos_u) * neg_ratio
    u = np.zeros(padded, np.int32)
    i = np.zeros(padded, np.int32)
    u[:rows_total] = np.repeat(pos_u, neg_ratio)
    i[:rows_total] = np.repeat(pos_i, neg_ratio)
    n_un = np.ones(padded, np.int32)
    n_un[:rows_total] = np.maximum(
        item_nums - np.asarray(lens)[u[:rows_total]], 1)
    return {"ord_u": u, "ord_i": i, "ord_nun": n_un}


def epoch_negatives(gen: torch.Generator, static: dict, rows: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """One uniform negative per row of the static layout: a rank drawn
    uniformly below the row's unseen count, resolved by
    ``unseen_by_rank`` (the exact branch of the JAX sampler's
    ``_epoch_negatives``)."""
    u = static["ord_u"]
    r = torch.randint(0, 2 ** 31 - 1, u.shape, generator=gen,
                      device=u.device, dtype=torch.int64)
    return unseen_by_rank(rows, lens, u, r % static["ord_nun"])


def pairwise_epoch_tensors(gen: torch.Generator, static: dict,
                           rows: torch.Tensor, lens: torch.Tensor,
                           rows_total: int, steps: int,
                           b: int) -> dict[str, torch.Tensor]:
    """The whole epoch's (u, i, j, w) as [steps, b] tensors: one negative
    draw over the pair-order layout of ``rows_total`` real rows, then one
    shuffle of the columns together.  ``static`` holds
    ``pairwise_epoch_static``'s arrays as tensors on the generator's
    device; u, i, j are int32, w is 1 on real rows and 0 on padding."""
    j = epoch_negatives(gen, static, rows, lens)
    perm, w = epoch_permutation(gen, rows_total, steps * b)
    return {"u": static["ord_u"][perm].reshape(steps, b),
            "i": static["ord_i"][perm].reshape(steps, b),
            "j": j[perm].reshape(steps, b),
            "w": w.reshape(steps, b)}
