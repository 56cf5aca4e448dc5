"""Per-entity membership tables: the part of ``cleverrec_tpu/sampling.py``
that ranking needs.  The negative samplers come with the training slice.

Bitmaps are int32 with the bit pattern of the JAX package's uint32
``MemberTable.bits``: id ``i`` is bit ``i & 31`` of word ``i >> 5``.
int32 because torch on the CPU does not shift uint32; the CUDA kernels
read the words as ``uint32_t``.
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
