"""Per-entity membership tables and the pairwise, pointwise, CML and
social samplers: the parts of ``cleverrec_tpu/sampling.py`` that ranking
and the training of BPR, the NCF, social-triple and metric-learning
families need.

Bitmaps are int32 with the bit pattern of the JAX package's uint32
``MemberTable.bits``: id ``i`` is bit ``i & 31`` of word ``i >> 5``.
int32 because torch on the CPU does not shift uint32; the CUDA kernels
read the words as ``uint32_t``.

One pairwise epoch is the reference's layout (utils/sampler.py:46-74):
every train pair repeated ``neg_ratio`` times, each with a uniform
negative drawn from the user's unseen items, globally shuffled and
padded with weight-0 rows to whole batches.  A pointwise epoch
(utils/sampler.py:10-43) holds each train pair once as a positive and
``neg_ratio`` times with a uniform negative, and a CML epoch
(utils/sampler.py:77-99) each train pair once with ``neg_ratio``
uniform negatives.  Ranks are drawn with an
explicit ``torch.Generator`` on the tables' device and resolved to ids
by ``unseen_by_rank``, which returns exactly the JAX complement table's
entry ``complement[e, r]``, so no complement table is built.

The social epochs (SBPR and CUNE_BPR: rows (u, i, k, j, suk); TBPR:
(u, i, s, t, j)) keep the pairwise layout over the pairs the model keeps.
Their negative avoids the union of the user's seen items and social
items, drawn by rank from that union's ``MemberTable``; k, s and t are
uniform picks from CSR-flat per-user lists (``build_csr_lists``).

The per-step batch builders (``pairwise_batch``, ``pointwise_batch``,
``cml_batch``, ``sbpr_batch``, ``tbpr_batch``, ``samn_batch``) take one
step's shuffled row ids of ``epoch_permutation`` and draw that step's
rows (utils/sampler.py's per-batch layout; the trainer's
``train.sbpr_epoch_tensors=False``).  Their tables are ``MemberTable``s
of tensors on the generator's device (``table_to``): ``member`` tests
membership through the bitmap, else the sorted rows;
``sample_not_in`` draws exactly by rank from the sorted rows, and
``_reject`` draws uniforms and redraws those in a set, the fallback
where a table has no rows or a draw must avoid several sets.

Popularity negatives (``neg_sampling=popularity``): where a sampler is
given ``pop_cdf``, the item cumulative popularity [I], its negatives are
``sample_not_in_popular``'s, candidates drawn by inverting the CDF and
rejected against the seen set, in place of the exact uniform rank draw
(the JAX sampler's ``_draw_negatives`` and ``_epoch_negatives``).
``social_pairwise_batch`` draws the dual-domain models' social rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Bitmaps cost id_range/8 bytes per entity; above this the sorted rows
# are the only membership structure and ranking builds each batch's
# bitmaps on the fly (rows_to_bits).
BITMAP_BUDGET_BYTES = 1 << 30
# Rejection: candidates drawn at once per slot, then corrective redraws.
TRIES = 32
EXTRA_ROUNDS = 2


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


def permute_rows(table: MemberTable, old_of_new: np.ndarray,
                 id_range: int) -> MemberTable:
    """``table``'s rows, lens and bits (numpy) in the order ``old_of_new``
    [N']: new entity k holds old entity old_of_new[k]'s set, and an entry
    at or past the table's N entities (a filler slot of the grouped
    epoch's user order) an empty set: lens 0, rows all ``id_range``, no
    bit set."""
    n = len(table.lens)
    old = np.asarray(old_of_new)
    filler = old >= n
    safe = np.where(filler, 0, old)
    rows = np.asarray(table.rows)[safe]
    rows[filler] = id_range
    lens = np.where(filler, 0, np.asarray(table.lens)[safe]).astype(np.int32)
    bits = None
    if table.bits is not None:
        bits = np.asarray(table.bits)[safe]
        bits[filler] = 0
    return MemberTable(rows=rows, lens=lens, bits=bits)


def table_to(table: MemberTable, device) -> MemberTable:
    """The table's arrays as tensors on ``device`` (None stays None)."""
    return MemberTable(*(None if a is None else torch.as_tensor(a,
                                                                device=device)
                         for a in table))


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


def member(table: MemberTable, e: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """Is x[b, ...] in entity e[b]'s set?  e [B]; x [B] or [B, ...]
    (batch axis leading); ``table`` holds tensors.  The bitmap when the
    table has one, else a binary search of the sorted rows."""
    flat = x.reshape(x.shape[0], -1).long()               # [B, M]
    e = e.long()
    if table.bits is not None:
        n_words = table.bits.shape[1]
        word = table.bits.reshape(-1)[e[:, None] * n_words
                                      + (flat >> 5)].long()
        return ((word >> (flat & 31)) & 1).bool().reshape(x.shape)
    rows = table.rows[e]                                  # [B, L]
    idx = torch.searchsorted(rows, flat.to(rows.dtype))
    hit = torch.gather(rows, 1, torch.clamp(idx, max=rows.shape[1] - 1))
    return (hit == flat).reshape(x.shape)


def _randint(gen: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(0, high, tuple(shape), generator=gen,
                         device=gen.device, dtype=torch.int64)


def _first_good(draw, shape, is_bad, extra_rounds: int = EXTRA_ROUNDS,
                tries: int = TRIES) -> torch.Tensor:
    """Draws of ``draw(shape)`` avoiding ``is_bad``: one round of ``tries``
    candidates a slot (the first good one wins; a slot with none keeps
    its first), then ``extra_rounds`` redraws, each taken only where it
    is good and the slot's current draw is not.  ``is_bad`` maps
    [*shape, T] ids to [*shape, T] bools.  int32 ids of ``shape``."""
    draws = draw(tuple(shape) + (tries,))
    bad = is_bad(draws)
    first = torch.argmax((~bad).to(torch.int8), dim=-1)
    j = torch.gather(draws, -1, first[..., None])[..., 0]
    for _ in range(extra_rounds):
        new = draw(j.shape)
        bad2 = is_bad(torch.stack([j, new], dim=-1))
        j = torch.where(bad2[..., 0] & ~bad2[..., 1], new, j)
    return j.to(torch.int32)


def _reject(gen: torch.Generator, n_range: int, shape, is_bad,
            extra_rounds: int = EXTRA_ROUNDS,
            tries: int = TRIES) -> torch.Tensor:
    """Uniform draws from [0, n_range) avoiding ``is_bad``
    (``_first_good``).  A slot stays bad with probability
    density^(tries + extra_rounds)."""
    return _first_good(lambda shp: _randint(gen, n_range, shp), shape,
                       is_bad, extra_rounds, tries)


def _pop_draw(gen: torch.Generator, pop_cdf: torch.Tensor,
              shape) -> torch.Tensor:
    """Ids of ``shape`` drawn in proportion to popularity: uniforms in
    [0, 1) inverted through ``pop_cdf`` (the left search, as
    ``jnp.searchsorted``'s), clipped to [0, I - 1]."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    cand = torch.searchsorted(pop_cdf, u.reshape(-1)).reshape(u.shape)
    return torch.clamp(cand, max=pop_cdf.shape[0] - 1)


def sample_not_in_popular(gen: torch.Generator, table: MemberTable,
                          e: torch.Tensor, pop_cdf: torch.Tensor,
                          shape) -> torch.Tensor:
    """Popularity-proportional negatives outside entity e's set, [B] or
    [B, K] int32 (cleverrec_tpu/sampling.py:323-358): ``TRIES``
    candidates a slot by CDF inversion, the first unseen one kept, then
    ``EXTRA_ROUNDS`` corrective redraws; a slot whose candidates were
    all seen keeps the first.  A draw collides with the user's seen
    popularity mass, not its seen density, so a heavy user's slot can
    stay seen with a probability of a percent or so, as under JAX."""
    return _first_good(lambda shp: _pop_draw(gen, pop_cdf, shp), shape,
                       lambda q: member(table, e, q))


def draw_negatives(gen: torch.Generator, table: MemberTable,
                   e: torch.Tensor, item_nums: int, shape,
                   pop_cdf: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform unseen negatives (``sample_not_in``), or popularity ones
    where ``pop_cdf`` is given."""
    if pop_cdf is not None:
        return sample_not_in_popular(gen, table, e, pop_cdf, shape)
    return sample_not_in(gen, table, e, item_nums, shape)


def sample_not_in(gen: torch.Generator, table: MemberTable, e: torch.Tensor,
                  n_range: int, shape) -> torch.Tensor:
    """Uniform draws from [0, n_range) outside entity e's set; ``shape``
    is [B] or [B, K] with B = len(e), int32.  With sorted rows the draw
    is exact: a rank below the unseen count resolved by
    ``unseen_by_rank`` (the JAX complement table's entry for that rank);
    a table of bitmaps alone rejects with ``_reject``."""
    if table.rows is None:
        return _reject(gen, n_range, shape, lambda q: member(table, e, q))
    n_un = torch.clamp(n_range - table.lens[e.long()].long(), min=1)
    r = _randint(gen, 2 ** 31 - 1, shape)
    return unseen_by_rank(table.rows, table.lens, e,
                          r % (n_un[:, None] if len(shape) == 2 else n_un))


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


def pointwise_epoch_static(pos_u: np.ndarray, pos_i: np.ndarray,
                           lens: np.ndarray, item_nums: int, padded: int,
                           neg_ratio: int) -> dict[str, np.ndarray]:
    """Host-side per-run constants of ``pointwise_epoch_tensors``: the
    epoch's rows in GROUP order (pair p occupies rows p*(1+neg_ratio) ..,
    slot 0 the positive with y = 1, the rest negatives with y = 0; the
    reference's utils/sampler.py:10-43 layout), padded to the step grid,
    with each row's unseen count.  As in ``pairwise_epoch_static``, the
    weight column is left out: ``epoch_permutation`` gives it."""
    grp = 1 + neg_ratio
    rows_total = len(pos_u) * grp
    u = np.zeros(padded, np.int32)
    i = np.zeros(padded, np.int32)
    u[:rows_total] = np.repeat(pos_u, grp)
    i[:rows_total] = np.repeat(pos_i, grp)
    y = np.zeros(padded, np.float32)
    y[np.arange(0, rows_total, grp)] = 1.0
    n_un = np.ones(padded, np.int32)
    n_un[:rows_total] = np.maximum(
        item_nums - np.asarray(lens)[u[:rows_total]], 1)
    return {"ord_u": u, "ord_i": i, "ord_y": y, "ord_nun": n_un}


# Rows of a whole-epoch popularity draw a chunk: TRIES candidates a row
# are drawn and tested at once.
POP_CHUNK = 1 << 16


def epoch_negatives(gen: torch.Generator, static: dict, rows: torch.Tensor,
                    lens: torch.Tensor, k: int | None = None,
                    pop_cdf: torch.Tensor | None = None,
                    bits: torch.Tensor | None = None) -> torch.Tensor:
    """One negative per row of the static layout, or ``k`` of them
    ([rows, k]; the CML protocol).  Uniform: a rank drawn uniformly below
    the row's unseen count, resolved by ``unseen_by_rank`` (the exact
    branch of the JAX sampler's ``_epoch_negatives``).  With ``pop_cdf``:
    ``sample_not_in_popular`` against the table of ``rows``, ``lens``
    and ``bits`` (the bitmap, if any, tests membership), in chunks of
    ``POP_CHUNK`` rows."""
    u = static["ord_u"]
    if pop_cdf is not None:
        table = MemberTable(rows, lens, bits)
        return torch.cat([
            sample_not_in_popular(gen, table, uc, pop_cdf,
                                  uc.shape if k is None else (len(uc), k))
            for uc in u.split(POP_CHUNK)])
    nun = static["ord_nun"]
    shape = u.shape if k is None else (u.shape[0], k)
    r = torch.randint(0, 2 ** 31 - 1, shape, generator=gen,
                      device=u.device, dtype=torch.int64)
    return unseen_by_rank(rows, lens, u,
                          r % (nun if k is None else nun[:, None]))


def pairwise_epoch_tensors(gen: torch.Generator, static: dict,
                           rows: torch.Tensor, lens: torch.Tensor,
                           rows_total: int, steps: int, b: int,
                           pop_cdf: torch.Tensor | None = None,
                           bits: torch.Tensor | None = None
                           ) -> dict[str, torch.Tensor]:
    """The whole epoch's (u, i, j, w) as [steps, b] tensors: one negative
    draw over the pair-order layout of ``rows_total`` real rows, then one
    shuffle of the columns together.  ``static`` holds
    ``pairwise_epoch_static``'s arrays as tensors on the generator's
    device; u, i, j are int32, w is 1 on real rows and 0 on padding.
    ``pop_cdf`` and ``bits``: popularity negatives (``epoch_negatives``)."""
    j = epoch_negatives(gen, static, rows, lens, pop_cdf=pop_cdf, bits=bits)
    perm, w = epoch_permutation(gen, rows_total, steps * b)
    return {"u": static["ord_u"][perm].reshape(steps, b),
            "i": static["ord_i"][perm].reshape(steps, b),
            "j": j[perm].reshape(steps, b),
            "w": w.reshape(steps, b)}


def cml_epoch_tensors(gen: torch.Generator, static: dict,
                      rows: torch.Tensor, lens: torch.Tensor,
                      rows_total: int, steps: int, b: int,
                      pop_cdf: torch.Tensor | None = None,
                      bits: torch.Tensor | None = None, *,
                      neg_ratio: int) -> dict[str, torch.Tensor]:
    """The whole epoch's (u, i, w) as [steps, b] and negs as
    [steps, b, neg_ratio]: one row per train pair (the static layout is
    ``pairwise_epoch_static(..., neg_ratio=1)``), ``neg_ratio``
    independent uniform unseen negatives each (duplicates possible), one
    shuffle of the rows (utils/sampler.py:77-99); popularity negatives
    with ``pop_cdf``."""
    negs = epoch_negatives(gen, static, rows, lens, k=neg_ratio,
                           pop_cdf=pop_cdf, bits=bits)
    perm, w = epoch_permutation(gen, rows_total, steps * b)
    return {"u": static["ord_u"][perm].reshape(steps, b),
            "i": static["ord_i"][perm].reshape(steps, b),
            "w": w.reshape(steps, b),
            "negs": negs[perm].reshape(steps, b, neg_ratio)}


def pointwise_epoch_tensors(gen: torch.Generator, static: dict,
                            rows: torch.Tensor, lens: torch.Tensor,
                            rows_total: int, steps: int, b: int,
                            pop_cdf: torch.Tensor | None = None,
                            bits: torch.Tensor | None = None
                            ) -> dict[str, torch.Tensor]:
    """The whole epoch's (u, i, y, w) as [steps, b] tensors: one negative
    draw over ``pointwise_epoch_static``'s group-order layout (positive
    slots keep their item), then one shuffle of the columns together.
    u, i are int32; y is 1 on positive slots; w is 1 on real rows and 0
    on padding; popularity negatives with ``pop_cdf``."""
    j = epoch_negatives(gen, static, rows, lens, pop_cdf=pop_cdf, bits=bits)
    i = torch.where(static["ord_y"] > 0, static["ord_i"], j)
    perm, w = epoch_permutation(gen, rows_total, steps * b)
    return {"u": static["ord_u"][perm].reshape(steps, b),
            "i": i[perm].reshape(steps, b),
            "y": static["ord_y"][perm].reshape(steps, b),
            "w": w.reshape(steps, b)}


# -- the social-triple samplers -------------------------------------------

def build_csr_lists(sets: dict[int, list[int]], n_entities: int,
                    aux: dict[int, list[float]] | None = None
                    ) -> dict[str, np.ndarray]:
    """CSR-flat per-entity lists for uniform draws: {"flat": [nnz + 1]
    int32 (one pad at the end), "off": [N] int32 start offsets, "suk":
    [nnz + 1] float32 aux values aligned with flat (zeros without
    ``aux``)}.  Each entity's ids come as given (``build_spu``'s lists
    are sorted and unique), so a draw sees the same id at the same slot
    as the JAX sampler."""
    lens = np.zeros(n_entities, np.int64)
    for e, ids in sets.items():
        lens[e] = len(ids)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    order = sorted(e for e, ids in sets.items() if ids)
    flat = np.concatenate([np.asarray(sets[e], np.int32) for e in order]
                          + [np.zeros(1, np.int32)])
    suk = np.zeros(len(flat), np.float32)
    if aux is not None and order:
        suk[:-1] = np.concatenate([np.asarray(aux[e], np.float32)
                                   for e in order])
    return {"flat": flat, "off": off, "suk": suk}


def csr_lens(csr: dict[str, np.ndarray]) -> np.ndarray:
    """Each entity's list length in a ``build_csr_lists`` dict."""
    return np.diff(np.append(csr["off"], len(csr["flat"]) - 1)).astype(
        np.int32)


def sbpr_epoch_static(pos_u: np.ndarray, pos_i: np.ndarray,
                      social_lens: np.ndarray, spu_lens: np.ndarray,
                      spu_off: np.ndarray, item_nums: int, padded: int,
                      neg_ratio: int) -> dict[str, np.ndarray]:
    """Host-side per-run constants of ``sbpr_epoch_tensors``: the pairwise
    layout of ``pairwise_epoch_static``, each row's unseen count against
    the seen-union-SPu set (``social_lens``, utils/sampler.py:117-119),
    and its SPu list's offset and length (at least 1)."""
    rows_total = len(pos_u) * neg_ratio
    out = pairwise_epoch_static(pos_u, pos_i, social_lens, item_nums, padded,
                                neg_ratio)
    u = out["ord_u"][:rows_total]
    spulen = np.ones(padded, np.int32)
    spulen[:rows_total] = np.maximum(np.asarray(spu_lens)[u], 1)
    spuoff = np.zeros(padded, np.int32)
    spuoff[:rows_total] = np.asarray(spu_off)[u]
    return {**out, "ord_spulen": spulen, "ord_spuoff": spuoff}


def tbpr_epoch_static(pos_u: np.ndarray, pos_i: np.ndarray,
                      social_lens: np.ndarray, ts_lens: np.ndarray,
                      ts_off: np.ndarray, tw_lens: np.ndarray,
                      tw_off: np.ndarray, item_nums: int, padded: int,
                      neg_ratio: int) -> dict[str, np.ndarray]:
    """``sbpr_epoch_static`` over the strong-tie lists, plus the weak-tie
    lists' offsets and lengths; ``social_lens`` counts seen, strong and
    weak items together."""
    out = sbpr_epoch_static(pos_u, pos_i, social_lens, ts_lens, ts_off,
                            item_nums, padded, neg_ratio)
    rows_total = len(pos_u) * neg_ratio
    u = out["ord_u"][:rows_total]
    twlen = np.ones(padded, np.int32)
    twlen[:rows_total] = np.maximum(np.asarray(tw_lens)[u], 1)
    twoff = np.zeros(padded, np.int32)
    twoff[:rows_total] = np.asarray(tw_off)[u]
    return {**out, "ord_twlen": twlen, "ord_twoff": twoff}


def _list_pick(gen: torch.Generator, off: torch.Tensor,
               length: torch.Tensor) -> torch.Tensor:
    """Per row, the flat index of a uniform pick from its CSR list."""
    raw = torch.randint(0, 2 ** 31 - 1, off.shape, generator=gen,
                        device=off.device, dtype=torch.int64)
    return off + raw % length


def sbpr_epoch_tensors(gen: torch.Generator, static: dict,
                       rows: torch.Tensor, lens: torch.Tensor,
                       spu_csr: dict, rows_total: int, steps: int,
                       b: int) -> dict[str, torch.Tensor]:
    """The whole epoch's (u, i, k, j, suk, w) as [steps, b] tensors: the
    negative j by rank from the union table (``rows``, ``lens``), the
    social item k and its suk from the user's SPu list, then one shuffle
    of the columns together (utils/sampler.py:102-141).  ``static`` holds
    ``sbpr_epoch_static``'s arrays and ``spu_csr`` the ``flat`` and
    ``suk`` of ``build_csr_lists``, as tensors on the generator's
    device."""
    j = epoch_negatives(gen, static, rows, lens)
    sidx = _list_pick(gen, static["ord_spuoff"], static["ord_spulen"])
    perm, w = epoch_permutation(gen, rows_total, steps * b)
    cols = {"u": static["ord_u"], "i": static["ord_i"],
            "k": spu_csr["flat"][sidx], "j": j, "suk": spu_csr["suk"][sidx]}
    out = {key: v[perm].reshape(steps, b) for key, v in cols.items()}
    out["w"] = w.reshape(steps, b)
    return out


def tbpr_epoch_tensors(gen: torch.Generator, static: dict,
                       rows: torch.Tensor, lens: torch.Tensor, ts_csr: dict,
                       tw_csr: dict, rows_total: int, steps: int,
                       b: int) -> dict[str, torch.Tensor]:
    """The whole epoch's (u, i, s, t, j, w) as [steps, b] tensors: as
    ``sbpr_epoch_tensors``, with a strong-tie item s and a weak-tie item
    t for TBPR's chain i > s > t > j."""
    j = epoch_negatives(gen, static, rows, lens)
    s_idx = _list_pick(gen, static["ord_spuoff"], static["ord_spulen"])
    t_idx = _list_pick(gen, static["ord_twoff"], static["ord_twlen"])
    perm, w = epoch_permutation(gen, rows_total, steps * b)
    cols = {"u": static["ord_u"], "i": static["ord_i"],
            "s": ts_csr["flat"][s_idx], "t": tw_csr["flat"][t_idx], "j": j}
    out = {key: v[perm].reshape(steps, b) for key, v in cols.items()}
    out["w"] = w.reshape(steps, b)
    return out


# -- the per-step batch builders -----------------------------------------

def _pair_rows(rows, pos_u, pos_i, group: int):
    """Each row's train pair when pair p fills ``group`` rows."""
    n = pos_u.shape[0]
    p = (rows.long() % (n * group)) // group
    return pos_u[p], pos_i[p]


def pairwise_batch(gen, rows, valid, pos_u, pos_i, seen: MemberTable,
                   item_nums, neg_ratio, pop_cdf=None):
    """(u, i, j, w) rows: pair p repeated neg_ratio times
    (utils/sampler.py:46-74); popularity negatives with ``pop_cdf``."""
    u, i = _pair_rows(rows, pos_u, pos_i, neg_ratio)
    j = draw_negatives(gen, seen, u, item_nums, u.shape, pop_cdf)
    return {"u": u, "i": i, "j": j, "w": valid}


def pointwise_batch(gen, rows, valid, pos_u, pos_i, seen: MemberTable,
                    item_nums, neg_ratio, pop_cdf=None):
    """(u, i, y, w) rows: a positive and neg_ratio negatives a pair
    (utils/sampler.py:10-43); popularity negatives with ``pop_cdf``."""
    n, grp = pos_u.shape[0], 1 + neg_ratio
    r = rows.long() % (n * grp)
    u, i_pos = pos_u[r // grp], pos_i[r // grp]
    is_pos = (r % grp) == 0
    j = draw_negatives(gen, seen, u, item_nums, u.shape, pop_cdf)
    return {"u": u, "i": torch.where(is_pos, i_pos, j),
            "y": is_pos.to(torch.float32), "w": valid}


def cml_batch(gen, rows, valid, pos_u, pos_i, seen: MemberTable, item_nums,
              neg_ratio, pop_cdf=None):
    """(u, i, negs [B, K], w) rows: one a pair (utils/sampler.py:77-99);
    popularity negatives with ``pop_cdf``."""
    u, i = _pair_rows(rows, pos_u, pos_i, 1)
    negs = draw_negatives(gen, seen, u, item_nums, (u.shape[0], neg_ratio),
                          pop_cdf)
    return {"u": u, "i": i, "negs": negs, "w": valid}


def _pick(gen, table: MemberTable, csr: dict, u):
    """The flat index of a uniform pick from each user's CSR list."""
    raw = _randint(gen, 2 ** 31 - 1, u.shape)
    return csr["off"][u.long()].long() + raw % torch.clamp(
        table.lens[u.long()].long(), min=1)


def sbpr_batch(gen, rows, valid, pos_u, pos_i, seen: MemberTable, item_nums,
               neg_ratio, spu: MemberTable, spu_csr: dict,
               social_neg: MemberTable | None = None):
    """(u, i, social item k, negative j, suk, w) rows
    (utils/sampler.py:102-141).  The pairs must be those of users with
    SPu; ``spu_csr`` holds ``build_csr_lists``'s ``flat``, ``off`` and
    ``suk`` as tensors, and ``spu`` the lists' lengths (``lens``).  The
    negative avoids seen(u) and SPu(u): exactly through their union's
    table ``social_neg`` when given (``seen`` is then unused), else by
    rejection against ``seen`` and ``spu``, which then need their rows
    or bitmaps."""
    u, i = _pair_rows(rows, pos_u, pos_i, neg_ratio)
    idx = _pick(gen, spu, spu_csr, u)
    if social_neg is not None:
        j = sample_not_in(gen, social_neg, u, item_nums, u.shape)
    else:
        j = _reject(gen, item_nums, u.shape,
                    lambda q: member(seen, u, q) | member(spu, u, q))
    return {"u": u, "i": i, "k": spu_csr["flat"][idx], "j": j,
            "suk": spu_csr["suk"][idx].to(torch.float32), "w": valid}


def tbpr_batch(gen, rows, valid, pos_u, pos_i, seen: MemberTable, item_nums,
               neg_ratio, strong: MemberTable, weak: MemberTable,
               ts_csr: dict, tw_csr: dict,
               social_neg: MemberTable | None = None):
    """(u, i, strong-tie item s, weak-tie item t, negative j, w) rows for
    TBPR's chain i > s > t > j, over users with both tie classes (the
    lists CSR-flat in ``ts_csr`` and ``tw_csr``, their lengths in
    ``strong`` and ``weak``); j avoids seen(u), strong(u) and weak(u),
    exactly through their union's table ``social_neg`` when given, else
    by rejection."""
    u, i = _pair_rows(rows, pos_u, pos_i, neg_ratio)
    s = ts_csr["flat"][_pick(gen, strong, ts_csr, u)]
    t = tw_csr["flat"][_pick(gen, weak, tw_csr, u)]
    if social_neg is not None:
        j = sample_not_in(gen, social_neg, u, item_nums, u.shape)
    else:
        j = _reject(gen, item_nums, u.shape,
                    lambda q: (member(seen, u, q) | member(strong, u, q)
                               | member(weak, u, q)))
    return {"u": u, "i": i, "s": s, "t": t, "j": j, "w": valid}


def samn_batch(gen, rows, valid, pos_u, pos_i, seen: MemberTable, item_nums,
               neg_ratio, friends_padded):
    """Pairwise rows and each row's padded friend list
    (utils/sampler.py:144-166)."""
    b = pairwise_batch(gen, rows, valid, pos_u, pos_i, seen, item_nums,
                       neg_ratio)
    b["friends"] = friends_padded[b["u"].long()]
    return b


def social_pairwise_batch(gen, rows, valid, sf_u, sf_v, friends: MemberTable,
                          user_nums, neg_ratio):
    """Social-domain (u_s, v, w_neg, w_s) rows of the dual-domain models
    (cleverrec_tpu/sampling.py:809-819): friend pair p repeated
    neg_ratio times, its negative user drawn outside u's friends
    (``friends``, a table over ``user_nums`` ids), the row weight w_s."""
    u, v = _pair_rows(rows, sf_u, sf_v, neg_ratio)
    w = sample_not_in(gen, friends, u, user_nums, u.shape)
    return {"u_s": u, "v": v, "w_neg": w, "w_s": valid}
