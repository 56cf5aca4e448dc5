"""Shared full-catalog ranking backends (as ``cleverrec_tpu/ranking.py``).

One implementation of each ranker, used by both the Evaluator (evalx.py)
and the serving module (serving.py).  Every ranker returns
``(values [B, k], items [B, k])`` with masked slots at exactly ``-inf``
(the kernels' finite -3e38 sentinel is normalized here).  Scores are
"higher is better": a ``cml_like`` distance model's scores are negated
inside each ranker, before masking (the fused path negates inside the
dot, so the -3e38 seen mask stays the worst score).  Selection breaks
ties by the lowest item id, as ``lax.top_k``.

The dense, sharded and streaming rankers are plain PyTorch (plain XLA in
the JAX package); the sharded one gathers over a mesh's ``model`` axis
(``parallel/mesh.py``); the fused ranker runs the CUDA kernels of ops/scores.py on a
CUDA device and their plain versions on the CPU.
"""

from __future__ import annotations

import torch

from cleverrec_tpu_torch.common import cdiv
from cleverrec_tpu_torch.ops.scores import (COMB_I, NEG, dot_gmax,
                                            dot_scores)
from cleverrec_tpu_torch.ops.topk import (grouped_topk, sharded_topk_scores,
                                          streaming_topk, topk)
from cleverrec_tpu_torch.parallel.sharding import (ExchangeTable,
                                                   pad_table_for_sharding,
                                                   shards_of, table_views)
from cleverrec_tpu_torch.utils import trace

# The JAX package's fused path pads the catalog to 4096-item tiles and
# takes the group-max branch from two tiles up; the port keeps the same
# rule so both packages take the same branch for one catalog.
BLOCK_I = 4096


def _normalize(v):
    return torch.where(v > -1e37, v, torch.full_like(v, -torch.inf))


def masked_full_scores(model, aux, u, rows, filter_seen: bool = True):
    """[B, I] scores with seen train items masked to -inf.

    ``rows``: the batch users' sorted seen rows [B, L], padded with the
    sentinel id ``I``, which lands in a spill column that is cut off.
    The scoring in the span ``rank.score``, the masking in ``rank.mask``."""
    with trace.span("rank.score"):
        scores = model.score_all(u, aux)
        if model.cml_like:
            scores = -scores
    if not filter_seen:
        return scores
    with trace.span("rank.mask"):
        b, item_nums = scores.shape
        seen = torch.zeros((b, item_nums + 1), dtype=torch.bool,
                           device=scores.device)
        seen.scatter_(1, rows.long(), True)
        return scores.masked_fill(seen[:, :item_nums], -torch.inf)


@torch.no_grad()
def rank_dense(model, aux, u, rows, k: int, filter_seen: bool = True):
    """Dense [B, I] scoring + top-k (group-max pruned past 16k items);
    the top-k in the span ``rank.select``."""
    scores = masked_full_scores(model, aux, u, rows, filter_seen)
    with trace.span("rank.select"):
        return grouped_topk(scores, k)


@torch.no_grad()
def rank_sharded(model, aux, u, rows, k: int, mesh,
                 filter_seen: bool = True):
    """Item-axis-sharded ranking (cleverrec_tpu/ranking.py:52-66): the
    masked scores' item axis padded with -inf to a multiple of the mesh's
    model size M, each model rank's top-k of its slice, and the k * M
    candidates gathered and merged (``ops.topk.sharded_topk_scores``);
    every rank gets the whole answer, equal to ``rank_dense``'s.  With
    replicated tables a rank computes the row of scores and keeps its
    slice; a model whose tables are row-sharded over ``model``
    (``model.row_shards``) is read through the exchange's views
    (``sharding.table_views``, ``serve``): a dot-decomposable one scores
    its slice alone (``_slice_scores``), any other the row from the
    views' all-gathered tables."""
    if shards_of(model):
        with table_views(model, mesh, "serve"):
            return _rank_row_sharded(model, aux, u, rows, k, mesh,
                                     filter_seen)
    scores = masked_full_scores(model, aux, u, rows, filter_seen)
    n = mesh.shape["model"]
    scores = pad_table_for_sharding(scores, n, dim=1, value=-torch.inf)
    width = scores.shape[1] // n
    lo = mesh.index("model") * width
    return sharded_topk_scores(scores[:, lo:lo + width], k, mesh)


def _rank_row_sharded(model, aux, u, rows, k, mesh, filter_seen):
    """``rank_sharded`` inside the views: this rank's item slice of the
    masked scores (``_slice_scores``, or the row of ``score_all`` cut),
    its top-k merged over ``model``."""
    n, m = mesh.shape["model"], mesh.index("model")
    item_nums = model.meta.item_nums
    width = cdiv(item_nums, n)
    lo = m * width
    if hasattr(model, "dot_decomposition"):
        scores = _slice_scores(model, aux, u, n, lo, width)
    else:
        scores = model.score_all(u, aux)
        if model.cml_like:
            scores = -scores
        scores = pad_table_for_sharding(scores, n, dim=1,
                                        value=-torch.inf)[:, lo:lo + width]
    ids = torch.arange(lo, lo + width, device=scores.device)
    scores = scores.masked_fill((ids >= item_nums)[None, :], -torch.inf)
    if filter_seen:
        seen = torch.zeros((u.shape[0], n * width + 1), dtype=torch.bool,
                           device=scores.device)
        seen.scatter_(1, rows.long(), True)
        scores = scores.masked_fill(seen[:, lo:lo + width], -torch.inf)
    return sharded_topk_scores(scores, k, mesh)


def _slice_scores(model, aux, u, n, lo, width):
    """[B, width] scores of items [lo, lo + width) from the model's
    ``dot_decomposition``: the user vectors (their rows through the
    exchange), this rank's rows of the item table (an ``ExchangeTable``'s
    own block, else a slice of the padded table) and of the item bias.  A
    distance model's scores leave out the per-user |u|^2 and GMF's its
    sigmoid, as the fused ranker's do: the rankings agree."""
    uv, table, bias = model.dot_decomposition(u, aux)
    if isinstance(table, ExchangeTable):
        block = table.local()
    else:
        block = pad_table_for_sharding(table, n)[lo:lo + width]
    scores = uv @ block.T
    if bias is not None:
        scores = scores + pad_table_for_sharding(bias, n)[lo:lo + width]
    return -scores if model.cml_like else scores


def _seen_in_rows(rows, ids):
    """[B, n] bool: is ids[b, j] in the sorted row rows[b]?"""
    idx = torch.searchsorted(rows, ids).clamp(max=rows.shape[1] - 1)
    return torch.gather(rows, 1, idx) == ids


@torch.no_grad()
def rank_stream(model, aux, u, rows, item_nums: int, k: int,
                chunk: int = 4096, filter_seen: bool = True,
                seen_bits=None, approx: bool = False):
    """Streaming ranking: ``streaming_topk`` over item chunks with a
    carried running top-k, memory O(B * chunk) instead of the dense
    [B, I] score matrix.

    A dot-decomposable model scores a chunk as one [B, d] x [d, chunk]
    product against the chunk's table rows (plus the item bias); any
    other model through ``score_candidates`` on the chunk's ids.

    Seen masking, as the JAX package's:

    - ``seen_bits`` ([B, ceil(I/32)] int32 packed bitmaps) given: each
      chunk tests its own slice of the words (needs 32 | ``chunk``);
    - else, rows ([B, L] sorted, padded with the sentinel ``I``) no wider
      than 4096: the stream runs unfiltered to a top-(k + L) and
      post-filters that short list against the rows (a user's seen items
      displace at most L slots, so this is exact);
    - else each chunk is masked by a binary search of its ids in the
      rows."""
    cml = model.cml_like
    decomp = getattr(model, "dot_decomposition", None)
    if decomp is not None:
        uv, table, bias = decomp(u, aux)
        if cml:
            uv = -uv
            bias = None if bias is None else -bias
    b = u.shape[0]
    if seen_bits is not None:
        if chunk % 32:
            raise ValueError(f"bitmap masking needs 32 | chunk, not {chunk}")
        # Whole chunks of words, so every chunk's slice is a full one.
        words = chunk // 32
        n_chunks = cdiv(item_nums, chunk)
        sb = torch.nn.functional.pad(
            seen_bits.to(torch.int32), (0, n_chunks * words
                                        - seen_bits.shape[1]))
        sb = sb.view(b, n_chunks, words)
        lane = torch.arange(chunk, device=u.device)
        word_of, shift = lane >> 5, (lane & 31).to(torch.int32)
    # The post-filter widens the carry by the widest row; past 4096 a
    # per-chunk binary search is immune to one user's huge history.
    post_filter = (filter_seen and seen_bits is None
                   and rows.shape[1] <= 4096)
    chunk_mask_rows = filter_seen and seen_bits is None and not post_filter
    if filter_seen and seen_bits is None:
        rows = rows.long().contiguous()

    def score_chunk(ids):
        if decomp is not None:
            s = uv @ table[ids].T
            if bias is not None:
                s = s + bias[ids]
        else:
            s = model.score_candidates(u, ids.expand(b, -1), aux)
            if cml:
                s = -s
        if filter_seen and seen_bits is not None:
            # The chunk's words, selected by a device index (no sync).
            w = sb.index_select(1, ids[:1] // chunk)[:, 0][:, word_of]
            s = s.masked_fill(((w >> shift) & 1).bool(), -torch.inf)
        elif chunk_mask_rows:
            s = s.masked_fill(
                _seen_in_rows(rows, ids.expand(b, -1).contiguous()),
                -torch.inf)
        return s

    if post_filter:
        # streaming_topk always yields kk columns (-inf padded).
        kk = max(k, min(k + rows.shape[1], item_nums))
        v, ids = streaming_topk(score_chunk, item_nums, kk, chunk=chunk,
                                approx=approx, device=u.device)
        v = v.masked_fill(_seen_in_rows(rows, ids), -torch.inf)
        v, sel = topk(v, k)
        return v, torch.gather(ids, 1, sel)
    return streaming_topk(score_chunk, item_nums, k, chunk=chunk,
                          approx=approx, device=u.device)


def fused_precompute(model, aux, rescue_bf16: bool = False):
    """Batch-independent half of the fused path: (the item table, the item
    bias (negated for a ``cml_like`` model), the rescue's copy of the
    table), the first two contiguous float32.  Callers ranking many
    batches against one set of parameters compute it once and pass it to
    ``rank_fused`` as ``pre``.  The port scores in original item order, so
    unlike the JAX package nothing is permuted.

    The rescue copy is None (the rescue reads the table) unless
    ``rescue_bf16``: then it is a bfloat16 copy, and the wide branch's
    rescue scores bf16-rounded rows against a bf16-rounded user, the
    products summed in float32 and the bias added in float32.  That is an
    approximate mode for serving (``approx`` on the ``fused`` backend),
    never used by evaluation; the narrow branch stays exact."""
    dev = next(model.parameters()).device
    _, table, bias = model.dot_decomposition(
        torch.zeros(1, dtype=torch.long, device=dev), aux)
    if model.cml_like and bias is not None:
        bias = -bias
    table = table.detach().float().contiguous()
    bias = None if bias is None else bias.detach().float().contiguous()
    return table, bias, table.bfloat16() if rescue_bf16 else None


@torch.no_grad()
def rank_fused(model, aux, u, seen_bits, k: int, pre=None):
    """Kernel path for dot-decomposable models.

    ``seen_bits``: [B, ceil(I/32)] int32 packed seen bitmaps (zeros for
    unfiltered retrieval).  ``pre``: output of ``fused_precompute``.

    Narrow catalogs: ``dot_scores`` writes the masked [B, I] scores and
    one row top-k ranks them.  Wide catalogs: ``dot_gmax`` writes only
    the max of each 32-item group, the top k groups are selected, their
    [B, k, 32, d] table slabs are rescued and rescored, re-masked with
    one bitmap word per group, and k rounds of max extraction pick the
    result.  Any group holding a top-k item has a max >= the k-th score,
    and at most k groups can, so the rescue is exact up to f32 rounding
    between the kernel's dot and the rescue's.

    Spans: the decomposition ``rank.decompose``; the kernel and the group
    top-k ``rank.score``; the narrow branch's row top-k ``rank.select``;
    the wide branch's rescue ``rank.rescue`` and extraction
    ``rank.extract``."""
    with trace.span("rank.decompose"):
        u_vecs, table, bias = model.dot_decomposition(u, aux)
    if model.cml_like:
        # Negate INSIDE the dot, (-u).q - bias, so the kernels' -3e38 seen
        # mask stays the worst score; never negate after masking.
        u_vecs = -u_vecs
        bias = None if bias is None else -bias
    rescue = None
    if pre is not None:
        # fused_precompute negated its bias already.
        table, bias, rescue = pre
    u_vecs = u_vecs.float().contiguous()
    table = table.float().contiguous()
    seen_bits = seen_bits.to(torch.int32).contiguous()
    i_real = table.shape[0]
    n = i_real + ((-i_real) % BLOCK_I)           # the JAX padded width
    b = u_vecs.shape[0]
    if not (n >= 2 * BLOCK_I and n // COMB_I >= 2 * k):
        with trace.span("rank.score"):
            scores = dot_scores(u_vecs, table, seen_bits, bias)
            if i_real < k:  # the JAX path ranks padded (masked) columns
                scores = torch.nn.functional.pad(scores, (0, k - i_real),
                                                 value=NEG)
        with trace.span("rank.select"):
            v, idx = topk(scores, k)
            return _normalize(v), idx

    with trace.span("rank.score"):
        gmax = dot_gmax(u_vecs, table, seen_bits, bias)      # [B, G]
        # Ascending group order: the extraction's first-position tie rule
        # then picks the lowest item id.
        gi = topk(gmax, k)[1].sort(dim=1).values             # [B, k]
    with trace.span("rank.rescue"):
        # Group g is the contiguous rows [32g, 32g + 32) of the table;
        # rows past the catalog are clamped here and masked below.
        ids = gi[:, :, None] * COMB_I + torch.arange(COMB_I,
                                                     device=gi.device)
        slab_rows = ids.clamp(max=i_real - 1)
        if rescue is None:
            qc, u_r = table[slab_rows], u_vecs               # [B, k, 32, d]
        else:
            # bf16 operands, exact f32 products, f32 sums.
            qc, u_r = rescue[slab_rows].float(), u_vecs.bfloat16().float()
        cand = torch.einsum("bkcd,bd->bkc", qc, u_r)         # [B, k, 32]
        if bias is not None:
            cand = cand + bias[slab_rows]
        # Group g is bitmap word g: member r is bit r.
        words = torch.gather(seen_bits, 1, gi)               # [B, k]
        bit = torch.arange(COMB_I, dtype=torch.int32, device=words.device)
        seen = ((words[:, :, None] >> bit) & 1) == 1
        cand = torch.where(seen | (ids >= i_real),
                           torch.full_like(cand, NEG), cand)
    with trace.span("rank.extract"):
        # k rounds of max extraction; argmax returns the first maximal
        # lane.
        c = cand.reshape(b, k * COMB_I)
        ids_flat = ids.reshape(b, k * COMB_I)
        batch = torch.arange(b, device=c.device)
        vs, cis = [], []
        for _ in range(k):
            a = c.argmax(dim=1)
            vs.append(c[batch, a])
            cis.append(a)
            c[batch, a] = -torch.inf
        v = torch.stack(vs, dim=1)
        items = torch.gather(ids_flat, 1, torch.stack(cis, dim=1))
        return _normalize(v), items
