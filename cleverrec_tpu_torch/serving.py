"""Serving: top-K retrieval and re-ranking (as ``cleverrec_tpu/serving.py``).

- ``build_retrieval_fn``: ``retrieve(user_ids) -> (items, scores)`` over
  the model's frozen tables with seen-item filtering on the device — the
  online-serving hot path.  Backends mirror the Evaluator's rankers:
  ``dense`` [B, I] scoring in plain PyTorch, ``fused`` (the
  masked-scoring CUDA kernels, for dot-decomposable models), and
  ``stream`` (item chunks with a carried running top-k, memory
  O(B * chunk), for large catalogs).
- ``build_rerank_fn``: ``rerank(user_ids, candidate_ids) -> (items,
  scores)`` over an externally retrieved candidate set.

Export (``torch.export`` in place of ``jax.export``) and the sharded
backend come with later slices.
"""

from __future__ import annotations

import torch

from cleverrec_tpu_torch import ranking
from cleverrec_tpu_torch.common import resolve_device
from cleverrec_tpu_torch.ops.topk import topk
from cleverrec_tpu_torch.sampling import rows_to_bits


# ``auto`` serves through the fused backend up to this many items and
# through dense past it, up to ``STREAM_THRESHOLD``.  Fused retrieval
# beats dense on the narrow branch (dot_scores, catalogs up to 4,096
# items) and loses to it on every wide catalog measured, where dot_gmax's
# group maxes are followed by a rescue and a launch-bound extraction
# (tools/serve_crossover.py on NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md
# section 5).
FUSED_MAX_ITEMS = 4096
# ``auto`` streams past this many items on any device, the JAX package's
# rule (cleverrec_tpu/serving.py:36, :51-52): the dense path holds a
# [B, I] score matrix per call.
STREAM_THRESHOLD = 131072


def _pick_backend(model, device: torch.device) -> str:
    if (device.type == "cuda" and hasattr(model, "dot_decomposition")
            and model.meta.item_nums <= FUSED_MAX_ITEMS):
        return "fused"
    if model.meta.item_nums > STREAM_THRESHOLD:
        return "stream"
    return "dense"


def _pad_ids(v, items):
    return torch.where(torch.isfinite(v), items, torch.full_like(items, -1)), v


def build_retrieval_fn(model, aux, device_data, k: int = 10,
                       filter_seen: bool = True, backend: str = "auto",
                       device="cuda", stream_chunk: int | None = None,
                       approx: bool = False):
    """User -> top-k retrieval on ``device`` (default ``cuda``; the model
    is moved there).

    Returns retrieve(user_ids [B]) -> (items [B, k] int64, scores [B, k]).
    Filtered-out / past-catalog slots come back as item id -1 with -inf
    score.  ``backend``: auto | dense | fused | stream; auto picks fused
    on a CUDA device for dot-decomposable models up to
    ``FUSED_MAX_ITEMS`` items, stream past ``STREAM_THRESHOLD`` items,
    and dense between and on the CPU.  ``retrieve.backend`` names the
    backend in use.  ``stream_chunk``: items per chunk of the stream
    backend (default 16384 past 262,144 items, else 4096).  ``approx``:
    on the stream backend, select each chunk as the JAX package's
    ``approx_max_k`` does off the TPU, exactly
    (``ops/topk.streaming_topk``); on the fused backend, rescue the
    selected groups from a bfloat16 copy of the item table
    (``ranking.fused_precompute(rescue_bf16=True)``): past the narrow
    branch (4,096 items) scores round to bf16 operands and ids may
    differ from the exact answer's; up to it the answer is exact.  A distance model's fused scores
    leave out each user's |u|^2, so they differ from the dense scores by
    that per-user offset; the rankings agree.  The stream backend scores
    a dot-decomposable model by its decomposition too (GMF without its
    sigmoid), so compare its scores with dense ones only for plain dot
    models.
    """
    dev = resolve_device(device)
    model.to(dev)
    aux = {key: torch.as_tensor(v, device=dev)
           for key, v in (aux or {}).items()}
    item_nums = model.meta.item_nums
    if stream_chunk is None:
        stream_chunk = 16384 if item_nums > 262_144 else 4096
    if backend == "auto":
        backend = _pick_backend(model, dev)
    if backend not in ("dense", "fused", "stream"):
        raise ValueError(f"unknown retrieval backend {backend!r}")
    if backend == "fused" and not hasattr(model, "dot_decomposition"):
        raise ValueError(f"{model.name}: no dot decomposition — "
                         "fused retrieval unavailable")
    seen = device_data.seen
    # The fused path, and the stream with 32 | stream_chunk, mask with
    # bitmaps: gathered from the global table, or past its budget (bits
    # None) built from each batch's sorted rows.  Otherwise the rows.
    bitmaps = filter_seen and (backend == "fused" or (
        backend == "stream" and stream_chunk % 32 == 0))
    use_bits = bitmaps and seen.bits is not None
    seen_tbl = None
    if use_bits:
        seen_tbl = torch.as_tensor(seen.bits, device=dev)
    elif filter_seen:
        seen_tbl = torch.as_tensor(seen.rows, device=dev).long()
    pre = (ranking.fused_precompute(model, aux, rescue_bf16=approx)
           if backend == "fused" else None)

    def bits_of(u):
        return seen_tbl[u] if use_bits else rows_to_bits(seen_tbl[u],
                                                         item_nums)

    @torch.no_grad()
    def retrieve(u):
        u = torch.as_tensor(u, device=dev).long()
        if backend == "dense":
            rows = seen_tbl[u] if filter_seen else None
            return _pad_ids(*ranking.rank_dense(model, aux, u, rows, k,
                                                filter_seen))
        if backend == "stream":
            rows = seen_tbl[u] if filter_seen and not bitmaps else None
            return _pad_ids(*ranking.rank_stream(
                model, aux, u, rows, item_nums, k, chunk=stream_chunk,
                filter_seen=filter_seen,
                seen_bits=bits_of(u) if bitmaps else None, approx=approx))
        if filter_seen:
            bits = bits_of(u)
        else:
            bits = torch.zeros((u.shape[0], (item_nums + 31) // 32),
                               dtype=torch.int32, device=dev)
        return _pad_ids(*ranking.rank_fused(model, aux, u, bits, k, pre=pre))

    retrieve.backend = backend
    return retrieve


def build_rerank_fn(model, aux, k: int = 10, device="cuda"):
    """Second-stage scorer on ``device``: rerank(user_ids [B], cand [B, C])
    -> (items [B, k], scores [B, k]), the top-k of each user's provided
    candidate list (no seen filtering — the retriever already did it).
    Negative candidate ids are treated as padding and never surface."""
    dev = resolve_device(device)
    model.to(dev)
    aux = {key: torch.as_tensor(v, device=dev)
           for key, v in (aux or {}).items()}

    @torch.no_grad()
    def rerank(u, cand):
        u = torch.as_tensor(u, device=dev).long()
        cand = torch.as_tensor(cand, device=dev).long()
        valid = cand >= 0
        scores = model.score_candidates(u, cand.clamp(min=0), aux)
        if model.cml_like:
            scores = -scores
        scores = scores.masked_fill(~valid, -torch.inf)
        v, idx = topk(scores, min(k, cand.shape[1]))
        return _pad_ids(v, torch.gather(cand, 1, idx))

    return rerank
