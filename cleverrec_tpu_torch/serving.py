"""Serving: top-K retrieval and re-ranking, and their export (as
``cleverrec_tpu/serving.py``).

- ``build_retrieval_fn``: ``retrieve(user_ids) -> (items, scores)`` over
  the model's frozen tables with seen-item filtering on the device — the
  online-serving hot path.  Backends mirror the Evaluator's rankers:
  ``dense`` [B, I] scoring in plain PyTorch, ``fused`` (the
  masked-scoring CUDA kernels, for dot-decomposable models), and
  ``stream`` (item chunks with a carried running top-k, memory
  O(B * chunk), for large catalogs), and ``sharded`` (under a mesh: each
  model rank's slice of the item axis, the ranks' top-k merged over the
  mesh's ``model`` axis, ``ranking.rank_sharded``).
- ``build_rerank_fn``: ``rerank(user_ids, candidate_ids) -> (items,
  scores)`` over an externally retrieved candidate set.
- ``export_retrieval`` / ``export_rerank`` / ``load_serialized`` /
  ``export_bundle``: ``torch.export`` programs (in place of
  ``jax.export``'s StableHLO) that a serving process loads and runs
  without the model's Python code.  Each exports the module that the
  live function calls, at a static batch; the model's tables, the fused
  path's precomputed table and the seen table are its parameters and
  buffers.  A ``fused`` program keeps the scoring kernels as the custom
  ops ``cleverrec::dot_scores`` / ``cleverrec::dot_gmax`` (``ops/scores.py``),
  so it loads only where the port is importable, and a program exported
  on the card runs only there.  The exports take no mesh, as the JAX
  package's: ``auto`` resolves as without one, and ``sharded`` raises.
"""

from __future__ import annotations

import io
import itertools
import json
import os

import torch

from cleverrec_tpu_torch import ranking
from cleverrec_tpu_torch.common import resolve_device
from cleverrec_tpu_torch.ops.topk import topk
from cleverrec_tpu_torch.parallel.sharding import shards_of
from cleverrec_tpu_torch.sampling import rows_to_bits
from cleverrec_tpu_torch.utils import trace


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


def _pick_backend(model, device: torch.device, mesh=None) -> str:
    if mesh is not None:
        # The Evaluator's mesh routing (cleverrec_tpu/serving.py:40-44).
        return "sharded"
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
                       approx: bool = False, mesh=None):
    """User -> top-k retrieval on ``device`` (default ``cuda``; the model
    is moved there).

    Returns retrieve(user_ids [B]) -> (items [B, k] int64, scores [B, k]).
    Filtered-out / past-catalog slots come back as item id -1 with -inf
    score.  ``backend``: auto | dense | fused | stream | sharded; auto
    picks sharded under a ``mesh`` (``sharded`` without one raises), fused
    on a CUDA device for dot-decomposable models up to
    ``FUSED_MAX_ITEMS`` items, stream past ``STREAM_THRESHOLD`` items,
    and dense between and on the CPU; a model whose tables are
    row-sharded over the mesh's ``model`` axis (``model.row_shards``)
    serves through ``sharded`` alone, which ranks from the row blocks as
    the Evaluator does (``ranking.rank_sharded``).  ``retrieve.backend``
    names the
    backend in use, ``retrieve.module`` the module it calls (what
    ``export_retrieval`` exports).  ``stream_chunk``: items per chunk of
    the stream backend (default 16384 past 262,144 items, else 4096).
    ``approx``: on the stream backend, select each chunk as the JAX
    package's ``approx_max_k`` does off the TPU, exactly
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
    aux = _on(dev, aux)
    item_nums = model.meta.item_nums
    if stream_chunk is None:
        stream_chunk = 16384 if item_nums > 262_144 else 4096
    if backend == "auto":
        backend = _pick_backend(model, dev, mesh)
    if backend not in ("dense", "fused", "stream", "sharded"):
        raise ValueError(f"unknown retrieval backend {backend!r}")
    if backend == "sharded" and mesh is None:
        raise ValueError("backend='sharded' needs a mesh")
    if shards_of(model) and backend != "sharded":
        raise ValueError(
            f"{model.name} holds row-sharded tables: serve it through the "
            "'sharded' backend on its mesh, or gather it first "
            "(parallel.sharding.unshard_model(model, mesh))")
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
    module = _Retrieval(model, aux, seen_tbl, pre, backend, k, filter_seen,
                        bitmaps, use_bits, stream_chunk, approx, mesh)

    @torch.no_grad()
    def retrieve(u):
        with trace.span("serve.call"):
            return module(torch.as_tensor(u, device=dev).long())

    retrieve.backend = backend
    retrieve.module = module
    return retrieve


class _Retrieval(torch.nn.Module):
    """The body of ``build_retrieval_fn``'s ``retrieve``: forward(user ids
    [B] int64) -> (items [B, k], scores [B, k]).  The model is a
    submodule; its aux, the seen table (``seen``: bitmaps or sorted rows,
    None unfiltered) and ``fused_precompute``'s output (``pre_table``,
    ``pre_bias``, ``pre_rescue``) are buffers; ``mesh`` the sharded
    backend's."""

    def __init__(self, model, aux, seen_tbl, pre, backend, k, filter_seen,
                 bitmaps, use_bits, stream_chunk, approx, mesh=None):
        super().__init__()
        self.model = model
        _register(self, aux)
        self.register_buffer("seen", seen_tbl)
        table, bias, rescue = pre if pre is not None else (None,) * 3
        self.register_buffer("pre_table", table)
        self.register_buffer("pre_bias", bias)
        self.register_buffer("pre_rescue", rescue)
        self.backend, self.k, self.filter_seen = backend, k, filter_seen
        self.bitmaps, self.use_bits = bitmaps, use_bits
        self.stream_chunk, self.approx = stream_chunk, approx
        self.mesh = mesh

    def bits_of(self, u):
        if self.use_bits:
            return self.seen[u]
        return rows_to_bits(self.seen[u], self.model.meta.item_nums)

    def forward(self, u):
        model, k, aux = self.model, self.k, _aux(self)
        item_nums = model.meta.item_nums
        if self.backend in ("dense", "sharded"):
            rows = self.seen[u] if self.filter_seen else None
            if self.backend == "sharded":
                return _pad_ids(*ranking.rank_sharded(
                    model, aux, u, rows, k, self.mesh, self.filter_seen))
            return _pad_ids(*ranking.rank_dense(model, aux, u, rows, k,
                                                self.filter_seen))
        if self.backend == "stream":
            rows = (self.seen[u] if self.filter_seen and not self.bitmaps
                    else None)
            return _pad_ids(*ranking.rank_stream(
                model, aux, u, rows, item_nums, k, chunk=self.stream_chunk,
                filter_seen=self.filter_seen,
                seen_bits=self.bits_of(u) if self.bitmaps else None,
                approx=self.approx))
        if self.filter_seen:
            bits = self.bits_of(u)
        else:
            bits = torch.zeros((u.shape[0], (item_nums + 31) // 32),
                               dtype=torch.int32, device=u.device)
        pre = (self.pre_table, self.pre_bias, self.pre_rescue)
        return _pad_ids(*ranking.rank_fused(model, aux, u, bits, k, pre=pre))


def build_rerank_fn(model, aux, k: int = 10, device="cuda"):
    """Second-stage scorer on ``device``: rerank(user_ids [B], cand [B, C])
    -> (items [B, k], scores [B, k]), the top-k of each user's provided
    candidate list (no seen filtering — the retriever already did it).
    Negative candidate ids are treated as padding and never surface."""
    dev = resolve_device(device)
    if shards_of(model):
        raise ValueError(f"{model.name} holds row-sharded tables: gather it "
                         "first (parallel.sharding.unshard_model(model, "
                         "mesh))")
    model.to(dev)
    module = _Rerank(model, _on(dev, aux), k)

    @torch.no_grad()
    def rerank(u, cand):
        return module(torch.as_tensor(u, device=dev).long(),
                      torch.as_tensor(cand, device=dev).long())

    rerank.module = module
    return rerank


class _Rerank(torch.nn.Module):
    """The body of ``build_rerank_fn``'s ``rerank``: forward(user ids [B],
    candidates [B, C], both int64) -> (items [B, k], scores [B, k]); the
    model a submodule, its aux buffers."""

    def __init__(self, model, aux, k):
        super().__init__()
        self.model, self.k = model, k
        _register(self, aux)

    def forward(self, u, cand):
        valid = cand >= 0
        scores = self.model.score_candidates(u, cand.clamp(min=0), _aux(self))
        if self.model.cml_like:
            scores = -scores
        scores = scores.masked_fill(~valid, -torch.inf)
        v, idx = topk(scores, min(self.k, cand.shape[1]))
        return _pad_ids(v, torch.gather(cand, 1, idx))


def _on(dev, aux):
    return {key: torch.as_tensor(v, device=dev)
            for key, v in (aux or {}).items()}


def _register(module, aux):
    """The model's aux tensors as buffers ``aux_<name>`` of ``module``."""
    module.aux_names = tuple(aux)
    for name, value in aux.items():
        module.register_buffer(f"aux_{name}", value)


def _aux(module):
    return {name: getattr(module, f"aux_{name}") for name in module.aux_names}


def _program_bytes(module, args) -> bytes:
    """``torch.export.save``'s bytes of ``module`` traced at ``args``."""
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_retrieval(model, aux, device_data, batch: int, k: int = 10,
                     filter_seen: bool = True, backend: str = "auto",
                     device="cuda") -> bytes:
    """The retrieval function of ``build_retrieval_fn`` on ``device`` as a
    ``torch.export`` program for [batch] int64 user ids, serialized.

    A ``fused`` program calls the port's scoring ops: exported on the
    card it runs their CUDA kernels and only there; ``dense`` and
    ``stream`` programs are plain PyTorch, on the device they were
    exported on."""
    fn = build_retrieval_fn(model, aux, device_data, k, filter_seen,
                            backend=backend, device=device)
    u = torch.zeros(batch, dtype=torch.long, device=resolve_device(device))
    return _program_bytes(fn.module, (u,))


def export_rerank(model, aux, batch: int, n_cand: int, k: int = 10,
                  device="cuda") -> bytes:
    """The rerank function for [batch] user ids and [batch, n_cand]
    candidates (int64), serialized as ``export_retrieval``'s."""
    fn = build_rerank_fn(model, aux, k, device=device)
    dev = resolve_device(device)
    u = torch.zeros(batch, dtype=torch.long, device=dev)
    cand = torch.zeros((batch, n_cand), dtype=torch.long, device=dev)
    return _program_bytes(fn.module, (u, cand))


def load_serialized(blob: bytes):
    """Deserialize an exported serving artifact; returns a callable that
    takes its inputs (tensors, arrays or lists of ids) and returns its
    (items, scores)."""
    # A fused program names the cleverrec:: ops: register them first.
    from cleverrec_tpu_torch.ops import scores  # noqa: F401
    program = torch.export.load(io.BytesIO(blob))
    module = program.module()
    dev = next((t.device for t in itertools.chain(
        program.state_dict.values(), program.constants.values())
        if isinstance(t, torch.Tensor)), torch.device("cpu"))

    @torch.no_grad()
    def call(*args):
        return module(*(torch.as_tensor(a, device=dev).long() for a in args))

    return call


# The JAX package's other name for it.
load_retrieval = load_serialized


def export_bundle(model, aux, device_data, out_dir: str, batch: int = 256,
                  n_cand: int = 128, k: int = 10, filter_seen: bool = True,
                  backend: str = "auto", device="cuda") -> dict:
    """Write a serving bundle: ``retrieval.pt2``, ``rerank.pt2`` and
    ``meta.json``, the manifest, which it returns.  ``auto`` resolves as
    ``build_retrieval_fn``'s does on ``device``; ``cuda_only`` is true for
    a ``fused`` program exported on a CUDA device (it launches the port's
    kernels)."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    resolved = backend if backend != "auto" else _pick_backend(model, dev)
    paths = {"retrieval": "retrieval.pt2", "rerank": "rerank.pt2"}
    with open(os.path.join(out_dir, paths["retrieval"]), "wb") as f:
        f.write(export_retrieval(model, aux, device_data, batch, k,
                                 filter_seen, backend=resolved, device=dev))
    with open(os.path.join(out_dir, paths["rerank"]), "wb") as f:
        f.write(export_rerank(model, aux, batch, n_cand, k, device=dev))
    manifest = {
        "model": model.name, "k": k, "batch": batch, "n_cand": n_cand,
        "backend": resolved, "filter_seen": filter_seen,
        "user_nums": int(model.meta.user_nums),
        "item_nums": int(model.meta.item_nums),
        "cuda_only": resolved == "fused" and dev.type == "cuda",
        "artifacts": paths,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest
