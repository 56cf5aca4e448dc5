"""Masked full-catalog dot scoring: the CUDA kernels and their plain
versions.

``dot_scores``, ``dot_gmax`` and ``dot_topk_scores`` replace the TPU
kernels ``fused_dot_scores``, ``fused_dot_gmax`` and
``fused_dot_topk_scores`` of ``cleverrec_tpu/ops/pallas_scores.py``.  All
score ``u . q + bias`` for a batch of users against the whole item table,
with each user's seen items (and items past the table) forced to the
finite ``NEG`` sentinel:

- ``dot_scores`` returns the masked ``[B, I]`` scores,
- ``dot_gmax`` returns only the max of each aligned 32-item group,
  ``[B, ceil(I/32)]``: group ``g`` is items ``[32g, 32g + 32)``, which is
  exactly bitmap word ``g``,
- ``dot_topk_scores`` returns the masked scores padded to whole
  4096-item tiles, the TPU kernel's per-tile comb maxes in its lane
  layout, and an (identity) ``item_map``.

Unlike the TPU kernels, columns are in ORIGINAL item order: no table
permutation; ``dot_topk_scores``' ``item_map`` is ``arange(I_pad)``.

Seen sets arrive as packed bitmaps ``[B, ceil(I/32)]`` int32 with the bit
pattern of the JAX package's uint32 ``MemberTable.bits``: item ``i`` is
bit ``i & 31`` of word ``i >> 5``.

A wrapper given CPU tensors runs the plain PyTorch version
(``dot_scores_ref`` / ``dot_gmax_ref``).  Given CUDA tensors it launches
the kernel in ``csrc/dot_scores.cu`` or raises; it never falls back.
``launches`` counts kernel launches per wrapper.  On the card the wrappers
of ``dot_scores`` and ``dot_gmax`` pick the block tile by grid fill
(``_scores_tile``), and every wrapper tells its kernel whether it may stage
u and q with 16-byte copies (``_aligned``); each C entry point is bound
once.

``dot_scores`` and ``dot_gmax`` go through the PyTorch custom ops
``cleverrec::dot_scores`` and ``cleverrec::dot_gmax`` (importing this
module registers them): their CPU implementation is the plain version,
their CUDA implementation the kernel, and a fake implementation gives
``torch.export`` the output's shape, so that an exported program keeps
each call as one node of its graph (``serving.export_retrieval``).  A
program that names them loads only where this module was imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cleverrec_tpu_torch.common import cdiv

NEG = -3.0e38   # mask value (finite: selection treats it like -inf)
COMB_I = 32     # items per dot_gmax group == items per bitmap word
BLOCK_I = 4096  # dot_topk_scores: items per tile, as the TPU kernel's
GROUP_LANES = 128   # dot_topk_scores: gmax lanes per tile (32 real)

launches = {"dot_scores": 0, "dot_gmax": 0, "dot_topk_scores": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def dot_scores_ref(u, q, bits, bias=None):
    """Plain version of ``dot_scores``: the [B, I] masked scores, the
    arithmetic both kernels share."""
    scores = u @ q.T
    if bias is not None:
        scores = scores + bias
    col = torch.arange(q.shape[0], device=q.device)
    word = bits[:, col >> 5]
    seen = ((word >> (col & 31).to(word.dtype)) & 1).bool()
    return torch.where(seen, torch.full_like(scores, NEG), scores)


def dot_gmax_ref(u, q, bits, bias=None):
    """Plain version of ``dot_gmax``."""
    scores = dot_scores_ref(u, q, bits, bias)
    b, i = scores.shape
    g = cdiv(i, COMB_I)
    pad = torch.full((b, g * COMB_I - i), NEG, dtype=scores.dtype,
                     device=scores.device)
    return torch.cat([scores, pad], dim=1).view(b, g, COMB_I).amax(dim=2)


def _padded(i: int) -> int:
    return cdiv(i, BLOCK_I) * BLOCK_I


def dot_topk_scores_ref(u, q, bits, bias=None):
    """Plain version of ``dot_topk_scores``."""
    b, i = u.shape[0], q.shape[0]
    i_pad = _padded(i)
    scores = torch.nn.functional.pad(dot_scores_ref(u, q, bits, bias),
                                     (0, i_pad - i), value=NEG)
    # Item 4096t + 32m + j sits at [t, m, j]: comb j of tile t is the max
    # over m.
    tiles = i_pad // BLOCK_I
    comb = scores.view(b, tiles, BLOCK_I // COMB_I, COMB_I).amax(dim=2)
    gmax = torch.nn.functional.pad(comb, (0, GROUP_LANES - COMB_I),
                                   value=NEG).reshape(b, tiles * GROUP_LANES)
    return scores, gmax, torch.arange(i_pad, device=u.device)


def _check(u, q, bits, bias):
    if u.dim() != 2 or q.dim() != 2 or u.shape[1] != q.shape[1]:
        raise ValueError(f"u {tuple(u.shape)} and q {tuple(q.shape)} must "
                         "be [B, d] and [I, d]")
    b, i = u.shape[0], q.shape[0]
    if bits.shape != (b, (i + 31) // 32):
        raise ValueError(f"bits {tuple(bits.shape)} must be "
                         f"[{b}, {cdiv(i, 32)}]")
    if bias is not None and bias.shape != (i,):
        raise ValueError(f"bias {tuple(bias.shape)} must be [{i}]")
    dev = u.device
    if q.device != dev or bits.device != dev or (
            bias is not None and bias.device != dev):
        raise ValueError("u, q, bits and bias must be on one device")
    f32 = torch.float32
    if u.dtype != f32 or q.dtype != f32 or bits.dtype != torch.int32 or (
            bias is not None and bias.dtype != f32):
        raise TypeError("u, q and bias must be float32 and bits int32")


# The block tiles of dot_scores and dot_gmax, users x items, largest
# first; the index is the C entry points' ``tile`` argument.
SCORE_TILES = ((128, 128), (64, 64), (32, 64))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index`` (132 on an
    H100 SXM): the one source of the SM count that the scoring kernels'
    tile choice and strip split, and the tower epoch's row tile, use."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _scores_tile(b: int, i: int, sms: int) -> int:
    """The index in ``SCORE_TILES`` of the tile of ``dot_scores`` and
    ``dot_gmax`` for ``b`` users and ``i`` items on a card of ``sms`` SMs:
    the largest whose grid holds at least ``sms`` blocks, so that every SM
    gets work, else the smallest."""
    for k, (bm, bn) in enumerate(SCORE_TILES):
        if cdiv(b, bm) * cdiv(i, bn) >= sms:
            return k
    return len(SCORE_TILES) - 1


def _aligned(u, q) -> bool:
    """May the kernels stage u and q with 16-byte copies: d % 4 == 0 and
    both bases 16-byte aligned?  A contiguous view such as ``table[1:]``
    need not be; the kernels then stage with 4-byte copies."""
    return (u.shape[1] % 4 == 0 and u.data_ptr() % 16 == 0
            and q.data_ptr() % 16 == 0)


_P, _I = ctypes.c_void_p, ctypes.c_int
# Each C entry point's arguments: u, q, bits, bias, the outputs, then
# B, I, d, W, the kernel's own ints, the stream.
_ARGTYPES = {"dot_scores": [_P] * 5 + [_I] * 7 + [_P],
             "dot_gmax": [_P] * 5 + [_I] * 7 + [_P],
             "dot_topk_scores": [_P] * 6 + [_I] * 5 + [_P]}
_fns: dict = {}


def _fn(name):
    """C entry point ``name``, bound (``restype``, ``argtypes``) once."""
    fn = _fns.get(name)
    if fn is None:
        from cleverrec_tpu_torch.ops.build import load
        fn = getattr(load("dot_scores"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _fns[name] = fn
    return fn


def _on_cpu(name, u, q, bits, bias) -> bool:
    """Check the inputs: True on CPU tensors (the plain version runs),
    False on CUDA tensors (the kernel runs); raises on any other device."""
    _check(u, q, bits, bias)
    if u.device.type == "cpu":
        return True
    if u.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {u.device}")
    return False


def _tiling(u, q) -> tuple:
    """The ``tile``, ``vec`` and ``sms`` arguments of the entry points of
    ``dot_scores`` and ``dot_gmax``."""
    sms = _sms(u.device.index)
    return _scores_tile(u.shape[0], q.shape[0], sms), int(_aligned(u, q)), sms


def _empty(u, width):
    return torch.empty((u.shape[0], width), dtype=torch.float32,
                       device=u.device)


def _launch(name, u, q, bits, bias, outs, ints=()):
    """Launch C entry point ``name`` on CUDA tensors: u, q, bits, bias,
    ``outs``, then B, I, d, W and ``ints``; raises on any refusal."""
    if not (u.is_contiguous() and q.is_contiguous() and bits.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError(f"{name}: inputs must be contiguous")
    if q.shape[0] == 0 or u.shape[0] == 0:
        return
    fn = _fn(name)
    index = u.device.index
    args = (u.data_ptr(), q.data_ptr(), bits.data_ptr(),
            None if bias is None else bias.data_ptr(),
            *(t.data_ptr() for t in outs), u.shape[0], q.shape[0],
            u.shape[1], bits.shape[1], *ints,
            torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    launches[name] += 1


def _dot_scores_cuda(u, q, bits, bias):
    out = _empty(u, q.shape[0])
    _launch("dot_scores", u, q, bits, bias, (out,), _tiling(u, q))
    return out


def _dot_gmax_cuda(u, q, bits, bias):
    out = _empty(u, cdiv(q.shape[0], COMB_I))
    _launch("dot_gmax", u, q, bits, bias, (out,), _tiling(u, q))
    return out


# The custom ops: the schema (u, q, bits, an optional bias), the plain
# version for CPU tensors, the kernel for CUDA tensors, and a fake that
# gives tracing the output's shape.  Defined with a ``Library`` rather
# than ``torch.library.custom_op``, whose Python wrapper adds more host
# time to each call (PERF.md section 6): the wrappers are launch-bound at
# serving's shapes.
_LIB = torch.library.Library("cleverrec", "DEF")
_LIB.define("dot_scores(Tensor u, Tensor q, Tensor bits, Tensor? bias) "
            "-> Tensor")
_LIB.define("dot_gmax(Tensor u, Tensor q, Tensor bits, Tensor? bias) "
            "-> Tensor")
_LIB.impl("dot_scores", dot_scores_ref, "CPU")
_LIB.impl("dot_scores", _dot_scores_cuda, "CUDA")
_LIB.impl("dot_gmax", dot_gmax_ref, "CPU")
_LIB.impl("dot_gmax", _dot_gmax_cuda, "CUDA")


@torch.library.register_fake("cleverrec::dot_scores", lib=_LIB)
def _dot_scores_fake(u, q, bits, bias):
    return _empty(u, q.shape[0])


@torch.library.register_fake("cleverrec::dot_gmax", lib=_LIB)
def _dot_gmax_fake(u, q, bits, bias):
    return _empty(u, cdiv(q.shape[0], COMB_I))


def dot_scores(u, q, bits, bias=None):
    """Masked scores [B, I]: ``u @ q.T + bias``, NEG where seen.

    u [B, d] f32, q [I, d] f32, bits [B, ceil(I/32)] int32, bias [I] f32
    or None."""
    _on_cpu("dot_scores", u, q, bits, bias)      # checks; the op picks
    return torch.ops.cleverrec.dot_scores(u, q, bits, bias)


def dot_gmax(u, q, bits, bias=None):
    """Max masked score of each 32-item group [B, ceil(I/32)]; the
    [B, I] scores never reach device memory.  Same inputs as
    ``dot_scores``."""
    _on_cpu("dot_gmax", u, q, bits, bias)        # checks; the op picks
    return torch.ops.cleverrec.dot_gmax(u, q, bits, bias)


def dot_topk_scores(u, q, bits, bias=None):
    """Masked scores for ranking, with the TPU kernel's group maxes.

    Same inputs as ``dot_scores``.  Returns (scores [B, I_pad], gmax
    [B, I_pad/32], item_map [I_pad]), ``I_pad`` = I rounded up to whole
    4096-item tiles.  ``scores`` is in original item order, NEG where
    seen and on the padding columns; ``item_map`` is ``arange(I_pad)``,
    so ``topk(scores, k)`` ids translate through it as through the TPU
    kernel's permutation.  ``gmax`` keeps the TPU kernel's lane layout:
    lane ``128t + j`` (j < 32) is the max of the masked scores of items
    ``4096t + j + 32m``, m < 128 (one 128-column group of its permuted
    tile), and lanes ``128t + j`` with j >= 32 hold NEG.

    The TPU kernel's ``block_b``, ``interpret`` and ``pre_permuted``
    arguments have no counterpart: the CUDA kernel picks its own tiles,
    the plain version runs wherever the tensors lie, and nothing is
    permuted."""
    if _on_cpu("dot_topk_scores", u, q, bits, bias):
        return dot_topk_scores_ref(u, q, bits, bias)
    i_pad = _padded(q.shape[0])
    scores, gmax = _empty(u, i_pad), _empty(u, i_pad // COMB_I)
    _launch("dot_topk_scores", u, q, bits, bias, (scores, gmax),
            (int(_aligned(u, q)),))
    return scores, gmax, torch.arange(i_pad, device=u.device)
