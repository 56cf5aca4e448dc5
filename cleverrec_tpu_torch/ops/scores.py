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
``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes

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
    if tuple(bits.shape) != (b, cdiv(i, 32)):
        raise ValueError(f"bits {tuple(bits.shape)} must be "
                         f"[{b}, {cdiv(i, 32)}]")
    if bias is not None and tuple(bias.shape) != (i,):
        raise ValueError(f"bias {tuple(bias.shape)} must be [{i}]")
    tensors = [u, q, bits] + ([bias] if bias is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("u, q, bits and bias must be on one device")
    if (u.dtype, q.dtype, bits.dtype) != (torch.float32, torch.float32,
                                          torch.int32) or (
            bias is not None and bias.dtype != torch.float32):
        raise TypeError("u, q and bias must be float32 and bits int32")


def _launch(name, u, q, bits, bias, *outs):
    if not all(t.is_contiguous() for t in (u, q, bits, *outs)) or (
            bias is not None and not bias.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if q.shape[0] == 0 or u.shape[0] == 0:
        return outs
    if u.shape[0] > 65535 * 64:        # grid.y holds 64-user tiles
        raise ValueError(f"{name}: at most {65535 * 64} users per call")
    from cleverrec_tpu_torch.ops.build import load
    fn = getattr(load("dot_scores"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (4 + len(outs)) + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), q.data_ptr(), bits.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 *(t.data_ptr() for t in outs),
                 u.shape[0], q.shape[0], u.shape[1], bits.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    launches[name] += 1
    return outs


def _dispatch(name, ref, widths, u, q, bits, bias):
    """``ref`` on CPU tensors; on CUDA tensors the kernel ``name``, whose
    outputs are [B, w] float32 for each w in ``widths`` (one output
    returned as itself, several as a tuple)."""
    _check(u, q, bits, bias)
    if u.device.type == "cpu":
        return ref(u, q, bits, bias)
    if u.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {u.device}")
    outs = _launch(name, u, q, bits, bias, *(
        torch.empty((u.shape[0], w), dtype=torch.float32, device=u.device)
        for w in widths))
    return outs[0] if len(outs) == 1 else outs


def dot_scores(u, q, bits, bias=None):
    """Masked scores [B, I]: ``u @ q.T + bias``, NEG where seen.

    u [B, d] f32, q [I, d] f32, bits [B, ceil(I/32)] int32, bias [I] f32
    or None."""
    return _dispatch("dot_scores", dot_scores_ref, [q.shape[0]],
                     u, q, bits, bias)


def dot_gmax(u, q, bits, bias=None):
    """Max masked score of each 32-item group [B, ceil(I/32)]; the
    [B, I] scores never reach device memory.  Same inputs as
    ``dot_scores``."""
    return _dispatch("dot_gmax", dot_gmax_ref, [cdiv(q.shape[0], COMB_I)],
                     u, q, bits, bias)


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
    i_pad = _padded(q.shape[0])
    scores, gmax = _dispatch(
        "dot_topk_scores", lambda *a: dot_topk_scores_ref(*a)[:2],
        [i_pad, i_pad // COMB_I], u, q, bits, bias)
    return scores, gmax, torch.arange(i_pad, device=u.device)
