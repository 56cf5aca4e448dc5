"""Shared model building blocks (as ``cleverrec_tpu/models/modules.py``).

The squared distance of the distance models, the edge-list sum of the
graph models, the neighbourhood mean of TransCF and FISM, the NAIS
smoothed softmax
over a padded history and the one-hidden-layer attention scorer of SAMN
and NAIS.  Gathers of table rows go through ``embedding``
(``gather_rows``): its backward sums each row's gradients in sorted
segments, where indexing's sums each row's duplicates one after
another (most of a step's device time on a card, with many duplicates
a step).
"""

from __future__ import annotations

import torch

# Masked history logits; an all-masked row's max is clamped to
# HIST_MAX_FLOOR so that its exp() terms stay 0 and its output is 0.
HIST_MASKED = -1e30
HIST_MAX_FLOOR = -1e29


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for any shape of ids, through ``embedding``; a 1-d table
    gives ids' shape."""
    if table.dim() == 1:
        return torch.nn.functional.embedding(ids.long(),
                                             table[:, None])[..., 0]
    return torch.nn.functional.embedding(ids.long(), table)


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b|^2 over the last axis: the distance models' score."""
    return torch.sum(torch.square(a - b), dim=-1)


def edge_sum(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             w: torch.Tensor, n: int) -> torch.Tensor:
    """out[r] = sum over the edges (r, c) of w * x[c], for ``n`` rows r:
    a sparse product in edge-list form (the graph models' propagation),
    ``index_add`` out of place, so the gradient flows into ``x``."""
    msg = w[:, None] * gather_rows(x, cols)
    return x.new_zeros((n, x.shape[1])).index_add(0, rows.long(), msg)


def segment_mean_embeddings(ids_seg: torch.Tensor, ids_val: torch.Tensor,
                            table: torch.Tensor, num_segments: int,
                            inv_counts: torch.Tensor) -> torch.Tensor:
    """out[s] = inv_counts[s] * sum_{k: ids_seg[k]==s} table[ids_val[k]].

    With inv_counts = 1/|segment| this is the row-normalized incidence
    matmul (TransCF's ui/iu matrices, FISM's 1/|I_u| user aggregation).
    ``index_add`` out of place, so the gradient flows into ``table``."""
    out = torch.zeros((num_segments, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    out = out.index_add(0, ids_seg.long(), gather_rows(table, ids_val))
    return out * inv_counts[:, None]


def masked_history_attention(hist_emb: torch.Tensor, mask: torch.Tensor,
                             logits: torch.Tensor,
                             beta: float) -> torch.Tensor:
    """NAIS smoothed softmax over a padded history (NAIS_single.py:66-80):
    u = sum_h e^{s_h} p_h / (sum_h e^{s_h})^beta, stabilised by the row
    max m, which is folded back in as e^{m(1 - beta)}.

    hist_emb [B, H, d] history embeddings, mask [B, H] validity, logits
    [B, H] raw scores: returns [B, d].  Logits [B, T, H] score T targets
    of a row against the same history (the JAX package's vmap over axis
    1): returns [B, T, d].  ``amax``, not ``max(dim)``: its gradient
    splits among tied maxima, as ``jnp.max``'s does."""
    per_target = logits.dim() == 3
    if per_target:
        mask = mask[:, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, HIST_MASKED))
    m = torch.clamp(torch.amax(logits, dim=-1, keepdim=True),
                    min=HIST_MAX_FLOOR)
    e = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    s = torch.sum(e, dim=-1, keepdim=True)
    if per_target:
        num = torch.bmm(e, hist_emb)                       # [B, T, d]
    else:
        num = torch.einsum("bh,bhd->bd", e, hist_emb)      # [B, d]
    scale = torch.exp(m * (1.0 - beta)) / torch.clamp(s, min=1e-30) ** beta
    return num * scale


def relu_mlp_logits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
    """h^T ReLU(x W + b): the one-hidden-layer attention scorer of SAMN
    (and of NAIS and the GAT models), over x's last axis."""
    return torch.relu(x @ w + b) @ h
