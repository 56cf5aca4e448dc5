"""Shared model building blocks (as ``cleverrec_tpu/models/modules.py``).

The neighbourhood mean that TransCF needs and the one-hidden-layer
attention scorer of SAMN are here so far; the rest of the JAX module
(history attention and the other layers) comes with the other ranking
models.
"""

from __future__ import annotations

import torch


def segment_mean_embeddings(ids_seg: torch.Tensor, ids_val: torch.Tensor,
                            table: torch.Tensor, num_segments: int,
                            inv_counts: torch.Tensor) -> torch.Tensor:
    """out[s] = inv_counts[s] * sum_{k: ids_seg[k]==s} table[ids_val[k]].

    With inv_counts = 1/|segment| this is the row-normalized incidence
    matmul (TransCF's ui/iu matrices).  ``index_add`` out of place, so
    the gradient flows into ``table``."""
    out = torch.zeros((num_segments, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    out = out.index_add(0, ids_seg.long(), table[ids_val.long()])
    return out * inv_counts[:, None]


def relu_mlp_logits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
    """h^T ReLU(x W + b): the one-hidden-layer attention scorer of SAMN
    (and of NAIS and the GAT models), over x's last axis."""
    return torch.relu(x @ w + b) @ h
