"""Model interface: an ``nn.Module`` that holds its own tables.

The JAX package's models are stateless objects over a params pytree
(``cleverrec_tpu/models/base.py``); here a model is an ``nn.Module``:

- ``init(generator)`` fills the parameters from an explicit
  ``torch.Generator`` (drawn on the CPU, so one seed gives one table on
  every device),
- ``loss(batch, aux) -> scalar``         (summed, weight-masked)
- ``score_pairs(u, i, aux) -> [B]``      (candidate-protocol unit)
- ``score_candidates(u, cand, aux)``     (default: flattened pairs)
- ``score_all(u, aux) -> [B, I]``        (full-catalog protocol)
- ``postprocess()``                      (in place after each optimizer
  step, e.g. CML's unit clipping; nothing by default)

``aux`` is a dict of tensors built once per run from the dataset; BPR
reads none.  ``sampler`` names the batch protocol the trainer drives and
``fused_protocol`` the whole-epoch kernel a model can train through
(None: none).  Scores are higher-is-better: distance models, which rank
ascending, come with the metric-learning slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

from cleverrec_tpu_torch.common import make_initializer
from cleverrec_tpu_torch.config import Config

Aux = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class DataMeta:
    user_nums: int
    item_nums: int


class RecModel(nn.Module):
    """Base ranking model.  Subclasses implement init and the scorers."""

    name: str = "base"
    sampler: str = "pairwise"
    fused_protocol: str | None = None

    def __init__(self, cfg: Config, meta: DataMeta):
        super().__init__()
        self.cfg = cfg
        self.meta = meta
        self.loss_func = cfg.loss_func
        self.initializer = make_initializer(cfg.init_method, cfg.stddev)

    # -- to implement ----------------------------------------------------
    def init(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def loss(self, batch: Dict[str, torch.Tensor], aux: Aux) -> torch.Tensor:
        raise NotImplementedError

    def score_pairs(self, u, i, aux: Aux) -> torch.Tensor:
        raise NotImplementedError

    # -- optional overrides ----------------------------------------------
    def postprocess(self) -> None:
        """In-place hook run after each optimizer step."""

    def score_candidates(self, u, cand, aux: Aux) -> torch.Tensor:
        """[B, C] scores for per-user candidate lists.  Default flattens to
        pair scoring."""
        b, c = cand.shape
        s = self.score_pairs(u.repeat_interleave(c), cand.reshape(-1), aux)
        return s.reshape(b, c)

    # Catalog chunk width for the default score_all.
    SCORE_ALL_CHUNK = 2048

    def score_all(self, u, aux: Aux) -> torch.Tensor:
        """[B, I] full-catalog scores.  Default: candidate scoring over
        item chunks (models with a matmul form override it)."""
        items = torch.arange(self.meta.item_nums, device=u.device)
        chunks = [self.score_candidates(
            u, chunk[None, :].expand(u.shape[0], -1), aux)
            for chunk in items.split(self.SCORE_ALL_CHUNK)]
        return torch.cat(chunks, dim=1)
