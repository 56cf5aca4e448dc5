"""Model interface: an ``nn.Module`` that holds its own tables.

The JAX package's models are stateless objects over a params pytree
(``cleverrec_tpu/models/base.py``); here a model is an ``nn.Module``:

- ``init(generator)`` fills the parameters from an explicit
  ``torch.Generator`` (drawn on the CPU, so one seed gives one table on
  every device),
- ``loss(batch, aux) -> scalar``         (summed, weight-masked)
- ``loss_parts(batch, aux) -> (rows, tables)``  (the loss in per-rank
  parts for the scan tier's batch split over ``data``: ``rows`` a sum
  over the batch's rows, its value on a batch the sum of its values on
  any partition of the rows; ``tables`` every term that reads no row of
  the batch; rows + tables is ``loss`` bit for bit; the scan and dual
  tiers train on it.  A model whose loss is a row sum alone defines
  ``loss`` and takes ``loss_parts = RecModel.rows_only_parts``; one with
  table terms defines ``loss_parts`` and takes ``loss =
  RecModel.summed_parts``; a model without parts cannot be split, and
  the trainer says so)
- ``score_pairs(u, i, aux) -> [B]``      (candidate-protocol unit)
- ``score_candidates(u, cand, aux)``     (default: flattened pairs)
- ``score_all(u, aux) -> [B, I]``        (full-catalog protocol)
- ``postprocess()``                      (in place after each optimizer
  step; nothing by default, and no ported model has one: CML's unit
  clipping never feeds back into training, metric.py)
- ``build_aux(dd, data)``                (once per run, before the epoch
  layout: host-side structures, such as the social models' SPu lists and
  exclusion tables for their sampler, or TransCF's inverse degrees for
  its loss; none by default)
- ``epoch_pairs(dd)``                    (the (pos_u, pos_i) pairs an
  epoch is built over; all train pairs by default)

``aux`` is the trainer's dict of device tensors that the losses and
scorers read: the epoch pairs ``pos_u`` and ``pos_i`` and the arrays of
``build_aux`` (TransCF's neighbour means read them; the sampler's tables
are not in it).  ``sampler`` names the batch protocol the trainer drives
and ``fused_protocol`` the whole-epoch kernel a model can train through
(None: none).  Scores are higher-is-better unless ``cml_like`` is set:
distance models (CML, LRML, TransCF) score a squared distance, lower is
better, and every ranker negates it before it masks or selects.
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
    cml_like: bool = False         # distance model: lower score = better

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

    def loss_parts(self, batch: Dict[str, torch.Tensor], aux: Aux):
        raise NotImplementedError(f"{self.name} has no loss_parts")

    def rows_only_parts(self, batch: Dict[str, torch.Tensor], aux: Aux):
        """``loss_parts`` of a loss that is a sum over the batch's rows
        alone: (loss, 0)."""
        rows = self.loss(batch, aux)
        return rows, torch.zeros_like(rows)

    def summed_parts(self, batch: Dict[str, torch.Tensor], aux: Aux):
        """``loss`` of a model with table terms: rows + tables of its
        ``loss_parts``."""
        rows, tables = self.loss_parts(batch, aux)
        return rows + tables

    # -- optional overrides ----------------------------------------------
    def postprocess(self) -> None:
        """In-place hook run after each optimizer step."""

    def build_aux(self, dd, data) -> dict:
        """Host-side structures the model's sampler needs, built once per
        run from the ``DeviceData`` and the ``RankingData``; none here."""
        return {}

    def epoch_pairs(self, dd):
        """(pos_u, pos_i) numpy arrays an epoch is built over: every train
        pair here."""
        return dd.pos_u, dd.pos_i

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


def has_loss_parts(model) -> bool:
    """Whether ``model`` gives its loss in per-rank parts."""
    return type(model).loss_parts is not RecModel.loss_parts
