"""Model registry: BPR, the NCF family (GMF, MLP, NeuMF), the social
family (SBPR, TBPR, CUNE_BPR, SAMN, SAMN_single), the metric-learning
family (CML, LRML, TransCF), the item-similarity family (FISM, NAIS,
NAIS_single) and the graph models (LightGCN, NGCF)."""

from __future__ import annotations

import torch

from cleverrec_tpu_torch.common import resolve_device
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.models.base import DataMeta, RecModel
from cleverrec_tpu_torch.models.bpr import BPR
from cleverrec_tpu_torch.models.gcn import NGCF, LightGCN
from cleverrec_tpu_torch.models.itemsim import FISM, NAIS, NAISSingle
from cleverrec_tpu_torch.models.metric import CML, LRML, TransCF
from cleverrec_tpu_torch.models.ncf import GMF, MLP, NeuMF
from cleverrec_tpu_torch.models.social import (CUNE_BPR, SAMN, SBPR, TBPR,
                                               SAMNSingle)

_REGISTRY: dict[str, type] = {m.name: m for m in (
    BPR, GMF, MLP, NeuMF, SBPR, TBPR, CUNE_BPR, SAMN, SAMNSingle, CML, LRML,
    TransCF, FISM, NAIS, NAISSingle, LightGCN, NGCF)}


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def make_model(cfg: Config, meta: DataMeta, device="cuda",
               generator: torch.Generator | None = None) -> RecModel:
    """Build ``cfg.recommender``, initialize it from ``generator``
    (default: seeded with ``cfg.seed``) and move it to ``device``."""
    dev = resolve_device(device)
    name = cfg.recommender
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: it comes with the port's "
            "other-ranking-models slice (ROADMAP.md queue 1, item 11); "
            f"ported: {available_models()}")
    model = _REGISTRY[name](cfg, meta)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model.init(generator)
    return model.to(dev)
