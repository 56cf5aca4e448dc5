"""Model registry: BPR, the NCF family (GMF, MLP, NeuMF), the social
family (SBPR, TBPR, CUNE_BPR, SAMN, SAMN_single), the metric-learning
family (CML, LRML, TransCF), the item-similarity family (FISM, NAIS,
NAIS_single), the graph models (LightGCN, NGCF), the social-diffusion
family (DiffNet, DiffNetPlusPlus, LR_GCCF), WMF, DMF, SML and EATNN,
and the dual-domain graph-attention models (RML_DGATs, SoHRML): all 26
ranking models of the JAX package."""

from __future__ import annotations

import torch

from cleverrec_tpu_torch.common import resolve_device
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.models.base import DataMeta, RecModel
from cleverrec_tpu_torch.models.bpr import BPR
from cleverrec_tpu_torch.models.diffnet import (LR_GCCF, DiffNet,
                                                DiffNetPlusPlus)
from cleverrec_tpu_torch.models.extra import DMF, EATNN, SML, WMF
from cleverrec_tpu_torch.models.gcn import NGCF, LightGCN
from cleverrec_tpu_torch.models.graph import RML_DGATs, SoHRML
from cleverrec_tpu_torch.models.itemsim import FISM, NAIS, NAISSingle
from cleverrec_tpu_torch.models.metric import CML, LRML, TransCF
from cleverrec_tpu_torch.models.ncf import GMF, MLP, NeuMF
from cleverrec_tpu_torch.models.social import (CUNE_BPR, SAMN, SBPR, TBPR,
                                               SAMNSingle)

_REGISTRY: dict[str, type] = {}


def register(cls):
    """Add a model class to the registry under its ``name`` (a class
    decorator, as the JAX package's); returns the class."""
    _REGISTRY[cls.name] = cls
    return cls


for _cls in (BPR, GMF, MLP, NeuMF, SBPR, TBPR, CUNE_BPR, SAMN, SAMNSingle,
             CML, LRML, TransCF, FISM, NAIS, NAISSingle, LightGCN, NGCF,
             DiffNet, DiffNetPlusPlus, LR_GCCF, WMF, DMF, SML, EATNN,
             RML_DGATs, SoHRML):
    register(_cls)


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def make_model(cfg: Config, meta: DataMeta, device="cuda",
               generator: torch.Generator | None = None) -> RecModel:
    """Build ``cfg.recommender``, initialize it from ``generator``
    (default: seeded with ``cfg.seed``) and move it to ``device``."""
    dev = resolve_device(device)
    name = cfg.recommender
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: "
                       f"{available_models()}")
    model = _REGISTRY[name](cfg, meta)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model.init(generator)
    return model.to(dev)
