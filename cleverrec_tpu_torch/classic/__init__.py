"""Classic-CF educational models (the reference's ``model/*/Basic``
standalone scripts, SURVEY.md section 2.3), as ``cleverrec_tpu/classic``:
scipy/numpy implementations behind a shared ``fit / recommend`` interface,
LFM, the SVD family and SLIM trained with PyTorch on ``device`` (default
``cuda``), and the Basic scripts' own metric family (precision / recall /
coverage / popularity — a different family from the framework's
HR/MRR/NDCG, in ``classic.base.evaluate_topn``).
"""

from cleverrec_tpu_torch.classic.base import (  # noqa: F401
    InteractionData, evaluate_topn, topn_from_scores)
from cleverrec_tpu_torch.classic.neighborhood import (  # noqa: F401
    ContentKNN, ItemCF, UserCF)
from cleverrec_tpu_torch.classic.nonpersonalized import (  # noqa: F401
    MostPopular, RandomModel)
from cleverrec_tpu_torch.classic.mf import LFM  # noqa: F401
from cleverrec_tpu_torch.classic.graph_walk import PersonalRank  # noqa: F401
from cleverrec_tpu_torch.classic.tags import TagBasedModel  # noqa: F401
from cleverrec_tpu_torch.classic.temporal import (  # noqa: F401
    RecentPopular, SessionGraph, TimeItemCF, TimeUserCF)
from cleverrec_tpu_torch.classic.rating_knn import (  # noqa: F401
    BiasSVD, FunkSVD, RatingItemCF, RatingUserCF)
from cleverrec_tpu_torch.classic.rating_mf import (  # noqa: F401
    SLIM, SlopeOne, SVDpp, TrustSVD)
