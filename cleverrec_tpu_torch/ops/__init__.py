# The port's counterparts of cleverrec_tpu/ops/__init__.py.  Its
# sharded_topk_scores comes with the parallel layer (ROADMAP.md queue 1,
# item 16).
from cleverrec_tpu_torch.ops.scores import (dot_scores,  # noqa: F401
                                            dot_topk_scores)
from cleverrec_tpu_torch.ops.topk import (grouped_topk,  # noqa: F401
                                          merge_topk, streaming_topk)
