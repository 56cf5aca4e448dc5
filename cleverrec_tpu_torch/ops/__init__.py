# The port's counterparts of cleverrec_tpu/ops/__init__.py.
from cleverrec_tpu_torch.ops.scores import (dot_scores,  # noqa: F401
                                            dot_topk_scores)
from cleverrec_tpu_torch.ops.topk import (grouped_topk,  # noqa: F401
                                          merge_topk, sharded_topk_scores,
                                          streaming_topk)
