# The port's counterparts of cleverrec_tpu/parallel/__init__.py: the mesh,
# the sharding rules, the row-sharded gather, the explicit exchange and
# the standalone sharded step.
from cleverrec_tpu_torch.parallel.mesh import (Mesh,  # noqa: F401
                                               init_distributed, make_mesh,
                                               single_device_mesh)
from cleverrec_tpu_torch.parallel.sharding import (  # noqa: F401
    ExchangeTable, gather_table, pad_table_for_sharding, param_sharding_tree,
    replicate, row_sharded_gather, shard_batch_spec, shard_params,
    sharded_train_step, table_views, wrap_explicit_exchange)
