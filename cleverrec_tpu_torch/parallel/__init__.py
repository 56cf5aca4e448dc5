# The port's counterparts of cleverrec_tpu/parallel/__init__.py: the mesh
# and the padding rule of sharded ranking.  shard_params, the row-sharded
# gather, the explicit exchange and sharded_train_step come with the
# model axis (ROADMAP.md queue 1, item 16b).
from cleverrec_tpu_torch.parallel.mesh import (Mesh,  # noqa: F401
                                               init_distributed, make_mesh,
                                               single_device_mesh)
from cleverrec_tpu_torch.parallel.sharding import (  # noqa: F401
    pad_table_for_sharding)
