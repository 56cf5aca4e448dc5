"""What the data axis needs of ``cleverrec_tpu/parallel/sharding.py``:
the rule that names a row-shardable table, and the padding of an axis to
a multiple of the shards.  Row-sharded tables (``shard_params``), the
row-sharded gather, the explicit exchange and ``sharded_train_step``
come with the model axis (ROADMAP.md queue 1, item 16b)."""

from __future__ import annotations

import torch


def _is_embedding_table(x, meta) -> bool:
    """Row-shardable: 2-D with a leading dim that is one of the entity
    cardinalities (user or item counts, possibly +1 for a sentinel row,
    or their sum)."""
    if getattr(x, "ndim", 0) != 2:
        return False
    cards = {meta.user_nums, meta.user_nums + 1, meta.item_nums,
             meta.item_nums + 1, meta.user_nums + meta.item_nums}
    return x.shape[0] in cards


def pad_table_for_sharding(table: torch.Tensor, n_shards: int, dim: int = 0,
                           value: float = 0.0) -> torch.Tensor:
    """Pad ``dim`` of ``table`` up to a multiple of ``n_shards`` with
    ``value`` (the JAX function pads the leading dim with zeros; sharded
    ranking pads the item axis of its scores with -inf).  The padded
    slots are never real ids."""
    pad = (-table.shape[dim]) % n_shards
    if pad == 0:
        return table
    shape = list(table.shape)
    shape[dim] = pad
    return torch.cat([table, table.new_full(shape, value)], dim=dim)
