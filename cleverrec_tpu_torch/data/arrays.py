"""Packing host dicts into fixed-shape numpy arrays (as
``cleverrec_tpu/data/arrays.py``):

- the flattened positive pairs (every (u, i) in train),
- a per-user SORTED seen-items table padded with the sentinel
  ``item_nums``, plus its packed bitmap,
- the test-side candidate matrix with ground truth at the tail,
- the social data's padded friend matrix, when the dataset has one.

The arrays stay on the host; the evaluator and the serving functions
move what they read to their device once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cleverrec_tpu_torch.data.dataset import RankingData
from cleverrec_tpu_torch.metrics import pad_lists
from cleverrec_tpu_torch.sampling import MemberTable, build_member_table


@dataclass
class DeviceData:
    """Fixed-shape numpy arrays ready to ship to the device."""

    user_nums: int
    item_nums: int
    # Training positives (flattened (u, i) pairs).
    pos_u: np.ndarray            # [N] int32
    pos_i: np.ndarray            # [N] int32
    # Seen-items membership (train interactions): sorted rows + bitmap.
    seen: MemberTable
    # Test side.
    test_users: np.ndarray       # [T] int32
    cand: np.ndarray | None      # [T, C] int32, pad == 0 (masked) — candidate eval
    cand_mask: np.ndarray | None  # [T, C] bool
    real_padded: np.ndarray      # [T, Tmax] int32, PAD_ITEM-padded (host metrics)
    friends_padded: np.ndarray | None = None  # [U, F] int32, sentinel user_nums

    @property
    def num_pairs(self) -> int:
        return int(self.pos_u.shape[0])


def build_device_data(data: RankingData) -> DeviceData:
    counts = [len(v) for v in data.ui_train.values()]
    pos_u = np.repeat(np.fromiter(data.ui_train.keys(), np.int32,
                                  len(counts)), counts)
    pos_i = np.fromiter((i for v in data.ui_train.values() for i in v),
                        np.int32, len(pos_u))
    seen = build_member_table(data.ui_train, data.user_nums, data.item_nums)

    test_users = np.fromiter(data.ui_test.keys(), dtype=np.int32,
                             count=len(data.ui_test))
    cand = cand_mask = None
    if data.candidate_eval:
        neg = data.neg_samples
        cand_lists = [data.ui_test[int(u)] for u in test_users]
        width = max(len(c) for c in cand_lists)
        cand = np.zeros((len(test_users), width), dtype=np.int32)
        cand_mask = np.zeros((len(test_users), width), dtype=bool)
        reals = []
        for r, c in enumerate(cand_lists):
            cand[r, : len(c)] = c
            cand_mask[r, : len(c)] = True
            reals.append(c[neg:])
        real_padded = pad_lists(reals)
    else:
        real_padded = pad_lists([data.ui_test[int(u)] for u in test_users])

    return DeviceData(
        user_nums=data.user_nums, item_nums=data.item_nums,
        pos_u=pos_u, pos_i=pos_i, seen=seen,
        test_users=test_users, cand=cand, cand_mask=cand_mask,
        real_padded=real_padded, friends_padded=data.friends_padded,
    )
