"""Each configuration's work counts against a count by hand at a small
shape, and the least time at the card's peaks."""

import pytest

from portbench import card, harness

SMALL = {"users": 3, "items": 5, "d": 2, "layers": 2, "batch": 4,
         "neg_ratio": 2, "train_pairs": 3, "steps": 2, "edges": 6,
         "test_users": 3, "test_ids": 4, "test_seen_ids": 3,
         "test_batch": 2, "seen_per_user": 1.5, "call_users": 2, "k": 3}

# By hand, at SMALL.  BPR: 6 slots, 16 state elements (8 rows of 2).
BPR = {
    # slots x 16 flops x d + steps x state x 12; slots x 3 ids + steps x
    # state x (P or Q, m, v) x 4 B x (read, write)
    "bpr_epoch": {"flops": 6 * 16 * 2 + 2 * 16 * 12,
                  "bytes": 6 * 3 * 4 + 2 * 16 * 3 * 4 * 2},
    # a flop a slot; pairs x (u, i, a seen id) + slots x (u, i, j, w)
    "sample_epoch": {"flops": 6, "bytes": 3 * 12 + 6 * 16},
    "train_epoch": {"flops": 576 + 6, "bytes": 840 + 132},
    # 2 B I d; Q and the callers' rows, their ids and seen ids, k ids and
    # scores a caller
    "serve_call": {"flops": 40, "bytes": 56 + 8 + 12 + 48},
}
# LightGCN at SMALL but neg_ratio 1: 8 nodes, 6 directed edges.
GCN_SHAPE = dict(SMALL, neg_ratio=1)
GCN = {
    # layers x edges x 2 d + (layers + 1) x nodes x d; the ego tables and
    # the edge list (row, column, weight)
    "propagate": {"flops": 48 + 48, "bytes": 64 + 72},
    # propagation forward and back, 4 slots x 14 x d, Adam on 16
    # elements; state read and written, edges, the batch's u, i, j, w
    "train_step": {"flops": 192 + 112 + 192, "bytes": 384 + 72 + 64},
    "sample_epoch": {"flops": 3, "bytes": 36 + 48},
    "train_epoch": {"flops": 2 * 496 + 3, "bytes": 2 * 520 + 84},
    # propagation once, 2 T I d; the test users' seen and test ids
    "evaluate": {"flops": 96 + 60, "bytes": 136 + 12 + 16},
    # batches of 2 and 1 rows: 2 b I d; (b d + I d + 2 b words) x 4 B
    "gmax_eval": {"flops": 40 + 20, "bytes": 72 + 56},
}


@pytest.mark.parametrize("config,shape,want", [
    ("bpr-amazonbook", SMALL, BPR), ("lightgcn-gowalla", GCN_SHAPE, GCN)])
def test_work_counts_match_a_count_by_hand(config, shape, want):
    work = harness.module("configs", config)
    for name, counts in want.items():
        assert getattr(work, name)(shape) == pytest.approx(counts), name


def test_least_time_takes_the_larger_bound():
    t, by = card.least_time({"flops": 67e12, "bytes": 1.0})
    assert (t, by) == (pytest.approx(1.0), "operations")
    t, by = card.least_time({"flops": 1.0, "bytes": 6.7e12})
    assert (t, by) == (pytest.approx(2.0), "bytes")


def test_union_of_device_intervals_counts_overlap_once():
    device = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    assert card.busy_ns(device, 0, 40) == 25
    assert card.busy_ns(device, 8, 21) == 8
    spans = [("portbench.unit", 0, 40), ("portbench.sample", 14, 19)]
    gaps = card.breakdown(device, spans, 0, 40)["idle_gaps"]
    assert gaps == [["portbench.unit", 10e-9], ["portbench.sample", 5e-9]]
