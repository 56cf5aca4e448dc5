"""Required work of lightgcn-gowalla's timed units, counted from shapes.

Each function takes the run's shape (``harness.shape``) and returns the
FP32 operations and the bytes that the unit's result needs, whatever
computes it: each input byte read once, each output byte written once;
the layers' tables, gradients and score matrices are intermediates.  A
training step propagates the whole graph forward and back; dense Adam
reads and writes P, Q and their two moments every step.  An evaluation
needs the propagated tables once, not once a batch.
"""

F32 = 4
ID = 4                 # an int32 id
EDGE = 2 * ID + F32    # an edge list entry: row, column, weight
ADAM_FLOPS = 12        # an element's Adam step: m 3, v 4, the update 5
SLOT_FLOPS = 14        # per embedding column of a (u, i, j) slot: two
#                        dots and the gradients of the three final rows,
#                        L2 on the three ego rows


def _nodes(s):
    return s["users"] + s["items"]


def propagate(s):
    """E^(l+1) = A_hat E^l for each layer over the edge list, and the
    mean of layers 0..L: from the ego tables and the edges."""
    n, d, layers = _nodes(s), s["d"], s["layers"]
    return {"flops": layers * s["edges"] * 2 * d + (layers + 1) * n * d,
            "bytes": n * d * F32 + s["edges"] * EDGE}


def train_step(s):
    """One step: propagation forward and back, the batch's BPR loss and
    its gradients, dense Adam over P, Q and both moments."""
    n, d = _nodes(s), s["d"]
    prop = propagate(s)
    slots = s["batch"]
    return {"flops": 2 * prop["flops"] + slots * SLOT_FLOPS * d
            + n * d * ADAM_FLOPS,
            "bytes": n * d * 3 * F32 * 2 + s["edges"] * EDGE
            + slots * 4 * ID}


def sample_epoch(s):
    """The epoch's draw: each pair read with its user's seen ids, and
    (u, i, j, w) written for every slot."""
    slots = s["train_pairs"] * s["neg_ratio"]
    return {"flops": slots,
            "bytes": s["train_pairs"] * (2 * ID + ID) + slots * 4 * ID}


def train_epoch(s):
    step, draw = train_step(s), sample_epoch(s)
    return {k: s["steps"] * step[k] + draw[k] for k in step}


def evaluate(s):
    """One evaluation: the propagation once, every test user's scores
    over the catalog (2 T I d), masked by the train ids of the test
    users, top-k, and the metrics against their test ids."""
    t, i, d = s["test_users"], s["items"], s["d"]
    prop = propagate(s)
    return {"flops": prop["flops"] + 2 * t * i * d,
            "bytes": prop["bytes"] + s["test_seen_ids"] * ID
            + s["test_ids"] * ID}


def gmax_eval(s):
    """Kernel 2.3's launches over one evaluation: each batch's real rows
    scored against the whole item table (2 b I d), its bitmaps read and
    group maxes written (b x ceil(I / 32) words each)."""
    t, bt, i, d = s["test_users"], s["test_batch"], s["items"], s["d"]
    words = -(-i // 32)
    flops = bytes_ = 0
    for lo in range(0, t, bt):
        b = min(bt, t - lo)
        flops += 2 * b * i * d
        bytes_ += (b * d + i * d + 2 * b * words) * F32
    return {"flops": flops, "bytes": bytes_}
