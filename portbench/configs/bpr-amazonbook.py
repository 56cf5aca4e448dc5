"""Required work of bpr-amazonbook's timed units, counted from shapes.

Each function takes the run's shape (``harness.shape``) and returns the
FP32 operations and the bytes that the unit's result needs, whatever
computes it: each input byte read once, each output byte written once;
gradients and score matrices are intermediates.  Dense Adam reads and
writes P, Q and their two moments every step.
"""

F32 = 4
ID = 4                 # an int32 id
ADAM_FLOPS = 12        # an element's Adam step: m 3, v 4, the update 5
SLOT_FLOPS = 16        # per embedding column of a (u, i, j) slot: two
#                        dots, the row gradients of u, i and j with L2


def bpr_epoch(s):
    """Kernel 2.1's epoch: each real slot's gathers, loss and row
    gradients; dense Adam over P, Q and both moments each step."""
    state = (s["users"] + s["items"]) * s["d"]
    slots = s["train_pairs"] * s["neg_ratio"]
    return {"flops": slots * SLOT_FLOPS * s["d"]
            + s["steps"] * state * ADAM_FLOPS,
            "bytes": slots * 3 * ID + s["steps"] * state * 3 * F32 * 2}


def sample_epoch(s):
    """The epoch's draw: each pair read with its user's seen ids, and
    (u, i, j, w) written for every slot."""
    slots = s["train_pairs"] * s["neg_ratio"]
    return {"flops": slots,
            "bytes": s["train_pairs"] * (2 * ID + ID) + slots * 4 * ID}


def train_epoch(s):
    a, b = bpr_epoch(s), sample_epoch(s)
    return {k: a[k] + b[k] for k in a}


def serve_call(s):
    """One retrieval call: the [B, I] score product (2 B I d), from Q,
    the callers' rows and their seen ids; [B, k] ids and scores out."""
    b, i, d = s["call_users"], s["items"], s["d"]
    return {"flops": 2 * b * i * d,
            "bytes": (i * d + b * d) * F32 + b * ID
            + b * s["seen_per_user"] * ID + b * s["k"] * (ID + F32)}
