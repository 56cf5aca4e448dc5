"""What the benchmark knows of LightGCN (``recommender=LightGCN``): as
``BPR.py`` says of BPR.  The reference rebuilds the normalised graph from
its own split's train pairs."""

from portbench.reference import models
from portbench.weights import draw_tables

# Propagation is gathers and sums, no matrix product for TF32 to change.
CONTROL = "bfloat16"
# No fused tier: the scan tier's padding slots weigh 0 in its loss.
PAD_SLOT_LOSS = 0.0


def tables(conf: dict, users: int, items: int) -> dict:
    d = int(conf["embed_size"])
    return {"P": (users, d), "Q": (items, d)}


def weights(conf: dict, users: int, items: int, seed: int, device) -> dict:
    return draw_tables(conf, tables(conf, users, items), seed, device)


def reference(weights: dict, conf: dict, split, device, dtype):
    graph = models.bipartite_graph(split.train_u, split.train_i, split.users,
                                   split.items, device)
    return models.LightGCN(weights, float(conf["reg"]), graph,
                           int(conf["n_layers"]), dtype)
