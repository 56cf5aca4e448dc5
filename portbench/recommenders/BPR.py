"""What the benchmark knows of BPR (``recommender=BPR``): its parameters'
shapes, their draw from the seed, its plain reference, the precision of
its training control, and what the port's fused tier counts for a
padding slot.

A configuration of another recommender brings a module of the same
name beside this one, with the same five entries.
"""

import math

from portbench.reference import models
from portbench.weights import draw_tables

# The training control: the reference one precision below the configured
# float32.  A step holds no matrix product, so TF32 would change nothing:
# bfloat16 it is.
CONTROL = "bfloat16"
# The fused tier's kernel scores a padding slot at 0, -log sigmoid(0) =
# log 2, and takes the epoch's padding slots' log 2 off the epoch's loss.
PAD_SLOT_LOSS = math.log(2.0)


def tables(conf: dict, users: int, items: int) -> dict:
    d = int(conf["embed_size"])
    return {"P": (users, d), "Q": (items, d)}


def weights(conf: dict, users: int, items: int, seed: int, device) -> dict:
    return draw_tables(conf, tables(conf, users, items), seed, device)


def reference(weights: dict, conf: dict, split, device, dtype):
    return models.BPR(weights, float(conf["reg"]), dtype)
