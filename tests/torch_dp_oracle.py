"""Serial oracles of the port's data-parallel tiers: the D ranks of a
``D x 1`` mesh run one after another from the same state, each on its
chunk of one epoch's draw, and their deltas are combined by the pure
rule ``dp_combine_rule``.  No process group and no JAX: the tests hold
the JAX package's meshed epochs (tests/test_torch_parallel.py) and the
port's real collectives (tests/test_torch_distributed.py) to these."""

import torch

from cleverrec_tpu_torch.train.trainer import (_state_leaves, _touched,
                                               dp_combine_rule)


def serial_rounds(params, state, tensors, d: int, k: int, mode: str, run):
    """The ranks' rounds of K steps (the whole chunk when k is 0) over
    ``tensors`` ([steps, ...] each), rank c's chunk the steps/D from c x
    steps/D: per round, every rank's ``run(part, offset)`` from the
    round's starting state (and Adam count), then the combine.  ``run``
    trains in place and returns the part's summed loss.  Returns
    (steps/D, the loss summed over the rounds and ranks)."""
    leaves = _state_leaves(params, state)
    local = tensors["u"].shape[0] // d
    width = k or local
    raw = 0.0
    for lo in range(0, local, width):
        start = [x.clone() for x in leaves]
        count = state.count
        sums = [torch.zeros_like(x) for x in leaves]
        touched = [torch.zeros_like(_touched(x)) for x in leaves]
        for c in range(d):
            for x, s0 in zip(leaves, start):
                x.copy_(s0)
            state.count = count
            part = {n: v[c * local + lo:c * local + lo + width]
                    for n, v in tensors.items()}
            raw += float(run(part, lo))
            for j, (x, s0) in enumerate(zip(leaves, start)):
                delta = x - s0
                sums[j] += delta
                touched[j] += _touched(delta)
        for x, s0, ds, ts in zip(leaves, start, sums, touched):
            x.copy_(dp_combine_rule(s0, ds, ts, mode, d))
    return local, raw


def fused_oracle(trainer, params, state, tensors, d: int, k: int,
                 mode: str) -> float:
    """The fused mesh-DP epoch of ``trainer``'s protocol, serially: each
    rank's epoch function from Adam step count + offset; the count then
    advances by steps/D.  Returns the epoch's loss."""
    count = state.count
    local, raw = serial_rounds(
        params, state, tensors, d, k, mode,
        lambda part, lo: trainer._fused_apply(params, state, part,
                                              count + lo))
    state.count = count + local
    return float(trainer._fused_loss(torch.tensor(raw, dtype=torch.float64),
                                     tensors["u"].shape[0]))


def scan_oracle(trainer, params, state, tensors, d: int, k: int,
                mode: str) -> float:
    """The scan tier's local Adam, serially: each rank's scan steps;
    returns the ranks' summed loss over the unpadded step count."""
    _, raw = serial_rounds(
        params, state, tensors, d, k, mode,
        lambda part, _: trainer._steps(params, state, trainer._batches(part),
                                       trainer.model.loss)[2].sum())
    return raw / trainer._real_steps


def grouped_oracle(trainer, params, state, groups, d: int,
                   mode: str) -> float:
    """Grouped under DP, serially: each rank's block-coordinate walk over
    its chunk of every group's draw from the same state, one combine
    after; returns the sum of the ranks' parts of the epoch's mean."""
    leaves = _state_leaves(params, state)
    start = [x.clone() for x in leaves]
    count = state.count
    steps = groups[0]["u"].shape[0]
    local = steps // d
    sums = [torch.zeros_like(x) for x in leaves]
    touched = [torch.zeros_like(_touched(x)) for x in leaves]
    loss = 0.0
    for c in range(d):
        for x, s0 in zip(leaves, start):
            x.copy_(s0)
        state.count = count
        chunk = [{n: v[c * local:(c + 1) * local] for n, v in g.items()}
                 for g in groups]
        loss += float(trainer._grouped_walk(params, state, chunk, steps))
        for j, (x, s0) in enumerate(zip(leaves, start)):
            delta = x - s0
            sums[j] += delta
            touched[j] += _touched(delta)
    for x, s0, ds, ts in zip(leaves, start, sums, touched):
        x.copy_(dp_combine_rule(s0, ds, ts, mode, d))
    return loss
