"""One BPR training epoch with dense Adam: the CUDA kernel and its plain
version.

``fused_bpr_epoch`` replaces the TPU kernel ``fused_bpr_epoch`` of
``cleverrec_tpu/ops/pallas_train.py``: the whole epoch's pre-sampled
(u, i, j) rows, one BPR step each (gather, loss, row grads, scatter-add
with duplicate ids summed) followed by dense Adam over all of P and Q at
step ``t0 + s + 1``.  Invalid slots carry the sentinel ids
``U_pad - 1`` / ``I_pad - 1`` of ``sentinel_dims``; an id outside its
table reads a zero row and receives no gradient, so such a slot adds
``LOG2`` to the loss and changes nothing else.

Unlike the JAX function, both versions update the six state tensors IN
PLACE and return only the summed per-step loss, sentinel slots' log 2
included: the caller subtracts ``n_sentinel * LOG2``.  The tables are not
padded, so no padding of the wrapper's own enters the loss.

A wrapper given CPU tensors runs ``fused_bpr_epoch_ref``; given CUDA
tensors it launches the kernel in ``csrc/bpr_epoch.cu`` or raises; it
never falls back.  ``launches`` counts kernel launches (one per epoch).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from cleverrec_tpu_torch.common import ADAM_B1, ADAM_B2, ADAM_EPS

LOG2 = math.log(2.0)   # -log(sigmoid(0)): the loss of one sentinel slot

launches = {"bpr_epoch": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sentinel_dims(u_real: int, i_real: int) -> tuple[int, int]:
    """The JAX kernel's padded table heights; the LAST padded row of each
    is the sentinel id the sampler points invalid slots at (always past
    the real ids)."""
    pad = lambda n: -(-(n + 1) // 128) * 128  # noqa: E731
    return pad(u_real), pad(i_real)


def _bias_corrections(t: int, b1: float, b2: float):
    """1 - exp(t log b) in float32, as the TPU kernel computes them."""
    t32 = np.float32(t)
    return (np.float32(1) - np.exp(t32 * np.float32(math.log(b1))),
            np.float32(1) - np.exp(t32 * np.float32(math.log(b2))))


def _rows(table, ids):
    """Rows of ``table`` at ``ids`` [B], zero where an id is outside the
    table; also the in-table ids, with the others sent to a spare row
    ``len(table)`` for the scatter."""
    n = table.shape[0]
    real = (ids >= 0) & (ids < n)
    safe = torch.where(real, ids, torch.zeros_like(ids))
    rows = torch.where(real[:, None], table[safe],
                       torch.zeros((), device=table.device))
    return rows, torch.where(real, ids, torch.full_like(ids, n))


@torch.no_grad()
def fused_bpr_epoch_ref(p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx, t0: int,
                        *, lr: float, reg: float, b1: float = ADAM_B1,
                        b2: float = ADAM_B2, eps: float = ADAM_EPS):
    """Plain version of ``fused_bpr_epoch``: the same per-step arithmetic
    in PyTorch ops, ``index_add_`` for the scatter.  Same arguments and
    result; updates the state in place."""
    steps = u_idx.shape[0]
    d = p.shape[1]
    losses = torch.zeros(steps, dtype=torch.float32, device=p.device)
    for s in range(steps):
        pe, u = _rows(p, u_idx[s].long())
        qi, i = _rows(q, i_idx[s].long())
        qj, j = _rows(q, j_idx[s].long())
        qd = qi - qj
        diff = (pe * qd).sum(dim=1)
        losses[s] = (-torch.nn.functional.logsigmoid(diff)).sum() + (
            0.5 * reg * ((pe * pe).sum() + (qi * qi).sum() + (qj * qj).sum()))
        g = -torch.sigmoid(-diff)[:, None]
        dp = torch.zeros((p.shape[0] + 1, d), dtype=p.dtype, device=p.device)
        dq = torch.zeros((q.shape[0] + 1, d), dtype=q.dtype, device=q.device)
        dp.index_add_(0, u, g * qd + reg * pe)
        dq.index_add_(0, i, g * pe + reg * qi)
        dq.index_add_(0, j, -g * pe + reg * qj)
        bc1, bc2 = _bias_corrections(t0 + s + 1, b1, b2)
        for x, m, v, gx in ((p, mp, vp, dp[:-1]), (q, mq, vq, dq[:-1])):
            m.copy_(b1 * m + (1.0 - b1) * gx)
            v.copy_(b2 * v + (1.0 - b2) * (gx * gx))
            x.copy_(x - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return losses.sum()


def _check(p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx):
    if p.dim() != 2 or q.dim() != 2 or p.shape[1] != q.shape[1]:
        raise ValueError(f"p {tuple(p.shape)} and q {tuple(q.shape)} must "
                         "be [U, d] and [I, d]")
    for name, m, like in (("mp", mp, p), ("vp", vp, p), ("mq", mq, q),
                          ("vq", vq, q)):
        if m.shape != like.shape:
            raise ValueError(f"{name} {tuple(m.shape)} must match its table "
                             f"{tuple(like.shape)}")
    if u_idx.dim() != 2 or not (u_idx.shape == i_idx.shape == j_idx.shape):
        raise ValueError("u_idx, i_idx and j_idx must be [steps, B] of one "
                         "shape")
    tensors = (p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("state and ids must be on one device")
    if any(t.dtype != torch.float32 for t in tensors[:6]) or any(
            t.dtype != torch.int32 for t in tensors[6:]):
        raise TypeError("tables and moments must be float32, ids int32")


def fused_bpr_epoch(p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx, t0: int,
                    *, lr: float, reg: float, b1: float = ADAM_B1,
                    b2: float = ADAM_B2, eps: float = ADAM_EPS):
    """One BPR epoch with dense Adam, in place.

    p [U, d], q [I, d] f32 tables; mp, vp, mq, vq their Adam moments;
    u_idx, i_idx, j_idx [steps, B] int32 sampled rows, invalid slots at
    the sentinel ids; t0 the Adam step count so far.  Updates the six
    state tensors in place and returns the summed per-step loss (a 0-dim
    f32 tensor) that still includes log 2 per sentinel slot."""
    _check(p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx)
    args = (p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx, int(t0))
    opts = dict(lr=lr, reg=reg, b1=b1, b2=b2, eps=eps)
    if p.device.type == "cpu":
        return fused_bpr_epoch_ref(*args, **opts)
    if p.device.type != "cuda":
        raise ValueError(f"fused_bpr_epoch: no kernel for device {p.device}")
    return _launch(*args, **opts)


def _launch(p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx, t0, *, lr, reg, b1,
            b2, eps):
    tensors = (p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_bpr_epoch: inputs must be contiguous")
    steps, b = u_idx.shape
    if max(*p.shape, q.shape[0], steps, b, t0 + steps) >= 2 ** 31:
        raise ValueError("fused_bpr_epoch: a size or step count past the "
                         "kernel's int32 arguments")
    from cleverrec_tpu_torch.ops.build import load
    fn = load("bpr_epoch").bpr_epoch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_double] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    dp, dq = torch.zeros_like(p), torch.zeros_like(q)
    loss = torch.zeros(steps, dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (p, q, mp, vp, mq, vq, dp, dq,
                                          u_idx, i_idx, j_idx, loss)),
                 p.shape[0], q.shape[0], p.shape[1], steps, b, t0,
                 lr, reg, b1, b2, eps, stream)
    if err != 0:
        raise RuntimeError(f"bpr_epoch: kernel launch failed, cudaError {err}")
    launches["bpr_epoch"] += 1
    return loss.sum()
