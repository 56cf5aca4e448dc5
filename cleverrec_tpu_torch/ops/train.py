"""Whole training epochs with dense Adam: the CUDA kernels and their plain
versions.

- ``fused_bpr_epoch`` replaces the TPU kernel ``fused_bpr_epoch`` of
  ``cleverrec_tpu/ops/pallas_train.py``: the whole epoch's pre-sampled
  (u, i, j) rows, one BPR step each (gather, loss, row grads, scatter-add
  with duplicate ids summed) followed by dense Adam over all of P and Q
  at step ``t0 + s + 1``.  Kernel: ``csrc/bpr_epoch.cu``.
- ``fused_gmf_epoch`` replaces ``fused_gmf_epoch``: the same for GMF's
  pointwise rows (u, i, y), sigmoid cross-entropy over <h, P[u] * Q[i]>,
  dense Adam over P, Q and h.  Kernel: ``csrc/gmf_epoch.cu``.
- ``fused_mlp_epoch`` replaces ``fused_mlp_epoch``: the pointwise tower
  epoch of MLP and NeuMF over feature-concatenated tables and the dense
  tower params, as a model's ``fused_mlp_spec`` describes it, with rows
  masked by their weight w.  Kernel: ``csrc/mlp_epoch.cu``.
- ``fused_rows_epoch`` replaces ``fused_rows_epoch`` and
  ``fused_rows_epoch_stream`` (the same epoch with the state in HBM; on
  the card the state stays in device memory either way, so
  ``fused_rows_epoch_stream`` is the same function): the multi-plane
  epoch of the social-triple family and LRML, id planes on the user or
  the item side plus float columns, a model's ``row_loss`` over the
  gathered rows, dense Adam.  A row whose plane-0 (user) id is outside the user
  table is masked (w = 0).  Kernel: ``csrc/rows_epoch.cu``, with a
  hand-written backward for each form ``rows_epoch_plan`` accepts: the
  social BPR chain (SBPR, TBPR, CUNE_BPR; kernel ``rows_epoch``) and
  LRML's memory-attention hinge over planes (u, i, j) with the dense K
  [d, mem] and M [mem, d] (kernel ``rows_epoch_lrml``).
- ``fused_cml_epoch`` replaces ``fused_cml_epoch``: CML's rows (u, i)
  with K negatives each, the WARP-weighted hinge on the nearest
  negative (ties to the lowest item id), the covariance regulariser
  over concat(Q, P) on the tables before the step, dense Adam over P
  and Q.  Kernel: ``csrc/cml_epoch.cu``.

In the BPR, GMF and CML epochs invalid slots carry the sentinel ids
``U_pad - 1`` / ``I_pad - 1`` of ``sentinel_dims`` (in CML's every
negative plane too); an id outside its table reads a zero row and
receives no gradient, so such a slot adds ``LOG2`` to the loss (CML:
``cml_sentinel_bias``) and changes nothing else.  The tower epoch masks
rows by w instead (a tower with biases scores a zero row), and so does
the rows epoch: their losses need no correction.

Unlike the JAX functions, both versions update the state tensors IN
PLACE and return only the summed per-step loss, sentinel slots' terms
included: the caller subtracts ``n_sentinel * LOG2`` (CML:
``n_sentinel * cml_sentinel_bias``).  The tables are not padded, so no
padding of the wrapper's own enters the loss.

A wrapper given CPU tensors runs its ``*_ref`` plain version; given CUDA
tensors it launches its kernel or raises; it never falls back.
``launches`` counts kernel launches (one per epoch each).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from cleverrec_tpu_torch.common import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                        sigmoid_xent)

LOG2 = math.log(2.0)   # -log(sigmoid(0)): the loss of one sentinel slot

launches = {"bpr_epoch": 0, "gmf_epoch": 0, "mlp_epoch": 0, "rows_epoch": 0,
            "rows_epoch_lrml": 0, "cml_epoch": 0}


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


def _adam_dense(state, t: int, lr: float, b1: float, b2: float, eps: float):
    """Adam at step t over (param, m, v, grad) quadruples, in place."""
    bc1, bc2 = _bias_corrections(t, b1, b2)
    for x, m, v, g in state:
        m.copy_(b1 * m + (1.0 - b1) * g)
        v.copy_(b2 * v + (1.0 - b2) * (g * g))
        x.copy_(x - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))


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


def _scatter(table, *pairs):
    """[len(table), d] zeros with each (ids, rows) pair added in turn
    (duplicates sum; ids at the spare row ``len(table)`` are dropped)."""
    out = torch.zeros((table.shape[0] + 1, table.shape[1]),
                      dtype=table.dtype, device=table.device)
    for ids, rows in pairs:
        out.index_add_(0, ids, rows)
    return out[:-1]


def _check_same(tensors, ids, floats=()):
    """One device for all; float32 state and columns, int32 ids."""
    everything = (*tensors, *ids, *floats)
    if len({t.device for t in everything}) != 1:
        raise ValueError("state and ids must be on one device")
    if any(t.dtype != torch.float32 for t in (*tensors, *floats)) or any(
            t.dtype != torch.int32 for t in ids):
        raise TypeError("tables, moments and columns must be float32, ids "
                        "int32")
    if ids[0].dim() != 2 or any(t.shape != ids[0].shape
                                for t in (*ids, *floats)):
        raise ValueError("ids and columns must be [steps, B] of one shape")


def _check_moments(pairs):
    for name, m, like in pairs:
        if m.shape != like.shape:
            raise ValueError(f"{name} {tuple(m.shape)} must match its "
                             f"parameter {tuple(like.shape)}")


def _launch_ok(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    launches[name] += 1


def _contiguous(name: str, tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# -- BPR ------------------------------------------------------------------

@torch.no_grad()
def fused_bpr_epoch_ref(p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx, t0: int,
                        *, lr: float, reg: float, b1: float = ADAM_B1,
                        b2: float = ADAM_B2, eps: float = ADAM_EPS):
    """Plain version of ``fused_bpr_epoch``: the same per-step arithmetic
    in PyTorch ops, ``index_add_`` for the scatter.  Same arguments and
    result; updates the state in place."""
    steps = u_idx.shape[0]
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
        dq = _scatter(q, (i, g * pe + reg * qi), (j, -g * pe + reg * qj))
        _adam_dense(((p, mp, vp, _scatter(p, (u, g * qd + reg * pe))),
                     (q, mq, vq, dq)), t0 + s + 1, lr, b1, b2, eps)
    return losses.sum()


def _check(p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx):
    if p.dim() != 2 or q.dim() != 2 or p.shape[1] != q.shape[1]:
        raise ValueError(f"p {tuple(p.shape)} and q {tuple(q.shape)} must "
                         "be [U, d] and [I, d]")
    _check_moments((("mp", mp, p), ("vp", vp, p), ("mq", mq, q),
                    ("vq", vq, q)))
    _check_same((p, q, mp, vp, mq, vq), (u_idx, i_idx, j_idx))


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
    return _launch_bpr(*args, **opts)


def _launch_bpr(p, q, mp, vp, mq, vq, u_idx, i_idx, j_idx, t0, *, lr, reg,
                b1, b2, eps):
    _contiguous("fused_bpr_epoch", (p, q, mp, vp, mq, vq, u_idx, i_idx,
                                    j_idx))
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
        err = fn(*(t.data_ptr() for t in (p, q, mp, vp, mq, vq, dp, dq,
                                          u_idx, i_idx, j_idx, loss)),
                 p.shape[0], q.shape[0], p.shape[1], steps, b, t0,
                 lr, reg, b1, b2, eps, _stream(p.device))
    _launch_ok("bpr_epoch", err)
    return loss.sum()


# -- GMF ------------------------------------------------------------------

@torch.no_grad()
def fused_gmf_epoch_ref(p, q, h, mp, vp, mq, vq, mh, vh, u_idx, i_idx, y,
                        t0: int, *, lr: float, reg: float,
                        b1: float = ADAM_B1, b2: float = ADAM_B2,
                        eps: float = ADAM_EPS):
    """Plain version of ``fused_gmf_epoch``: the same per-step arithmetic
    in PyTorch ops.  Same arguments and result; updates the state in
    place."""
    steps = u_idx.shape[0]
    losses = torch.zeros(steps, dtype=torch.float32, device=p.device)
    for s in range(steps):
        pe, u = _rows(p, u_idx[s].long())
        qi, i = _rows(q, i_idx[s].long())
        prod = pe * qi
        x = (prod * h).sum(dim=1)
        losses[s] = sigmoid_xent(x, y[s]).sum() + 0.5 * reg * (
            (pe * pe).sum() + (qi * qi).sum())
        g = (torch.sigmoid(x) - y[s])[:, None]
        _adam_dense(((p, mp, vp, _scatter(p, (u, g * (qi * h) + reg * pe))),
                     (q, mq, vq, _scatter(q, (i, g * (pe * h) + reg * qi))),
                     (h, mh, vh, (g * prod).sum(dim=0))),
                    t0 + s + 1, lr, b1, b2, eps)
    return losses.sum()


def _check_gmf(p, q, h, mp, vp, mq, vq, mh, vh, u_idx, i_idx, y):
    if (p.dim() != 2 or q.dim() != 2 or h.dim() != 1
            or not p.shape[1] == q.shape[1] == h.shape[0]):
        raise ValueError(f"p {tuple(p.shape)}, q {tuple(q.shape)} and h "
                         f"{tuple(h.shape)} must be [U, d], [I, d] and [d]")
    _check_moments((("mp", mp, p), ("vp", vp, p), ("mq", mq, q),
                    ("vq", vq, q), ("mh", mh, h), ("vh", vh, h)))
    _check_same((p, q, h, mp, vp, mq, vq, mh, vh), (u_idx, i_idx), (y,))


def fused_gmf_epoch(p, q, h, mp, vp, mq, vq, mh, vh, u_idx, i_idx, y,
                    t0: int, *, lr: float, reg: float, b1: float = ADAM_B1,
                    b2: float = ADAM_B2, eps: float = ADAM_EPS):
    """One GMF epoch with dense Adam, in place.

    p [U, d], q [I, d], h [d] f32 (h is not regularised); mp .. vh their
    Adam moments; u_idx, i_idx [steps, B] int32 sampled rows, invalid
    slots at the sentinel ids; y [steps, B] f32 labels; t0 the Adam step
    count so far.  Updates the nine state tensors in place and returns
    the summed per-step loss (a 0-dim f32 tensor) that still includes
    log 2 per sentinel slot."""
    _check_gmf(p, q, h, mp, vp, mq, vq, mh, vh, u_idx, i_idx, y)
    args = (p, q, h, mp, vp, mq, vq, mh, vh, u_idx, i_idx, y, int(t0))
    opts = dict(lr=lr, reg=reg, b1=b1, b2=b2, eps=eps)
    if p.device.type == "cpu":
        return fused_gmf_epoch_ref(*args, **opts)
    if p.device.type != "cuda":
        raise ValueError(f"fused_gmf_epoch: no kernel for device {p.device}")
    return _launch_gmf(*args, **opts)


def _launch_gmf(p, q, h, mp, vp, mq, vq, mh, vh, u_idx, i_idx, y, t0, *, lr,
                reg, b1, b2, eps):
    state = (p, q, h, mp, vp, mq, vq, mh, vh)
    _contiguous("fused_gmf_epoch", (*state, u_idx, i_idx, y))
    steps, b = u_idx.shape
    d = p.shape[1]
    if d > 4096:
        raise ValueError(f"fused_gmf_epoch: d {d} past the kernel's 4096 "
                         "(h and its gradient sit in shared memory)")
    if max(*p.shape, q.shape[0], steps, b, t0 + steps) >= 2 ** 31:
        raise ValueError("fused_gmf_epoch: a size or step count past the "
                         "kernel's int32 arguments")
    from cleverrec_tpu_torch.ops.build import load
    fn = load("gmf_epoch").gmf_epoch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_double] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    grads = [torch.zeros_like(x) for x in (p, q, h)]
    loss = torch.zeros(steps, dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        err = fn(*(t.data_ptr() for t in (*state, *grads, u_idx, i_idx, y,
                                          loss)),
                 p.shape[0], q.shape[0], d, steps, b, t0, lr, reg, b1, b2,
                 eps, _stream(p.device))
    _launch_ok("gmf_epoch", err)
    return loss.sum()


# -- MLP / NeuMF tower ----------------------------------------------------

MLP_MAX_LAYERS = 4
# Dynamic shared memory a block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
_TILE_ROWS = (32, 16, 8)
_MAX_T = 3 + 2 * MLP_MAX_LAYERS


class _MlpArgs(ctypes.Structure):
    """``MlpArgs`` of csrc/mlp_epoch.cu, field for field."""

    _fields_ = ([(n, ctypes.c_int) for n in ("L", "dg", "hm", "tw", "U", "I",
                                             "B", "rows")]
                + [(n, ctypes.c_int * MLP_MAX_LAYERS)
                   for n in ("n_in", "n_out", "ld_w", "off_w", "off_b")]
                + [("off_h", ctypes.c_int),
                   ("off_x", ctypes.c_int * (MLP_MAX_LAYERS + 1)),
                   ("ld_x", ctypes.c_int * (MLP_MAX_LAYERS + 1))]
                + [(n, ctypes.c_int) for n in ("off_ug", "off_ig", "off_d0",
                                               "off_d1", "ld_d", "off_row",
                                               "smem_bytes")]
                + [("reg_g", ctypes.c_float), ("reg_m", ctypes.c_float),
                   ("p", ctypes.c_void_p * _MAX_T),
                   ("g", ctypes.c_void_p * _MAX_T)])


def _mlp_layout(rows: int, dg: int, w_shapes) -> dict:
    """csrc/mlp_epoch.cu's shared memory for a tile of ``rows`` rows, in
    floats: W_l (rows padded to an odd stride), b_l, h, the activations
    x_0..x_L, the GMF slices, two gradient buffers, five per-row words."""
    n_in = [s[0] for s in w_shapes]
    n_out = [s[1] for s in w_shapes]
    widths = [n_in[0]] + n_out
    lay = {"n_in": n_in, "n_out": n_out, "ld_w": [o + 1 for o in n_out],
           "ld_x": [wd + 1 for wd in widths], "ld_d": max(widths) + 1,
           "off_w": [], "off_b": [], "off_x": [], "rows": rows}
    off = 0
    for l, n in enumerate(n_in):
        lay["off_w"].append(off)
        off += n * lay["ld_w"][l]
    for o in n_out:
        lay["off_b"].append(off)
        off += o
    lay["off_h"] = off
    off += dg + n_out[-1]
    for ld in lay["ld_x"]:
        lay["off_x"].append(off)
        off += rows * ld
    for name, size in (("off_ug", dg), ("off_ig", dg),
                       ("off_d0", lay["ld_d"]), ("off_d1", lay["ld_d"]),
                       ("off_row", 5)):
        lay[name] = off
        off += rows * size
    lay["smem_bytes"] = 4 * off
    return lay


def mlp_epoch_plan(dg: int, w_shapes) -> dict:
    """The tower kernel's shared-memory layout for W_l shapes
    ``w_shapes`` and GMF width ``dg``, at the largest tile of 32, 16 or 8
    rows that fits; raises ValueError on a shape the kernel does not
    take (more than 4 layers, or no tile fits)."""
    if not 1 <= len(w_shapes) <= MLP_MAX_LAYERS:
        raise ValueError(f"fused_mlp_epoch: {len(w_shapes)} layers; the "
                         f"kernel takes 1 to {MLP_MAX_LAYERS}")
    for rows in _TILE_ROWS:
        lay = _mlp_layout(rows, dg, w_shapes)
        if lay["smem_bytes"] <= SMEM_LIMIT:
            return lay
    raise ValueError(f"fused_mlp_epoch: a tile of {_TILE_ROWS[-1]} rows "
                     f"needs {lay['smem_bytes']} bytes of shared memory, "
                     f"past the {SMEM_LIMIT} a block may have")


@torch.no_grad()
def fused_mlp_epoch_ref(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense,
                        u_idx, i_idx, y, w, t0: int, *, row_loss, lr: float,
                        b1: float = ADAM_B1, b2: float = ADAM_B2,
                        eps: float = ADAM_EPS):
    """Plain version of ``fused_mlp_epoch``: per step, the gathered rows
    through the model's ``row_loss``, differentiated with autograd, the
    row grads scattered with ``index_add_``, then dense Adam.  Same
    arguments as the wrapper, with ``row_loss`` for its ``spec``."""
    steps = u_idx.shape[0]
    losses = torch.zeros(steps, dtype=torch.float32, device=pu.device)
    for s in range(steps):
        pe, u = _rows(pu, u_idx[s].long())
        qe, i = _rows(qi, i_idx[s].long())
        with torch.enable_grad():
            leaves = [pe.requires_grad_(), qe.requires_grad_()] + [
                x.detach().requires_grad_() for x in dense]
            loss = row_loss(pe, qe, leaves[2:], y[s][:, None], w[s][:, None])
            grads = torch.autograd.grad(loss, leaves)
        losses[s] = loss
        _adam_dense(((pu, mpu, vpu, _scatter(pu, (u, grads[0]))),
                     (qi, mqi, vqi, _scatter(qi, (i, grads[1]))),
                     *zip(dense, mdense, vdense, grads[2:])),
                    t0 + s + 1, lr, b1, b2, eps)
    return losses.sum()


def _check_mlp(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense, u_idx,
               i_idx, y, w, dg):
    """The form of ``fused_mlp_spec``: dense = W_0..W_{L-1}, b_0..b_{L-1},
    h with W_l [in_l, out_l], in_{l+1} = out_l, in_0 = 2 (tw - dg),
    b_l [out_l] and h [dg + out_{L-1}]."""
    n_layers, odd = divmod(len(dense) - 1, 2)
    if (odd or n_layers < 1 or len(mdense) != len(dense)
            or len(vdense) != len(dense)):
        raise ValueError("dense must be W_0..W_{L-1}, b_0..b_{L-1}, h, "
                         "with a moment for each")
    if pu.dim() != 2 or qi.dim() != 2 or pu.shape[1] != qi.shape[1]:
        raise ValueError(f"pu {tuple(pu.shape)} and qi {tuple(qi.shape)} "
                         "must be [U, tw] and [I, tw]")
    ws, bs, h = dense[:n_layers], dense[n_layers:-1], dense[-1]
    want = 2 * (pu.shape[1] - dg)
    for l, (wl, bl) in enumerate(zip(ws, bs)):
        if (wl.dim() != 2 or wl.shape[0] != want
                or tuple(bl.shape) != (wl.shape[1],)):
            raise ValueError(f"W_{l} {tuple(wl.shape)} and b_{l} "
                             f"{tuple(bl.shape)} must be [{want}, n] and [n]")
        want = wl.shape[1]
    if tuple(h.shape) != (dg + want,):
        raise ValueError(f"h {tuple(h.shape)} must be [{dg + want}]")
    _check_moments([("mpu", mpu, pu), ("vpu", vpu, pu), ("mqi", mqi, qi),
                    ("vqi", vqi, qi)]
                   + [(f"moment of dense[{k}]", m, x)
                      for k, x in enumerate(dense)
                      for m in (mdense[k], vdense[k])])
    _check_same((pu, qi, *dense, mpu, mqi, *mdense, vpu, vqi, *vdense),
                (u_idx, i_idx), (y, w))


def fused_mlp_epoch(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense,
                    u_idx, i_idx, y, w, t0: int, *, spec: dict, lr: float,
                    b1: float = ADAM_B1, b2: float = ADAM_B2,
                    eps: float = ADAM_EPS):
    """One pointwise tower epoch (MLP, NeuMF) with dense Adam, in place.

    pu [U, tw], qi [I, tw] f32 feature-concatenated user and item tables
    (``spec["u"]``, ``spec["i"]``); dense the tower params in
    ``spec["dense"]`` order, in their own shapes; m*, v* their Adam
    moments (dense ones as sequences in the same order); u_idx, i_idx
    [steps, B] int32 rows; y, w [steps, B] f32 labels and weights
    (w = 0 masks a row); t0 the Adam step count so far.  ``spec`` is the
    model's ``fused_mlp_spec()``: the kernel takes its ``gmf_width``,
    ``reg_gmf`` and ``reg_mlp``, the plain version its ``row_loss``.
    Updates every state tensor in place and returns the summed per-step
    loss (a 0-dim f32 tensor); no correction is due."""
    dense, mdense, vdense = tuple(dense), tuple(mdense), tuple(vdense)
    dg = int(spec["gmf_width"])
    _check_mlp(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense, u_idx,
               i_idx, y, w, dg)
    args = (pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense, u_idx, i_idx,
            y, w, int(t0))
    if pu.device.type == "cpu":
        return fused_mlp_epoch_ref(*args, row_loss=spec["row_loss"], lr=lr,
                                   b1=b1, b2=b2, eps=eps)
    if pu.device.type != "cuda":
        raise ValueError(f"fused_mlp_epoch: no kernel for device {pu.device}")
    return _launch_mlp(*args, dg=dg, reg_g=float(spec["reg_gmf"]),
                       reg_m=float(spec["reg_mlp"]), lr=lr, b1=b1, b2=b2,
                       eps=eps)


def _launch_mlp(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense, u_idx,
                i_idx, y, w, t0, *, dg, reg_g, reg_m, lr, b1, b2, eps):
    params = (pu, qi, *dense)
    _contiguous("fused_mlp_epoch", (*params, mpu, mqi, *mdense, vpu, vqi,
                                    *vdense, u_idx, i_idx, y, w))
    n_layers = (len(dense) - 1) // 2
    lay = mlp_epoch_plan(dg, [tuple(x.shape) for x in dense[:n_layers]])
    steps, b = u_idx.shape
    if max(pu.numel(), qi.numel(), steps, b, t0 + steps) >= 2 ** 31:
        raise ValueError("fused_mlp_epoch: a size or step count past the "
                         "kernel's int32 arguments")
    grads = [torch.zeros_like(x) for x in params]
    a = _MlpArgs(L=n_layers, dg=dg, hm=pu.shape[1] - dg, tw=pu.shape[1],
                 U=pu.shape[0], I=qi.shape[0], B=b, rows=lay["rows"],
                 reg_g=reg_g, reg_m=reg_m)
    for key in ("n_in", "n_out", "ld_w", "off_w", "off_b", "off_x", "ld_x"):
        getattr(a, key)[:len(lay[key])] = lay[key]
    for key in ("off_h", "off_ug", "off_ig", "off_d0", "off_d1", "ld_d",
                "off_row", "smem_bytes"):
        setattr(a, key, lay[key])
    a.p[:len(params)] = [x.data_ptr() for x in params]
    a.g[:len(grads)] = [x.data_ptr() for x in grads]
    ptrs = lambda ts: (ctypes.c_void_p * _MAX_T)(  # noqa: E731
        *(x.data_ptr() for x in ts))
    m_arr, v_arr = ptrs((mpu, mqi, *mdense)), ptrs((vpu, vqi, *vdense))
    from cleverrec_tpu_torch.ops.build import load
    fn = load("mlp_epoch").mlp_epoch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_double] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    loss = torch.zeros(steps, dtype=torch.float32, device=pu.device)
    with torch.cuda.device(pu.device):
        err = fn(ctypes.addressof(a), ctypes.addressof(m_arr),
                 ctypes.addressof(v_arr), u_idx.data_ptr(), i_idx.data_ptr(),
                 y.data_ptr(), w.data_ptr(), loss.data_ptr(), steps, t0, lr,
                 b1, b2, eps, _stream(pu.device))
    _launch_ok("mlp_epoch", err)
    return loss.sum()


# -- multi-plane rows (social-triple family, LRML) --------------------------

ROWS_MAX_ITEMS = 4


def _side(t) -> tuple:
    """A table side as a tuple of tensors; one tensor is a side of one."""
    return tuple(t) if isinstance(t, (tuple, list)) else (t,)


def _cols(t):
    """A 1-D table as an [N, 1] view."""
    return t if t.dim() == 2 else t.unsqueeze(1)


@torch.no_grad()
def fused_rows_epoch_ref(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense,
                         planes, floats, t0: int, *, sides, row_loss,
                         lr: float, b1: float = ADAM_B1, b2: float = ADAM_B2,
                         eps: float = ADAM_EPS):
    """Plain version of ``fused_rows_epoch``: per step, each plane's rows
    gathered (its side's tables side by side, zero past a table), the
    model's ``row_loss`` over them differentiated with autograd, the row
    grads scattered back with ``index_add_``, then dense Adam.  Same
    arguments as the wrapper, with ``row_loss`` for its ``spec``."""
    pu, qi, mpu, mqi, vpu, vqi = map(_side, (pu, qi, mpu, mqi, vpu, vqi))
    tables = {"u": (pu, mpu, vpu), "i": (qi, mqi, vqi)}
    n_planes, n_users = len(planes), pu[0].shape[0]
    steps = planes[0].shape[0]
    losses = torch.zeros(steps, dtype=torch.float32, device=pu[0].device)
    for s in range(steps):
        u_ids = planes[0][s].long()
        w = ((u_ids >= 0) & (u_ids < n_users)).to(torch.float32)[:, None]
        rows, spare = [], []
        for p, sd in enumerate(sides):
            parts = [_rows(_cols(t), planes[p][s].long())
                     for t in tables[sd][0]]
            rows.append(torch.cat([r for r, _ in parts], dim=1))
            spare.append(parts[0][1])
        with torch.enable_grad():
            leaves = [r.requires_grad_() for r in rows] + [
                x.detach().requires_grad_() for x in dense]
            loss = row_loss(tuple(leaves[:n_planes]),
                            tuple(f[s][:, None] for f in floats),
                            tuple(leaves[n_planes:]), w)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        losses[s] = loss
        quads = []
        for sd, (params, ms, vs) in tables.items():
            off = 0
            for x, m, v in zip(params, ms, vs):
                width = _cols(x).shape[1]
                g = _scatter(_cols(x), *(
                    (spare[p], grads[p][:, off:off + width])
                    for p in range(n_planes) if sides[p] == sd))
                quads.append((x, m, v, g.reshape(x.shape)))
                off += width
        quads += [(x, m, v, torch.zeros_like(x) if g is None else g)
                  for x, m, v, g in zip(dense, mdense, vdense,
                                        grads[n_planes:])]
        _adam_dense(quads, t0 + s + 1, lr, b1, b2, eps)
    return losses.sum()


LRML_WARPS = (16, 8, 4)


def _lrml_smem(d: int, mem: int, warps: int) -> int:
    """csrc/rows_epoch.cu's shared memory for LRML's form, in bytes: K
    [d, mem | 1] and M [mem, d | 1] (odd strides, no bank conflicts) and
    their gradient sums, and per warp the rows ue, i, j, their grads, a
    and e for i and j (10 d) and att for i and j and one scratch (3 mem)."""
    return 4 * (2 * (d * (mem | 1) + mem * (d | 1))
                + warps * (10 * d + 3 * mem))


def _lrml_plan(spec: dict, lrml: dict) -> dict:
    sides = tuple(sd for _, sd in spec["planes"])
    if sides != ("u", "i", "i") or spec["floats"] or len(spec["dense"]) != 2:
        raise ValueError("fused_rows_epoch: LRML's form takes the planes "
                         "(u, i, j), no float column and the dense K and M")
    if lrml["loss"] != "hinge":
        raise ValueError("fused_rows_epoch: LRML's form has the hinge's "
                         f"backward, not that of loss_func={lrml['loss']}")
    d, mem = int(lrml["d"]), int(lrml["mem"])
    for warps in LRML_WARPS:
        smem = _lrml_smem(d, mem, warps)
        if smem <= SMEM_LIMIT:
            return {"form": "lrml", "items": 2, "float_link": -1,
                    "dense_link": -1, "d": d, "mem": mem, "warps": warps,
                    "smem_bytes": smem, "margin": float(lrml["margin"]),
                    "reg": float(lrml["reg"])}
    raise ValueError(f"fused_rows_epoch: LRML's form at d {d}, mem {mem} "
                     f"needs {smem} bytes of shared memory for "
                     f"{LRML_WARPS[-1]} warps, past the {SMEM_LIMIT} a "
                     "block may have")


def rows_epoch_plan(spec: dict) -> dict:
    """The rows kernel's view of a model's ``fused_rows_spec``, one of
    two forms whose backward the kernel has by hand:

    - ``lrml`` (the spec's ``lrml`` entry): LRML over planes (u, i, j),
      d = |P[u] + softmax((P[u] * x) K) M - x|^2 for x = Q[i], Q[j], loss
      max(d_i - d_j + margin, 0) plus reg (|P[u]|^2 + |Q[i]|^2 +
      |Q[j]|^2) / 2 a valid row.  Returns {"form": "lrml", "items": 2,
      "float_link": -1, "dense_link": -1, "d", "mem", "warps",
      "smem_bytes", "margin", "reg"}.
    - ``chain`` (the spec's ``chain`` entry): the social BPR chain over
      one user plane and L item planes (2 <= L <= ``ROWS_MAX_ITEMS``),
      x_m = <P[u], Q[m]> + bias[m], links z_t = (x_t - x_{t+1}) / c_t
      with c_t = max(f, 1) on the float column's link, s + 1 on the dense
      scalar's link and 1 elsewhere, loss sum_t -log sigmoid(z_t) plus
      reg (|P[u]|^2 + sum_m |Q[m]|^2 + bias[m]^2) / 2 a valid row.
      Returns {"form": "chain", "items", "float_link", "dense_link",
      "reg"} (-1 for no link).

    Raises ValueError for a spec outside both forms."""
    lrml = spec.get("lrml")
    if lrml is not None:
        return _lrml_plan(spec, lrml)
    chain = spec.get("chain")
    if chain is None:
        raise ValueError("fused_rows_epoch: the spec's row_loss is neither "
                         "the social BPR chain (no 'chain' entry) nor "
                         "LRML's form (no 'lrml' entry): the kernel has no "
                         "backward for it")
    sides = tuple(sd for _, sd in spec["planes"])
    items = len(sides) - 1
    if sides != ("u",) + ("i",) * items or not 2 <= items <= ROWS_MAX_ITEMS:
        raise ValueError(f"fused_rows_epoch: planes on sides {sides}; the "
                         f"kernel takes one user plane then 2 to "
                         f"{ROWS_MAX_ITEMS} item planes")
    links = {}
    for key, names in (("float_link", spec["floats"]),
                       ("dense_link", spec["dense"])):
        link = chain.get(key)
        if (link is None) != (len(names) == 0) or len(names) > 1 or (
                link is not None and not 0 <= link < items - 1):
            raise ValueError(f"fused_rows_epoch: {key} {link} with "
                             f"{len(names)} {key.split('_')[0]} inputs over "
                             f"{items - 1} links")
        links[key] = -1 if link is None else int(link)
    if links["float_link"] >= 0 and links["float_link"] == links["dense_link"]:
        raise ValueError("fused_rows_epoch: one link cannot take both "
                         "divisors")
    return {"form": "chain", "items": items, **links,
            "reg": float(chain["reg"])}


def _check_rows(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense, planes,
                floats, sides):
    if not planes or len(sides) != len(planes) or sides[0] != "u" or any(
            sd not in ("u", "i") for sd in sides):
        raise ValueError(f"sides {sides} must name 'u' (first) or 'i' for "
                         f"each of the {len(planes)} planes")
    for name, side, moments in (("pu", pu, (mpu, vpu)), ("qi", qi, (mqi, vqi)),
                                ("dense", dense, (mdense, vdense))):
        if name != "dense" and (not side or any(
                t.dim() not in (1, 2) for t in side) or len(
                {t.shape[0] for t in side}) != 1):
            raise ValueError(f"{name}: tables of one height, 1-D or 2-D")
        if any(len(mo) != len(side) for mo in moments):
            raise ValueError(f"{name}: a moment for each tensor")
        _check_moments([(f"moment of {name}[{k}]", m, x) for mo in moments
                        for k, (x, m) in enumerate(zip(side, mo))])
    _check_same((*pu, *qi, *dense, *mpu, *mqi, *mdense, *vpu, *vqi, *vdense),
                planes, floats)


def fused_rows_epoch(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense,
                     planes, floats, t0: int, *, sides, spec: dict,
                     lr: float, b1: float = ADAM_B1, b2: float = ADAM_B2,
                     eps: float = ADAM_EPS):
    """One multi-plane epoch (social-triple family, LRML) with dense Adam,
    in place.

    pu, qi: the user and item sides, each a tensor or a tuple of tensors
    of one height that a gathered row joins on the feature axis (a 1-D
    tensor is one column): SBPR's (P,) and (Q, bias[:I]); dense: the
    model's dense params (CUNE_BPR's 0-d s, LRML's K and M); m*, v*:
    their Adam moments
    in the same layout; planes: [steps, B] int32 id streams, plane p on
    the user side when ``sides[p]`` is 'u' (plane 0 must be, and a row
    whose plane-0 id is outside the user table is masked) else the item
    side; floats: [steps, B] f32 columns; t0 the Adam step count so far.
    ``spec`` is the model's ``fused_rows_spec()``: the kernel takes its
    form (``rows_epoch_plan``), the plain version its ``row_loss``.
    Updates every state tensor in place and returns the summed per-step
    loss (a 0-dim f32 tensor); no correction is due."""
    pu, qi, mpu, mqi, vpu, vqi = map(_side, (pu, qi, mpu, mqi, vpu, vqi))
    dense, mdense, vdense = tuple(dense), tuple(mdense), tuple(vdense)
    planes, floats, sides = tuple(planes), tuple(floats), tuple(sides)
    _check_rows(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense, planes,
                floats, sides)
    args = (pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense, planes,
            floats, int(t0))
    if pu[0].device.type == "cpu":
        return fused_rows_epoch_ref(*args, sides=sides,
                                    row_loss=spec["row_loss"], lr=lr, b1=b1,
                                    b2=b2, eps=eps)
    if pu[0].device.type != "cuda":
        raise ValueError(f"fused_rows_epoch: no kernel for device "
                         f"{pu[0].device}")
    plan = rows_epoch_plan(spec)
    if sides != ("u",) + ("i",) * plan["items"]:
        raise ValueError(f"fused_rows_epoch: sides {sides} differ from the "
                         "spec's planes")
    return _launch_rows(*args, plan=plan, lr=lr, b1=b1, b2=b2, eps=eps)


# On the card the state stays in device memory whatever its size: the
# TPU's streamed variant is the same function here.
fused_rows_epoch_stream = fused_rows_epoch


class _RowsArgs(ctypes.Structure):
    """``RowsArgs`` of csrc/rows_epoch.cu, field for field."""

    _fields_ = ([(n, ctypes.c_void_p * 4) for n in ("p", "m", "v", "g")]
                + [("plane", ctypes.c_void_p * (1 + ROWS_MAX_ITEMS)),
                   ("fcol", ctypes.c_void_p), ("loss", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in ("U", "I", "d", "B", "items",
                                               "steps", "t0", "float_link",
                                               "dense_link")]
                + [(n, ctypes.c_float) for n in ("reg", "lr", "eps")]
                + [("b1", ctypes.c_double), ("b2", ctypes.c_double)]
                + [(n, ctypes.c_int) for n in ("form", "mem", "warps",
                                               "smem_bytes")]
                + [("margin", ctypes.c_float)])


ROWS_FORMS = {"chain": 0, "lrml": 1}


def _check_rows_chain(pu, qi, dense, floats, plan):
    if (len(pu) != 1 or pu[0].dim() != 2 or len(qi) != 2
            or qi[0].dim() != 2 or qi[1].dim() != 1
            or qi[0].shape[1] != pu[0].shape[1]):
        raise ValueError("fused_rows_epoch: the kernel takes pu = (P [U, d],)"
                         " and qi = (Q [I, d], bias [I])")
    n_dense = int(plan["dense_link"] >= 0)
    if len(dense) != n_dense or any(x.numel() != 1 for x in dense):
        raise ValueError("fused_rows_epoch: the kernel takes the dense "
                         "scalar of the chain's dense link and nothing else")
    if len(floats) != int(plan["float_link"] >= 0):
        raise ValueError("fused_rows_epoch: one float column for the "
                         "chain's float link, none without")


def _check_rows_lrml(pu, qi, dense, floats, plan):
    d, mem = plan["d"], plan["mem"]
    if (len(pu) != 1 or len(qi) != 1 or floats
            or tuple(pu[0].shape[1:]) != (d,)
            or tuple(qi[0].shape[1:]) != (d,) or len(dense) != 2
            or tuple(dense[0].shape) != (d, mem)
            or tuple(dense[1].shape) != (mem, d)):
        raise ValueError(f"fused_rows_epoch: LRML's form takes pu = (P [U, "
                         f"{d}],), qi = (Q [I, {d}],), dense = (K [{d}, "
                         f"{mem}], M [{mem}, {d}]) and no float column")


def _launch_rows(pu, qi, dense, mpu, mqi, mdense, vpu, vqi, vdense, planes,
                 floats, t0, *, plan, lr, b1, b2, eps):
    lrml = plan["form"] == "lrml"
    if lrml:
        _check_rows_lrml(pu, qi, dense, floats, plan)
    else:
        _check_rows_chain(pu, qi, dense, floats, plan)
    params = (*pu, *qi, *dense)
    _contiguous("fused_rows_epoch", (*params, *mpu, *mqi, *mdense, *vpu,
                                     *vqi, *vdense, *planes, *floats))
    steps, b = planes[0].shape
    (p, q), d = params[:2], pu[0].shape[1]
    if max(p.numel(), q.numel(), steps, b, t0 + steps) >= 2 ** 31:
        raise ValueError("fused_rows_epoch: a size or step count past the "
                         "kernel's int32 arguments")
    grads = [torch.zeros_like(x) for x in params]
    loss = torch.zeros(steps, dtype=torch.float32, device=p.device)
    a = _RowsArgs(U=p.shape[0], I=q.shape[0], d=d, B=b, items=plan["items"],
                  steps=steps, t0=t0, float_link=plan["float_link"],
                  dense_link=plan["dense_link"], reg=plan["reg"], lr=lr,
                  eps=eps, b1=b1, b2=b2,
                  fcol=floats[0].data_ptr() if floats else None,
                  loss=loss.data_ptr(), form=ROWS_FORMS[plan["form"]],
                  mem=plan.get("mem", 0), warps=plan.get("warps", 0),
                  smem_bytes=plan.get("smem_bytes", 0),
                  margin=plan.get("margin", 0.0))
    for key, group in (("p", params), ("m", (*mpu, *mqi, *mdense)),
                       ("v", (*vpu, *vqi, *vdense)), ("g", grads)):
        getattr(a, key)[:len(group)] = [x.data_ptr() for x in group]
    a.plane[:len(planes)] = [x.data_ptr() for x in planes]
    from cleverrec_tpu_torch.ops.build import load
    fn = load("rows_epoch").rows_epoch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(p.device):
        err = fn(ctypes.addressof(a), _stream(p.device))
    _launch_ok("rows_epoch_lrml" if lrml else "rows_epoch", err)
    return loss.sum()


# -- CML ------------------------------------------------------------------

def _lane_sq_dist(a, b):
    """|a - b|^2 over the last axis, summed as csrc/cml_epoch.cu sums it:
    lane l of a warp adds the squares of elements l, l + 32, .. in turn
    (no FMA), then an xor butterfly adds the 32 lanes.  Each step is an
    f32 product or sum rounded on its own, so both versions get the same
    distances and pick the same negatives."""
    diff = a - b
    diff = torch.nn.functional.pad(diff, (0, (-diff.shape[-1]) % 32))
    sq = diff * diff
    sq = sq.reshape(*sq.shape[:-1], -1, 32)
    acc = sq[..., 0, :]
    for t in range(1, sq.shape[-2]):
        acc = acc + sq[..., t, :]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def cml_sentinel_bias(margin: float, item_nums: int, neg_ratio: int) -> float:
    """The loss of one sentinel row of ``fused_cml_epoch``: its rows are
    zero, so its slack is ``margin`` and all K negatives are imposters,
    and its WARP weight is log(item_nums / K + 1)."""
    return margin * math.log(item_nums / neg_ratio + 1.0)


@torch.no_grad()
def fused_cml_epoch_ref(p, q, mp, vp, mq, vq, u_idx, i_idx, n_idx, t0: int,
                        *, lr: float, reg: float, margin: float,
                        item_nums: int, b1: float = ADAM_B1,
                        b2: float = ADAM_B2, eps: float = ADAM_EPS):
    """Plain version of ``fused_cml_epoch``: the same per-step arithmetic
    in PyTorch ops, ``index_add_`` for the scatter.  Same arguments and
    result; updates the state in place."""
    steps, _, k = n_idx.shape
    n_users, n_rows = p.shape[0], p.shape[0] + q.shape[0]
    big = torch.iinfo(torch.int64).max
    losses = torch.zeros(steps, dtype=torch.float32, device=p.device)
    for s in range(steps):
        pe, u = _rows(p, u_idx[s].long())
        qi, i = _rows(q, i_idx[s].long())
        negs = n_idx[s].long()                               # [B, K]
        qn = _rows(q, negs.reshape(-1))[0].reshape(*negs.shape, -1)
        d_ui = _lane_sq_dist(pe, qi)
        d_un = _lane_sq_dist(pe[:, None], qn)
        d_min = d_un.min(dim=1).values
        # The nearest negative; exact ties go to the lowest item id.
        sel = torch.where(d_un == d_min[:, None], negs, big).min(dim=1).values
        cnt = ((d_ui[:, None] + margin - d_un) > 0).sum(dim=1).float()
        wlog = torch.log(cnt / k * item_nums / k + 1.0)
        slack = d_ui + margin - d_min
        c = (2.0 * wlog * (slack > 0))[:, None]
        qs, sel = _rows(q, sel)
        # The covariance regulariser over concat(Q, P), before the step.
        x = torch.cat([q, p])
        xc = x - x.sum(dim=0) / n_rows
        s_r = xc.sum(dim=1, keepdim=True)
        g_cov = (2.0 * reg / n_rows) * (s_r - xc)
        losses[s] = torch.sum(wlog * torch.clamp(slack, min=0.0)) + reg * (
            torch.sum(s_r * s_r) - torch.sum(xc * xc)) / n_rows
        dp = _scatter(p, (u, c * (qs - qi))) + g_cov[-n_users:]
        dq = _scatter(q, (i, -c * (pe - qi)), (sel, c * (pe - qs))) + (
            g_cov[:-n_users])
        _adam_dense(((p, mp, vp, dp), (q, mq, vq, dq)), t0 + s + 1, lr, b1,
                    b2, eps)
    return losses.sum()


def _check_cml(p, q, mp, vp, mq, vq, u_idx, i_idx, n_idx):
    _check(p, q, mp, vp, mq, vq, u_idx, i_idx, i_idx)
    if n_idx.device != p.device:
        raise ValueError("state and ids must be on one device")
    if n_idx.dtype != torch.int32:
        raise TypeError("negative ids must be int32")
    if n_idx.dim() != 3 or n_idx.shape[:2] != u_idx.shape or not (
            n_idx.shape[2] >= 1):
        raise ValueError(f"negatives {tuple(n_idx.shape)} must be [steps, B, "
                         f"K >= 1] beside ids {tuple(u_idx.shape)}")


def fused_cml_epoch(p, q, mp, vp, mq, vq, u_idx, i_idx, n_idx, t0: int,
                    *, lr: float, reg: float, margin: float, item_nums: int,
                    b1: float = ADAM_B1, b2: float = ADAM_B2,
                    eps: float = ADAM_EPS):
    """One CML epoch with dense Adam, in place.

    p [U, d], q [I, d] f32 tables; mp, vp, mq, vq their Adam moments;
    u_idx, i_idx [steps, B] and n_idx [steps, B, K] int32 sampled rows,
    invalid slots at the sentinel ids in all three; t0 the Adam step
    count so far; ``item_nums`` the real catalog size of the WARP rank.
    Per step: d_ui = |P[u] - Q[i]|^2, d_k = |P[u] - Q[n_k]|^2, the
    nearest negative (ties to the lowest item id), the imposter count
    cnt = #{k: d_ui + margin > d_k}, loss wlog * max(d_ui + margin -
    d_min, 0) with wlog = log(cnt / K * item_nums / K + 1) (no gradient
    through it); the covariance regulariser over concat(Q, P) on the
    tables before the step; dense Adam at t0 + s + 1.  Updates the six
    state tensors in place and returns the summed per-step loss (a 0-dim
    f32 tensor) that still includes ``cml_sentinel_bias`` per sentinel
    row."""
    _check_cml(p, q, mp, vp, mq, vq, u_idx, i_idx, n_idx)
    args = (p, q, mp, vp, mq, vq, u_idx, i_idx, n_idx, int(t0))
    opts = dict(lr=lr, reg=reg, margin=margin, item_nums=item_nums, b1=b1,
                b2=b2, eps=eps)
    if p.device.type == "cpu":
        return fused_cml_epoch_ref(*args, **opts)
    if p.device.type != "cuda":
        raise ValueError(f"fused_cml_epoch: no kernel for device {p.device}")
    return _launch_cml(*args, **opts)


def _launch_cml(p, q, mp, vp, mq, vq, u_idx, i_idx, n_idx, t0, *, lr, reg,
                margin, item_nums, b1, b2, eps):
    _contiguous("fused_cml_epoch", (p, q, mp, vp, mq, vq, u_idx, i_idx,
                                    n_idx))
    steps, b, k = n_idx.shape
    if max(p.numel(), q.numel(), n_idx.numel(), t0 + steps) >= 2 ** 31:
        raise ValueError("fused_cml_epoch: a size or step count past the "
                         "kernel's int32 arguments")
    from cleverrec_tpu_torch.ops.build import load
    fn = load("cml_epoch").cml_epoch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 4 + [ctypes.c_double] * 2
                   + [ctypes.c_float, ctypes.c_void_p])
    dp, dq = torch.zeros_like(p), torch.zeros_like(q)
    colsum = torch.zeros((steps, p.shape[1]), dtype=torch.float32,
                         device=p.device)
    loss = torch.zeros(steps, dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        err = fn(*(t.data_ptr() for t in (p, q, mp, vp, mq, vq, dp, dq,
                                          u_idx, i_idx, n_idx, colsum,
                                          loss)),
                 p.shape[0], q.shape[0], p.shape[1], steps, b, k, t0, lr,
                 reg, margin, float(item_nums), b1, b2, eps,
                 _stream(p.device))
    _launch_ok("cml_epoch", err)
    return loss.sum()
