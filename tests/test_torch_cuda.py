"""The port's CUDA kernels against their plain versions, on the card:
dot_scores, dot_gmax and dot_topk_scores, and the epoch kernels
bpr_epoch, gmf_epoch, mlp_epoch, rows_epoch (the social chain and LRML's
form) and cml_epoch; LightGCN's fused serving and eval against dense,
FISM's segment sums (f32 atomics) on the card against the CPU, and one
scan step of each of DiffNet, DiffNet++, LR_GCCF, WMF, DMF, SML and
EATNN, one dual step of RML_DGATs and SoHRML, and one FM and one FFM
epoch, on the card against the CPU; the popularity negatives' draw on
the card; serving's bf16 rescue against its plain version.

Marked ``cuda``: each test skips without an NVIDIA GPU.  The file imports
only torch, numpy and the port, so on the GPU machine it runs without
the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from cleverrec_tpu_torch.ops import scores as S
from cleverrec_tpu_torch.ops import train as T

pytestmark = pytest.mark.cuda

# Masked slots are the exact sentinel in both versions; elsewhere the two
# sum the same f32 products in another order.
ATOL, RTOL = 1e-4, 1e-5
# bpr_epoch: f32 atomics sum duplicate ids in a run-dependent order, and
# Adam's normalisation carries that rounding into each step.
EPOCH_ATOL, EPOCH_RTOL, EPOCH_LOSS_RTOL = 1e-5, 1e-3, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, i, d, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, d)).astype(np.float32)
    q = rng.normal(size=(i, d)).astype(np.float32)
    seen = rng.random((b, i)) < 0.2
    seen[: min(b, 2), :64] = True          # whole groups masked
    w = -(-i // 32)
    padded = np.zeros((b, w * 32), bool)
    padded[:, :i] = seen
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    bits = (padded.reshape(b, w, 32) * weights).sum(axis=2)
    bits = bits.astype(np.uint32).view(np.int32)
    bias = rng.normal(size=(i,)).astype(np.float32) if with_bias else None
    return u, q, bits, bias


def _close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    masked = want == S.NEG
    np.testing.assert_array_equal(got == S.NEG, masked)
    np.testing.assert_allclose(got[~masked], want[~masked], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("b,i,d", [(37, 5000, 16), (256, 1682, 128),
                                   (70, 100, 130), (1, 33, 1),
                                   (130, 4097, 64)])
def test_kernels_match_plain(cuda, b, i, d, with_bias):
    u, q, bits, bias = (None if x is None else torch.as_tensor(x).to(cuda)
                        for x in _inputs(b, i, d, with_bias))
    before = dict(S.launches)
    _close(S.dot_scores(u, q, bits, bias), S.dot_scores_ref(u, q, bits, bias))
    _close(S.dot_gmax(u, q, bits, bias), S.dot_gmax_ref(u, q, bits, bias))
    torch.cuda.synchronize()
    assert S.launches["dot_scores"] == before["dot_scores"] + 1
    assert S.launches["dot_gmax"] == before["dot_gmax"] + 1


def test_wrapper_rejects_bad_input(cuda):
    u, q, bits, _ = (None if x is None else torch.as_tensor(x).to(cuda)
                     for x in _inputs(4, 64, 8, False))
    with pytest.raises(TypeError):
        S.dot_scores(u.double(), q, bits)
    with pytest.raises(ValueError):
        S.dot_scores(u, q, bits[:, :1])
    with pytest.raises(ValueError):
        S.dot_scores(u.t().contiguous().t(), q, bits)


# dot_topk_scores: 1, 2 and 3 tiles of 4096 items with ragged tails, a
# single user, widths below and above one staged depth pass, and the
# serving width 128.
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("b,i,d", [(16, 200, 16), (37, 5000, 16),
                                   (8, 2 * 4096 + 100, 16), (1, 33, 1),
                                   (130, 4097, 64), (256, 1682, 128),
                                   (70, 8192, 128)])
def test_dot_topk_scores_matches_plain(cuda, b, i, d, with_bias):
    u, q, bits, bias = (None if x is None else torch.as_tensor(x).to(cuda)
                        for x in _inputs(b, i, d, with_bias))
    before = S.launches["dot_topk_scores"]
    got = S.dot_topk_scores(u, q, bits, bias)
    want = S.dot_topk_scores_ref(u, q, bits, bias)
    torch.cuda.synchronize()
    assert S.launches["dot_topk_scores"] == before + 1
    i_pad = -(-i // 4096) * 4096
    assert got[0].shape == (b, i_pad) and got[1].shape == (b, i_pad // 32)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert (got[1].view(b, -1, 128)[:, :, 32:] == S.NEG).all()


def test_dot_topk_scores_rejects_bad_input(cuda):
    u, q, bits, bias = (None if x is None else torch.as_tensor(x).to(cuda)
                        for x in _inputs(4, 64, 8, True))
    with pytest.raises(TypeError):
        S.dot_topk_scores(u, q.double(), bits)
    with pytest.raises(TypeError):
        S.dot_topk_scores(u, q, bits.long())
    with pytest.raises(ValueError):
        S.dot_topk_scores(u, q, bits[:, :1])
    with pytest.raises(ValueError):
        S.dot_topk_scores(u, q, bits, bias[:10])
    with pytest.raises(ValueError):
        S.dot_topk_scores(u, q.cpu(), bits)
    with pytest.raises(ValueError):
        S.dot_topk_scores(u, q.t().contiguous().t(), bits)


# The FP32 mainloop's edges: widths around a staged chunk (32 columns), the
# 16-byte pieces (d % 4) and the whole-depth limit (256); I % 4 != 0 and
# the 4096-item tile border; one user and user counts that fill no tile;
# 1030 users, whose 9 user blocks share the card's SMs in strips of
# several 128-item sub-tiles (the last one short).
EDGES = [(1, 33, 1), (7, 101, 3), (33, 4096, 33), (130, 4097, 130),
         (65, 1682, 256), (3, 999, 260), (129, 4096, 128), (1030, 4097, 64)]


def _edge_inputs(cuda, b, i, d, offset):
    """The inputs of ``_inputs`` on the card, bias where d is odd; with
    ``offset``, q in a contiguous view based 4 bytes past a 16-byte
    boundary (the kernels' scalar staging path)."""
    u, q, bits, bias = _inputs(b, i, d, d % 2 == 1)
    q_dev = torch.as_tensor(q).to(cuda)
    if offset:
        flat = torch.empty(q.size + 4, dtype=torch.float32, device=cuda)
        q_dev = flat[1:1 + q.size].view(q.shape)
        q_dev.copy_(torch.as_tensor(q))
        assert q_dev.is_contiguous() and q_dev.data_ptr() % 16 == 4
    u, bits = torch.as_tensor(u).to(cuda), torch.as_tensor(bits).to(cuda)
    bias = None if bias is None else torch.as_tensor(bias).to(cuda)
    assert S._aligned(u, q_dev) == (d % 4 == 0 and not offset)
    return u, q_dev, bits, bias


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("tile", range(len(S.SCORE_TILES)))
@pytest.mark.parametrize("b,i,d", EDGES)
def test_dot_scores_edges(cuda, monkeypatch, b, i, d, tile, offset):
    u, q, bits, bias = _edge_inputs(cuda, b, i, d, offset)
    monkeypatch.setattr(S, "_scores_tile", lambda b, i, sms: tile)
    before = S.launches["dot_scores"]
    got = S.dot_scores(u, q, bits, bias)
    want = S.dot_scores_ref(u, q, bits, bias)
    torch.cuda.synchronize()
    assert S.launches["dot_scores"] == before + 1
    assert got.shape == (b, i)
    _close(got, want)


@pytest.mark.parametrize("sms", [1, 7, 132, 100000])
@pytest.mark.parametrize("b,i,d", [(1030, 4097, 64), (129, 103, 3)])
def test_dot_scores_strips_follow_the_sm_count(cuda, monkeypatch, b, i, d,
                                               sms):
    """The 128 x 128 tile splits each user block's sub-tiles into strips by
    the SM count the wrapper passes: one strip of every sub-tile, strips of
    several, one sub-tile a strip."""
    u, q, bits, bias = _edge_inputs(cuda, b, i, d, False)
    monkeypatch.setattr(S, "_scores_tile", lambda b, i, sms: 0)
    monkeypatch.setattr(S, "_sms", lambda index: sms)
    got = S.dot_scores(u, q, bits, bias)
    _close(got, S.dot_scores_ref(u, q, bits, bias))


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("b,i,d", EDGES)
def test_dot_topk_scores_edges(cuda, b, i, d, offset):
    u, q, bits, bias = _edge_inputs(cuda, b, i, d, offset)
    before = S.launches["dot_topk_scores"]
    got = S.dot_topk_scores(u, q, bits, bias)
    want = S.dot_topk_scores_ref(u, q, bits, bias)
    torch.cuda.synchronize()
    assert S.launches["dot_topk_scores"] == before + 1
    _close(got[0], want[0])
    _close(got[1], want[1])


# dot_gmax at every tile it can take: 1, 37, 128 and 1,030 users; 33,
# 4,097 and 8,193 items (a ragged last group, and past two 4,096-item
# tiles); widths 1, 16, 128, 130 and 260 (past the whole-depth limit,
# where every tile runs the strip kernel).
GMAX_EDGES = [(1, 33, 1), (37, 4097, 16), (128, 8193, 128), (1030, 4097, 130),
              (37, 33, 260), (128, 4097, 1), (1, 8193, 16), (1030, 33, 128)]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("tile", range(len(S.SCORE_TILES)))
@pytest.mark.parametrize("b,i,d", GMAX_EDGES)
def test_dot_gmax_edges(cuda, monkeypatch, b, i, d, tile, offset, with_bias):
    u, q, bits, _ = _edge_inputs(cuda, b, i, d, offset)
    bias = None
    if with_bias:
        bias = torch.as_tensor(np.random.default_rng(1).normal(size=(i,))
                               .astype(np.float32)).to(cuda)
    monkeypatch.setattr(S, "_scores_tile", lambda b, i, sms: tile)
    before = S.launches["dot_gmax"]
    got = S.dot_gmax(u, q, bits, bias)
    want = S.dot_gmax_ref(u, q, bits, bias)
    torch.cuda.synchronize()
    assert S.launches["dot_gmax"] == before + 1
    assert got.shape == (b, -(-i // 32))
    assert (got[:min(b, 2), :2] == S.NEG).all()      # whole groups seen
    _close(got, want)


@pytest.mark.parametrize("sms", [1, 7, 132, 100000])
@pytest.mark.parametrize("b,i,d", [(1030, 8193, 64), (129, 103, 3)])
def test_dot_gmax_strips_follow_the_sm_count(cuda, monkeypatch, b, i, d, sms):
    """dot_gmax's 128 x 128 tile splits its strips as dot_scores' does."""
    u, q, bits, bias = _edge_inputs(cuda, b, i, d, False)
    monkeypatch.setattr(S, "_scores_tile", lambda b, i, sms: 0)
    monkeypatch.setattr(S, "_sms", lambda index: sms)
    _close(S.dot_gmax(u, q, bits, bias), S.dot_gmax_ref(u, q, bits, bias))


def _epoch_inputs(u_n, i_n, d, steps, b, t0, seed=0):
    rng = np.random.default_rng(seed)
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.15
    ids = [np.where(invalid, pad - 1, rng.integers(0, n, (steps, b)))
           .astype(np.int32) for n, pad in ((u_n, u_pad), (i_n, i_pad),
                                            (i_n, i_pad))]
    state = [rng.normal(size=(n, d)).astype(np.float32) * 0.1
             for n in (u_n, i_n)]
    for n in (u_n, u_n, i_n, i_n):
        m = rng.normal(size=(n, d)).astype(np.float32) * 1e-3
        state.append(np.zeros_like(m) if t0 == 0 else
                     (np.abs(m) * 1e-3 if len(state) % 2 else m))
    return state, ids


def _hold_bpr(cuda, state, ids, t0, offset=False):
    """One epoch through the kernel and the plain version from one state:
    one launch, the loss and every state tensor within the tolerances; no
    steps leave the state as it was and the loss 0."""
    got = _on_card(state, cuda, offset)
    want = _on_card(state, cuda, offset)
    ids = _on_card(ids, cuda)
    before = T.launches["bpr_epoch"]
    loss = T.fused_bpr_epoch(*got, *ids, t0, lr=0.01, reg=0.02)
    ref = T.fused_bpr_epoch_ref(*want, *ids, t0, lr=0.01, reg=0.02)
    torch.cuda.synchronize()
    assert T.launches["bpr_epoch"] == before + 1
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL)
    if ids[0].shape[0] == 0:
        assert float(loss) == 0.0
        for g, x in zip(got, state):
            np.testing.assert_array_equal(g.cpu().numpy(), x)


# The persistent kernel's edges: the half-warp variant (d 16, 40, 64, its
# widest), the warp (d 128), 128-column chunks walked twice (d 1024), the
# scalar variant (d 30; d 130, two chunks), larger tables (12,000 + 9,000
# rows, many Adam units a thread), no steps.
@pytest.mark.parametrize("u_n,i_n,d,steps,b,t0", [
    (37, 53, 16, 4, 64, 0), (37, 53, 16, 4, 64, 7), (29, 41, 40, 3, 37, 2),
    (943, 1682, 128, 3, 6144, 65), (12000, 9000, 128, 2, 6144, 3),
    (29, 41, 30, 3, 37, 2), (29, 41, 130, 2, 37, 1), (29, 41, 64, 3, 64, 2),
    (29, 41, 1024, 2, 64, 1), (29, 41, 16, 0, 64, 0)])
def test_bpr_epoch_matches_plain(cuda, u_n, i_n, d, steps, b, t0):
    _hold_bpr(cuda, *_epoch_inputs(u_n, i_n, d, steps, b, t0), t0)


@pytest.mark.parametrize("case", ["offset", "one_id"])
def test_bpr_epoch_offset_tables_and_contended_ids(cuda, case):
    """Tables 4 bytes off a 16-byte boundary (the scalar variant at d
    128); every real slot of a step at one user and two items, beside
    sentinel slots (the atomics all contend)."""
    state, ids = _epoch_inputs(29, 41, 128, 3, 256, 3)
    if case == "one_id":
        ids = [np.where(x == x.max(), x, 3 + k % 2)
               for k, x in enumerate(ids)]
    _hold_bpr(cuda, state, ids, 3, offset=case == "offset")


@pytest.mark.parametrize("rank", [0, 1])
def test_bpr_epoch_on_a_data_parallel_chunk(cuda, rank):
    """A rank of a 2 x 1 mesh with dp_sync_every 2 (the trainer's
    _dp_rounds): its second round, steps 2-3 of its 4-step chunk of an
    8-step epoch at ml-100k's shape, launched on views of the epoch's id
    planes (no copy) from Adam step t0 + 2, against the plain version over
    the same steps."""
    state, ids = _epoch_inputs(943, 1682, 128, 8, 6144, 65)
    epoch = _on_card(ids, cuda)
    lo = rank * 4 + 2
    chunk = [x[lo:lo + 2] for x in epoch]
    assert all(c.is_contiguous() and c.data_ptr() == x[lo:].data_ptr()
               for c, x in zip(chunk, epoch))
    got, want = _on_card(state, cuda), _on_card(state, cuda)
    before = T.launches["bpr_epoch"]
    loss = T.fused_bpr_epoch(*got, *chunk, 65 + 2, lr=0.01, reg=0.02)
    ref = T.fused_bpr_epoch_ref(*want, *[c.clone() for c in chunk], 65 + 2,
                                lr=0.01, reg=0.02)
    torch.cuda.synchronize()
    assert T.launches["bpr_epoch"] == before + 1
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL)


@pytest.mark.parametrize("u_n,i_n", [(943, 1682), (12000, 9000)])
def test_bpr_epoch_one_step_is_deterministic(cuda, u_n, i_n):
    """The loss leaves each block through its slice, summed in block
    order: one step from one state gives a bit-identical loss in two
    launches, and bit-identical m and v on every row no slot touched
    (their gradient is exactly 0; the touched rows' sums use atomics), at
    ml-100k's tables and at 12,000 + 9,000 rows.  The slots name only the
    first half of each table."""
    state, ids = _epoch_inputs(u_n, i_n, 128, 1, 6144, 65)
    sizes = (u_n, i_n, i_n)
    ids = [np.where(x < n, x % (n // 2), x).astype(np.int32)
           for x, n in zip(ids, sizes)]
    on_card = _on_card(ids, cuda)
    runs = []
    for _ in range(2):
        got = _on_card(state, cuda)
        loss = T.fused_bpr_epoch(*got, *on_card, 65, lr=0.01, reg=0.02)
        runs.append((loss, got))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    free_u = np.setdiff1d(np.arange(u_n), ids[0])
    free_i = np.setdiff1d(np.arange(i_n), np.concatenate(ids[1:]))
    assert len(free_u) >= u_n // 2 and len(free_i) >= i_n // 2
    for k, free in ((2, free_u), (3, free_u), (4, free_i), (5, free_i)):
        rows = torch.as_tensor(free, device=cuda)
        assert torch.equal(runs[0][1][k][rows], runs[1][1][k][rows]), k
        assert not torch.equal(runs[0][1][k][rows],
                               torch.as_tensor(state[k], device=cuda)[rows])


def test_bpr_epoch_raises_on_a_refused_wave(cuda, monkeypatch):
    """A plan of more blocks than the card's SMs hold at once: the
    cooperative launch is refused, the wrapper raises with the error's
    text and counts nothing, and the state is as it was (no other path
    ran)."""
    state, ids = _epoch_inputs(29, 41, 16, 2, 64, 1)
    got, ids = _on_card(state, cuda), _on_card(ids, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    monkeypatch.setattr(T, "_sms", lambda index: 4 * sms)
    before = T.launches["bpr_epoch"]
    with pytest.raises(RuntimeError, match="cooperative"):
        T.fused_bpr_epoch(*got, *ids, 1, lr=0.01, reg=0.02)
    torch.cuda.synchronize()
    assert T.launches["bpr_epoch"] == before
    for g, x in zip(got, state):
        np.testing.assert_array_equal(g.cpu().numpy(), x)


def test_bpr_epoch_rejects_bad_input(cuda):
    state, ids = _epoch_inputs(5, 7, 8, 2, 4, 0)
    state = [torch.as_tensor(x).to(cuda) for x in state]
    ids = [torch.as_tensor(x).to(cuda) for x in ids]
    with pytest.raises(TypeError):
        T.fused_bpr_epoch(*state, ids[0].long(), *ids[1:], 0, lr=0.1, reg=0)
    with pytest.raises(ValueError):
        T.fused_bpr_epoch(state[0].t().contiguous().t(), *state[1:], *ids, 0,
                          lr=0.1, reg=0)
    with pytest.raises(ValueError):
        T.fused_bpr_epoch(*state, ids[0].cpu(), *ids[1:], 0, lr=0.1, reg=0)


# gmf_epoch: as bpr_epoch, f32 atomics sum duplicate ids in a
# run-dependent order.  mlp_epoch sums every gradient in a fixed order (a
# table row's in batch order, through a CSR of the step's ids), which is
# not the plain version's: its dense params (the W_l, b_l and h) sum every
# row of a step (6144 on the main path) in the kernel's order, against
# cuBLAS's products in the plain version, and each step's Adam normalises
# that rounding into the next: their elements, and the loss, which depends
# on them, are held looser.
DENSE_ATOL, DENSE_RTOL, MLP_LOSS_RTOL = 1e-4, 1e-3, 1e-4


def _gmf_inputs(u_n, i_n, d, steps, b, t0, seed=0):
    rng = np.random.default_rng(seed)
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.15
    ids = [np.where(invalid, pad - 1, rng.integers(0, n, (steps, b)))
           .astype(np.int32) for n, pad in ((u_n, u_pad), (i_n, i_pad))]
    y = (rng.random((steps, b)) < 0.2).astype(np.float32)
    shapes = ((u_n, d), (i_n, d), (d,))
    state = [rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
    for s in shapes:
        m = rng.normal(size=s).astype(np.float32) * 1e-3
        state += [m, np.abs(m) * 1e-3] if t0 else [0 * m, 0 * m]
    return state, ids, y


def _on_card(arrays, dev, offset=False):
    """numpy arrays as tensors on the card; with ``offset`` each one a
    contiguous view 4 bytes past a 16-byte boundary (the kernels' scalar
    variant)."""
    out = []
    for x in arrays:
        t = torch.as_tensor(x)
        if offset:
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            out.append(buf[1:].view(t.shape).copy_(t))
            assert out[-1].data_ptr() % 16 != 0
        else:
            out.append(t.to(dev))
    return out


def _hold_gmf(cuda, state, ids, y, t0, offset=False):
    """One epoch through the kernel and the plain version from one state:
    one launch, the loss and every state tensor within the tolerances."""
    got = _on_card(state, cuda, offset)
    want = _on_card(state, cuda, offset)
    ids = _on_card(ids, cuda)
    y = torch.as_tensor(y).to(cuda)
    before = T.launches["gmf_epoch"]
    loss = T.fused_gmf_epoch(*got, *ids, y, t0, lr=0.01, reg=0.02)
    ref = T.fused_gmf_epoch_ref(*want, *ids, y, t0, lr=0.01, reg=0.02)
    torch.cuda.synchronize()
    assert T.launches["gmf_epoch"] == before + 1
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL)


# The persistent kernel's edges: d % 4 != 0 (18: the narrow kernel's
# scalar variant; 130, 258: the wide kernel's), d 200, 300 and 4096 (the
# wide kernel's float4 variant, 4096 its widest); B 1 (below a warp's two
# slots); 210 steps (420 grid barriers); no steps; B 0.
@pytest.mark.parametrize("u_n,i_n,d,steps,b,t0", [
    (29, 41, 16, 4, 64, 0), (29, 41, 16, 4, 64, 7), (37, 53, 40, 3, 37, 2),
    (943, 1682, 64, 3, 6144, 81), (29, 41, 18, 3, 37, 2),
    (29, 41, 130, 2, 64, 1), (29, 41, 200, 2, 64, 1), (29, 41, 16, 2, 1, 1),
    (97, 113, 16, 210, 8, 3), (29, 41, 16, 0, 64, 0), (29, 41, 16, 3, 0, 2),
    (29, 41, 258, 2, 37, 1), (29, 41, 300, 2, 64, 1),
    (29, 41, 4096, 2, 64, 1)])
def test_gmf_epoch_matches_plain(cuda, u_n, i_n, d, steps, b, t0):
    _hold_gmf(cuda, *_gmf_inputs(u_n, i_n, d, steps, b, t0), t0)


@pytest.mark.parametrize("case", ["offset", "one_id"])
def test_gmf_epoch_offset_tables_and_contended_ids(cuda, case):
    """Tables 4 bytes off a 16-byte boundary (the scalar variant at d
    16); every real slot of a step at one user and one item, beside
    sentinel slots (the atomics all contend)."""
    state, ids, y = _gmf_inputs(29, 41, 16, 3, 256, 3)
    if case == "one_id":
        ids = [np.where(x == x.max(), x, 3 + k) for k, x in enumerate(ids)]
    _hold_gmf(cuda, state, ids, y, 3, offset=case == "offset")


@pytest.mark.parametrize("d", [64, 300])
def test_gmf_epoch_one_step_is_deterministic(cuda, d):
    """dh and the loss leave each block through its slice, summed in
    block order: one step from one state gives a bit-identical loss, h
    and h's moments in two launches (the tables' row sums use atomics,
    so a second step would not); d 300 is the wide kernel's, dh in
    shared memory."""
    state, ids, y = _gmf_inputs(943, 1682, d, 1, 6144, 81)
    ids = _on_card(ids, cuda)
    y = torch.as_tensor(y).to(cuda)
    runs = []
    for _ in range(2):
        got = _on_card(state, cuda)
        loss = T.fused_gmf_epoch(*got, *ids, y, 81, lr=0.01, reg=0.02)
        runs.append((loss, got))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for k in (2, 7, 8):                       # h, mh, vh
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def test_gmf_epoch_rejects_bad_input(cuda):
    state, ids, y = _gmf_inputs(5, 7, 8, 2, 4, 0)
    state = [torch.as_tensor(x).to(cuda) for x in state]
    ids = [torch.as_tensor(x).to(cuda) for x in ids]
    y = torch.as_tensor(y).to(cuda)
    with pytest.raises(TypeError):
        T.fused_gmf_epoch(*state, *ids, y.double(), 0, lr=0.1, reg=0)
    with pytest.raises(ValueError):
        T.fused_gmf_epoch(state[0].t().contiguous().t(), *state[1:], *ids, y,
                          0, lr=0.1, reg=0)
    with pytest.raises(ValueError):
        T.fused_gmf_epoch(*state, ids[0].cpu(), ids[1], y, 0, lr=0.1, reg=0)
    wide = [torch.zeros(s, device=cuda) for s in ((5, 5000), (7, 5000),
                                                  (5000,))]
    with pytest.raises(ValueError, match="4096"):
        T.fused_gmf_epoch(*wide, *(torch.zeros_like(x) for x in wide
                                   for _ in range(2)), *ids, y, 0, lr=0.1,
                          reg=0)


def _mlp_inputs(name, u_n, i_n, embed, layers, steps, b, t0, seed=0):
    """A port model's spec and one state of it on the card, one epoch in
    (moments nonzero) unless t0 is 0, and a sampled epoch."""
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    cfg = Config({"recommender": name, "embed_size": str(embed),
                  "layers": str(layers).replace(" ", ""), "reg": "0.01",
                  "reg1": "0.01", "reg2": "0.02", "stddev": "0.1",
                  "seed": str(seed)})
    model = make_model(cfg, DataMeta(u_n, i_n), device="cpu")
    spec = model.fused_mlp_spec()
    p = {n: x.detach() for n, x in model.named_parameters()}
    rng = np.random.default_rng(seed)

    def moment(x, scale):
        m = torch.as_tensor(rng.normal(size=tuple(x.shape))
                            .astype(np.float32)) * scale
        return m.abs() * 1e-3 if scale < 1e-3 else m

    groups = []
    for scale in (None, 1e-3, 1e-4):
        t = {n: (x if scale is None else
                 moment(x, scale) if t0 else torch.zeros_like(x))
             for n, x in p.items()}
        groups += [torch.cat([t[n] for n in spec["u"]], 1),
                   torch.cat([t[n] for n in spec["i"]], 1),
                   [t[n] for n in spec["dense"]]]
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.15
    cols = [np.where(invalid, pad - 1, rng.integers(0, n, (steps, b)))
            .astype(np.int32) for n, pad in ((u_n, u_pad), (i_n, i_pad))]
    cols += [(rng.random((steps, b)) < 0.2).astype(np.float32),
             (~invalid).astype(np.float32)]
    return spec, groups, cols


def _to(groups, dev):
    return [[x.to(dev) for x in g] if isinstance(g, list) else g.to(dev)
            for g in groups]


@pytest.mark.parametrize("name,u_n,i_n,embed,layers,steps,b,t0", [
    ("MLP", 23, 31, 8, [16, 8], 3, 64, 0),
    ("NeuMF", 23, 31, 8, [16, 8], 3, 64, 5),
    ("NeuMF", 29, 41, 5, [24, 12, 6], 3, 37, 2),
    ("MLP", 29, 41, 8, [64, 32, 16, 8], 2, 100, 3),
    ("MLP", 943, 1682, 64, [128, 64, 32], 3, 6144, 81),
    ("NeuMF", 943, 1682, 64, [128, 64, 32], 3, 6144, 81),
    # The row tile's edges: one row, one short of a 48-row tile's wave, one
    # past a wave of 48-row tiles (129 blocks); one layer and four.
    ("NeuMF", 29, 41, 8, [16, 8], 2, 1, 1),
    ("MLP", 29, 41, 8, [16, 8], 2, 47, 3),
    ("NeuMF", 943, 1682, 64, [128, 64, 32], 2, 6145, 81),
    ("NeuMF", 29, 41, 8, [8], 3, 64, 2),
    ("NeuMF", 29, 41, 8, [64, 32, 16, 8], 2, 100, 3)])
def test_mlp_epoch_matches_plain(cuda, name, u_n, i_n, embed, layers, steps,
                                 b, t0):
    spec, groups, cols = _mlp_inputs(name, u_n, i_n, embed, layers, steps,
                                     b, t0)
    got, want = _to(groups, cuda), _to(groups, cuda)
    cols = [torch.as_tensor(x).to(cuda) for x in cols]
    before = T.launches["mlp_epoch"]
    loss = T.fused_mlp_epoch(*got, *cols, t0, spec=spec, lr=0.01)
    ref = T.fused_mlp_epoch_ref(*want, *cols, t0, row_loss=spec["row_loss"],
                                lr=0.01)
    torch.cuda.synchronize()
    assert T.launches["mlp_epoch"] == before + 1
    assert float(loss) == pytest.approx(float(ref), rel=MLP_LOSS_RTOL)
    for k in range(3):
        for g, w in zip(got[3 * k:3 * k + 2], want[3 * k:3 * k + 2]):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=EPOCH_RTOL, atol=EPOCH_ATOL)
        for n, g, w in zip(spec["dense"], got[3 * k + 2], want[3 * k + 2]):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=DENSE_RTOL, atol=DENSE_ATOL,
                                       err_msg=n)


@pytest.mark.parametrize("name", ["MLP", "NeuMF"])
def test_mlp_epoch_dense_step_is_deterministic(cuda, name):
    """The blocks' dense gradients are summed in a fixed order, with no
    atomics: one step from one state gives bit-identical W_l, b_l, h and
    their moments in two launches."""
    spec, groups, cols = _mlp_inputs(name, 943, 1682, 64, [128, 64, 32], 1,
                                     6144, 81)
    cols = [torch.as_tensor(x).to(cuda) for x in cols]
    runs = []
    for _ in range(2):
        state = _to(groups, cuda)
        T.fused_mlp_epoch(*state, *cols, 81, spec=spec, lr=0.01)
        runs.append(state)
    torch.cuda.synchronize()
    for k in range(3):
        for n, a, b in zip(spec["dense"], runs[0][3 * k + 2],
                           runs[1][3 * k + 2]):
            assert torch.equal(a, b), n


@pytest.mark.parametrize("name", ["MLP", "NeuMF"])
def test_mlp_epoch_is_deterministic(cuda, name):
    """No sum depends on the order in which the card runs the blocks: a
    4-step epoch from one state gives bit-identical tables, dense params,
    moments and loss in two launches (each step's row grads feed the next
    step's products, so one step would not show it)."""
    spec, groups, cols = _mlp_inputs(name, 943, 1682, 64, [128, 64, 32], 4,
                                     6144, 81)
    cols = [torch.as_tensor(x).to(cuda) for x in cols]
    runs, losses = [], []
    for _ in range(2):
        state = _to(groups, cuda)
        losses.append(T.fused_mlp_epoch(*state, *cols, 81, spec=spec,
                                        lr=0.01))
        runs.append(state)
    torch.cuda.synchronize()
    assert torch.equal(losses[0], losses[1])
    for k in range(3):
        for a, b in zip(runs[0][3 * k:3 * k + 2], runs[1][3 * k:3 * k + 2]):
            assert torch.equal(a, b)
        for n, a, b in zip(spec["dense"], runs[0][3 * k + 2],
                           runs[1][3 * k + 2]):
            assert torch.equal(a, b), n


def test_mlp_epoch_rejects_bad_input(cuda):
    spec, groups, cols = _mlp_inputs("NeuMF", 5, 7, 4, [8, 4], 2, 4, 0)
    groups = _to(groups, cuda)
    cols = [torch.as_tensor(x).to(cuda) for x in cols]
    with pytest.raises(TypeError):
        T.fused_mlp_epoch(*groups, cols[0].long(), *cols[1:], 0, spec=spec,
                          lr=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        T.fused_mlp_epoch(groups[0].t().contiguous().t(), *groups[1:], *cols,
                          0, spec=spec, lr=0.1)
    with pytest.raises(ValueError, match="one device"):
        T.fused_mlp_epoch(*groups, cols[0].cpu(), *cols[1:], 0, spec=spec,
                          lr=0.1)
    # Shapes the kernel does not take: five layers, a tower whose weights
    # outgrow a block's shared memory.
    for layers, embed in (([64, 32, 16, 8, 4], 4), ([1024, 512], 4)):
        spec, groups, cols = _mlp_inputs("MLP", 5, 7, embed, layers, 2, 4, 0)
        before = T.launches["mlp_epoch"]
        with pytest.raises(ValueError, match="layers|shared memory"):
            T.fused_mlp_epoch(*_to(groups, cuda),
                              *(torch.as_tensor(x).to(cuda) for x in cols),
                              0, spec=spec, lr=0.1)
        assert T.launches["mlp_epoch"] == before


# rows_epoch: as bpr_epoch, f32 atomics sum duplicate ids in a
# run-dependent order, and Adam normalises that rounding into each next
# step; CUNE_BPR's s sums its blocks' slices in a fixed order.  The cases:
# d a multiple of 4 (float4 rows) and not (18: the scalar variant); one
# row; one row past a block of 16 (the chain's tile).
ROWS_CASES = [(29, 41, 16, 4, 64, 0, 0.5), (37, 53, 40, 3, 37, 5, 0.5),
              (943, 1682, 128, 3, 6144, 81, 0.15),
              (29, 41, 18, 3, 64, 2, 0.3), (29, 41, 16, 2, 1, 1, 0.0),
              (29, 41, 16, 2, 17, 1, 0.0)]


def _rows_model(name, u_n, i_n, d, seed=0):
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    cfg = Config({"recommender": name, "embed_size": str(d), "reg": "0.05",
                  "stddev": "0.1", "seed": str(seed), "walk_count": "1",
                  "walk_length": "2", "walk_dim": "4", "window_size": "1",
                  "topk_f": "2"})
    return make_model(cfg, DataMeta(u_n, i_n), device="cpu")


def _rows_inputs(name, u_n, i_n, d, steps, b, t0, masked, seed=0):
    """A social model's spec, one state of it (bias and s moved off zero,
    moments nonzero unless t0 is 0) and a sampled epoch: a share
    ``masked`` of rows at the sentinels and the first step all masked."""
    model = _rows_model(name, u_n, i_n, d, seed)
    spec = model.fused_rows_spec()
    rng = np.random.default_rng(seed)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    params["bias"] = torch.as_tensor(
        rng.normal(size=i_n + 1).astype(np.float32)) * 0.3
    if "s" in params:
        params["s"] = torch.tensor(0.4)

    def moment(x, scale):
        if not t0:
            return torch.zeros_like(x)
        m = torch.as_tensor(rng.normal(size=tuple(x.shape))
                            .astype(np.float32)) * scale
        return m.abs() * 1e-3 if scale < 1e-3 else m

    state = [params] + [{n: moment(x, scale) for n, x in params.items()}
                        for scale in (1e-3, 1e-4)]
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < masked
    invalid[0] = True
    planes = [np.where(invalid, (u_pad if sd == "u" else i_pad) - 1,
                       rng.integers(0, u_n if sd == "u" else i_n,
                                    (steps, b))).astype(np.int32)
              for _, sd in spec["planes"]]
    floats = [rng.integers(0, 5, (steps, b)).astype(np.float32)
              for _ in spec["floats"]]
    return spec, state, planes, floats


def _rows_state(spec, state, dev):
    return [x for t in state
            for x in spec["pack"]({n: v.to(dev) for n, v in t.items()})]


def _hold_rows(cuda, kernel, spec, state, planes, floats, t0):
    """One epoch through the kernel and the plain version from one state:
    one launch, the loss and every state tensor within the tolerances."""
    got, want = _rows_state(spec, state, cuda), _rows_state(spec, state, cuda)
    planes = [torch.as_tensor(x).to(cuda) for x in planes]
    floats = [torch.as_tensor(x).to(cuda) for x in floats]
    sides = [sd for _, sd in spec["planes"]]
    before = dict(T.launches)
    loss = T.fused_rows_epoch(*got, planes, floats, t0, sides=sides,
                              spec=spec, lr=0.01)
    ref = T.fused_rows_epoch_ref(*want, planes, floats, t0, sides=sides,
                                 row_loss=spec["row_loss"], lr=0.01)
    torch.cuda.synchronize()
    assert T.launches == {**before, kernel: before[kernel] + 1}
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for k, (g_side, w_side) in enumerate(zip(got, want)):
        for g, w in zip(g_side, w_side):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                       err_msg=f"part {k}")


def _one_id(planes):
    """Every row of every step at one id, a different one in each plane:
    the atomics all contend."""
    return [np.full_like(x, 3 + k) for k, x in enumerate(planes)]


@pytest.mark.parametrize("name", ["SBPR", "TBPR", "CUNE_BPR"])
@pytest.mark.parametrize("distinct", [False, True])
def test_rows_epoch_contended_ids(cuda, name, distinct):
    spec, state, planes, floats = _rows_inputs(name, 29, 41, 16, 2, 256, 3,
                                               0.0)
    same = _one_id(planes)
    planes = same if distinct else [same[0]] + [same[1]] * (len(same) - 1)
    _hold_rows(cuda, "rows_epoch", spec, state, planes, floats, 3)


@pytest.mark.parametrize("name", ["SBPR", "CUNE_BPR"])
def test_rows_epoch_one_step_is_deterministic(cuda, name):
    """The loss and ds leave each block through its slice, summed in
    block order: one step from one state gives a bit-identical loss and
    s and its moments in two launches (the tables' row sums use atomics,
    so a second step would not)."""
    spec, state, planes, floats = _rows_inputs(name, 943, 1682, 128, 2,
                                               6144, 81, 0.15)
    # Step 1 of the draw alone (step 0 is all masked).
    planes = [torch.as_tensor(x[1:]).to(cuda) for x in planes]
    floats = [torch.as_tensor(x[1:]).to(cuda) for x in floats]
    sides = [sd for _, sd in spec["planes"]]
    runs = []
    for _ in range(2):
        got = _rows_state(spec, state, cuda)
        loss = T.fused_rows_epoch(*got, planes, floats, 81, sides=sides,
                                  spec=spec, lr=0.01)
        runs.append((loss, got))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for k in (2, 5, 8):                       # the dense group: s, m_s, v_s
        for a, b in zip(runs[0][1][k], runs[1][1][k]):
            assert torch.equal(a, b), k


@pytest.mark.parametrize("u_n,i_n,d,steps,b,t0,masked", ROWS_CASES)
@pytest.mark.parametrize("name", ["SBPR", "TBPR", "CUNE_BPR"])
def test_rows_epoch_matches_plain(cuda, name, u_n, i_n, d, steps, b, t0,
                                  masked):
    spec, state, planes, floats = _rows_inputs(name, u_n, i_n, d, steps, b,
                                               t0, masked)
    _hold_rows(cuda, "rows_epoch", spec, state, planes, floats, t0)


def test_rows_epoch_declines_what_it_has_no_backward_for(cuda):
    spec, state, planes, floats = _rows_inputs("SBPR", 5, 7, 8, 2, 4, 0, 0.0)
    args = (_rows_state(spec, state, cuda),
            [torch.as_tensor(x).to(cuda) for x in planes],
            [torch.as_tensor(x).to(cuda) for x in floats])
    sides = [sd for _, sd in spec["planes"]]
    before = T.launches["rows_epoch"]
    with pytest.raises(ValueError, match="chain"):
        T.fused_rows_epoch(*args[0], *args[1:], 0, sides=sides,
                           spec={**spec, "chain": None}, lr=0.1)
    packed = [(x[0],) if k % 3 == 1 else x for k, x in enumerate(args[0])]
    with pytest.raises(ValueError, match="kernel takes"):
        T.fused_rows_epoch(*packed, *args[1:], 0, sides=sides, spec=spec,
                           lr=0.1)
    with pytest.raises(ValueError, match="one device"):
        T.fused_rows_epoch(*args[0], [args[1][0].cpu()] + args[1][1:],
                           args[2], 0, sides=sides, spec=spec, lr=0.1)
    assert T.launches["rows_epoch"] == before


def test_fused_stream_launches_the_same_kernel(cuda, tmp_path):
    """train.fused_stream=True trains SBPR through rows_epoch, as the
    default fused tier does."""
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.data import load_ranking_data
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.train import Trainer
    rng = np.random.default_rng(0)
    ds = tmp_path / "toy"
    ds.mkdir()
    pairs = {(int(u), int(i)) for u, i in zip(rng.integers(0, 30, 500),
                                              rng.integers(0, 40, 500))}
    (ds / "ratings.csv").write_text("u_id,i_id,rating,time\n" + "".join(
        f"{u},{i},5,{t}\n" for t, (u, i) in enumerate(sorted(pairs))))
    (ds / "trusts.csv").write_text("u_id,v_id\n" + "".join(
        f"{u},{v}\n" for u in range(30) for v in rng.choice(30, 3)
        if v != u))
    assert T.fused_rows_epoch_stream is T.fused_rows_epoch
    for stream in ("False", "True"):
        cfg = Config({"recommender": "SBPR", "data.root_dir": str(tmp_path),
                      "data.dataset": "toy", "data.file_name": "ratings.csv",
                      "data.format": "UIRT", "social_file": "trusts.csv",
                      "embed_size": "16", "reg": "0.05", "batch_size": "64",
                      "neg_ratio": "2", "lr": "0.01", "optimizer": "Adam",
                      "topk": "[5]", "test.neg_samples": "10",
                      "train.fused_stream": stream})
        data = load_ranking_data(cfg)
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums))
        tr = Trainer(model, data, cfg)
        assert tr.fused
        params, state = tr.init_state()
        before = T.launches["rows_epoch"]
        tr.train_epochs(params, state, 2)
        assert T.launches["rows_epoch"] == before + 2


# cml_epoch: as bpr_epoch, f32 atomics sum duplicate ids (and the
# regulariser's column sums) in a run-dependent order.  Both versions sum
# the distances in one order, so they pick the same negatives, exact ties
# (duplicate ids, identical rows) to the lowest item id.
# The persistent kernel's edges: d % 4 != 0 (18: the scalar variant);
# d 200 (two passes of float4 columns); K 30 (two chunks of candidates);
# B 1 (below a warp's row); 210 steps (420 grid barriers); no steps; B 0;
# d 3600 and 3601 (past shared memory: the warps' column sums in global
# memory, float4 and scalar).
CML_CASES = [(29, 41, 16, 4, 4, 64, 0), (37, 53, 40, 5, 3, 37, 7),
             (943, 1682, 128, 20, 3, 6144, 17), (29, 41, 18, 4, 3, 37, 2),
             (29, 41, 200, 5, 2, 64, 1), (29, 41, 16, 30, 2, 64, 1),
             (29, 41, 16, 4, 2, 1, 1), (97, 997, 16, 4, 210, 4, 3),
             (29, 41, 16, 4, 0, 64, 0), (29, 41, 16, 4, 3, 0, 2),
             (29, 41, 3600, 4, 2, 37, 1), (29, 41, 3601, 4, 2, 37, 1)]


def _cml_inputs(u_n, i_n, d, k, steps, b, t0, seed=0):
    rng = np.random.default_rng(seed)
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.15
    invalid[:1, :3] = True
    negs = rng.integers(0, i_n, (steps, b, k))
    negs[:, :, 1] = negs[:, :, 0]                  # a duplicated negative
    negs[:, :, 2], negs[:, :, 3] = 2, 1            # two items of one row
    u = np.where(invalid, u_pad - 1, rng.integers(0, u_n, (steps, b)))
    i = np.where(invalid, i_pad - 1, rng.integers(0, i_n, (steps, b)))
    negs = np.where(invalid[..., None], i_pad - 1, negs)
    p = rng.normal(size=(u_n, d)).astype(np.float32) * 0.1
    q = rng.normal(size=(i_n, d)).astype(np.float32) * 0.1
    q[1] = q[2]                                    # exactly tied items
    state = [p, q]
    for n in (u_n, u_n, i_n, i_n):
        m = rng.normal(size=(n, d)).astype(np.float32) * 1e-3
        state.append(np.zeros_like(m) if t0 == 0 else
                     (np.abs(m) * 1e-3 if len(state) % 2 else m))
    ids = [x.astype(np.int32) for x in (u, i, negs)]
    return state, ids


def _hold_cml(cuda, state, ids, t0, i_n, offset=False):
    """One epoch through the kernel and the plain version from one state:
    one launch, the loss and every state tensor within the tolerances."""
    got = _on_card(state, cuda, offset)
    want = _on_card(state, cuda, offset)
    ids = _on_card(ids, cuda)
    opts = dict(lr=0.01, reg=10.0, margin=1.0, item_nums=i_n)
    before = T.launches["cml_epoch"]
    loss = T.fused_cml_epoch(*got, *ids, t0, **opts)
    ref = T.fused_cml_epoch_ref(*want, *ids, t0, **opts)
    torch.cuda.synchronize()
    assert T.launches["cml_epoch"] == before + 1
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL)


@pytest.mark.parametrize("u_n,i_n,d,k,steps,b,t0", CML_CASES)
def test_cml_epoch_matches_plain(cuda, u_n, i_n, d, k, steps, b, t0):
    _hold_cml(cuda, *_cml_inputs(u_n, i_n, d, k, steps, b, t0), t0, i_n)


@pytest.mark.parametrize("case", ["offset", "one_id"])
def test_cml_epoch_offset_tables_and_contended_ids(cuda, case):
    """Tables 4 bytes off a 16-byte boundary (the scalar variant at d
    16, its distances in the scalar order); every real row of a step at
    one user and one item, the negatives at two items, beside sentinel
    rows (the atomics all contend)."""
    state, ids = _cml_inputs(29, 41, 16, 4, 3, 256, 3)
    if case == "one_id":
        u, i, negs = ids
        sent = i.max()
        ids = [np.where(u == u.max(), u, 3), np.where(i == sent, i, 5),
               np.where(negs == sent, negs, 7 + np.arange(4) % 2)
               .astype(np.int32)]
    _hold_cml(cuda, state, ids, 3, 41, offset=case == "offset")


def test_cml_epoch_column_sums_are_deterministic(cuda):
    """The column sums of concat(Q, P) come from one block a piece of
    columns in a fixed order: with no rows (B 0) nothing else moves the
    state, so five steps of the regulariser and Adam give bit-identical
    state and loss in two launches; and one step at the conf's shape (the
    rows' loss through the blocks' slices) a bit-identical loss; at d
    3600 the warps' column sums are in global memory."""
    opts = dict(lr=0.01, reg=10.0, margin=1.0, item_nums=1682)
    for shape, whole in (((943, 1682, 128, 20, 5, 0, 17), True),
                         ((943, 1682, 128, 20, 1, 6144, 17), False),
                         ((97, 113, 3600, 4, 3, 0, 17), True)):
        state, ids = _cml_inputs(*shape)
        ids = _on_card(ids, cuda)
        runs = []
        for _ in range(2):
            got = _on_card(state, cuda)
            runs.append((T.fused_cml_epoch(*got, *ids, 17, **opts), got))
        torch.cuda.synchronize()
        assert torch.equal(runs[0][0], runs[1][0]), shape
        if whole:
            for a, b in zip(runs[0][1], runs[1][1]):
                assert torch.equal(a, b)


def test_cml_epoch_raises_on_bad_input(cuda):
    state, ids = _cml_inputs(5, 7, 8, 4, 2, 4, 0)
    state = [torch.as_tensor(x).to(cuda) for x in state]
    ids = [torch.as_tensor(x).to(cuda) for x in ids]
    opts = dict(lr=0.1, reg=1.0, margin=1.0, item_nums=7)
    before = T.launches["cml_epoch"]
    with pytest.raises(TypeError):
        T.fused_cml_epoch(*state, *ids[:2], ids[2].long(), 0, **opts)
    with pytest.raises(ValueError, match="contiguous"):
        T.fused_cml_epoch(state[0].t().contiguous().t(), *state[1:], *ids, 0,
                          **opts)
    with pytest.raises(ValueError, match="one device"):
        T.fused_cml_epoch(*state, *ids[:2], ids[2].cpu(), 0, **opts)
    with pytest.raises(ValueError, match="negatives"):
        T.fused_cml_epoch(*state, *ids[:2], ids[2][:, :3], 0, **opts)
    assert T.launches["cml_epoch"] == before


def _lrml_inputs(u_n, i_n, d, mem, steps, b, t0, masked, seed=0,
                 margin=0.2):
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    cfg = Config({"recommender": "LRML", "embed_size": str(d),
                  "mem_size": str(mem), "reg": "0.001",
                  "margin": str(margin),
                  "loss_func": "hinge", "stddev": "0.1",
                  "seed": str(seed)})
    model = make_model(cfg, DataMeta(u_n, i_n), device="cpu")
    spec = model.fused_rows_spec()
    rng = np.random.default_rng(seed)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}

    def moment(x, scale):
        if not t0:
            return torch.zeros_like(x)
        m = torch.as_tensor(rng.normal(size=tuple(x.shape))
                            .astype(np.float32)) * scale
        return m.abs() * 1e-3 if scale < 1e-3 else m

    state = [params] + [{n: moment(x, scale) for n, x in params.items()}
                        for scale in (1e-3, 1e-4)]
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < masked
    invalid[0] = True
    planes = [np.where(invalid, (u_pad if sd == "u" else i_pad) - 1,
                       rng.integers(0, u_n if sd == "u" else i_n,
                                    (steps, b))).astype(np.int32)
              for _, sd in spec["planes"]]
    return spec, state, planes


# LRML's form: K and M sum a tile's rows in register-tiled products and
# the blocks' slices in a fixed order, against autograd's products in the
# plain version; the rows' grads use f32 atomics, and Adam normalises that
# rounding into each step.  The cases: mem a multiple of 4 and not (6, 7,
# 50 at d 18: the scalar variant); one row; one row past a tile of 2 (the
# plan's tile at 3 rows); one row past a wave of 24-row tiles.
@pytest.mark.parametrize("u_n,i_n,d,mem,steps,b,t0,masked", [
    (29, 41, 16, 6, 4, 64, 0, 0.5), (37, 53, 40, 7, 3, 37, 5, 0.3),
    (943, 1682, 128, 50, 3, 6144, 17, 0.1),
    (29, 41, 18, 50, 3, 64, 2, 0.3), (29, 41, 16, 6, 2, 1, 1, 0.0),
    (29, 41, 16, 6, 2, 3, 1, 0.0), (943, 1682, 128, 50, 2, 6145, 17, 0.1)])
def test_rows_epoch_lrml_matches_plain(cuda, u_n, i_n, d, mem, steps, b, t0,
                                       masked):
    spec, state, planes = _lrml_inputs(u_n, i_n, d, mem, steps, b, t0,
                                       masked)
    assert T.rows_epoch_plan(spec)["form"] == "lrml"
    _hold_rows(cuda, "rows_epoch_lrml", spec, state, planes, [], t0)


@pytest.mark.parametrize("d,mem,b,sms", [(16, 6, 600, 1),
                                         (128, 50, 2000, 7)])
def test_rows_epoch_lrml_blocks_loop_over_tiles(cuda, monkeypatch, d, mem, b,
                                                sms):
    """Fewer SMs than tiles: each block sums several tiles' dK and dM."""
    monkeypatch.setattr(T, "_sms", lambda index: sms)
    assert T.lrml_plan(d, mem, b, sms)["tiles"] > sms
    spec, state, planes = _lrml_inputs(29, 41, d, mem, 2, b, 3, 0.2)
    _hold_rows(cuda, "rows_epoch_lrml", spec, state, planes, [], 3)


def _lrml_z(spec, state, planes, margin):
    """dist_i - dist_j + margin of every row of the draw's step 0, from
    the plain model's distance at ``state``."""
    from cleverrec_tpu_torch.models.metric import LRML
    p = state[0]
    u, i, j = (torch.as_tensor(x[0]).long() for x in planes)
    dist = [LRML._dist(p["P"][u], p["Q"][x], p["K"], p["M"]) for x in (i, j)]
    return dist[0] - dist[1] + margin


@pytest.mark.parametrize("case", ["none", "one"])
def test_rows_epoch_lrml_hinge_edges(cuda, case):
    """Every hinge inactive (margin -10: only the reg grads remain), and a
    tile with a single active row (margin 0, every other row with i = j,
    so z = 0 exactly)."""
    margin = -10.0 if case == "none" else 0.0
    spec, state, planes = _lrml_inputs(29, 41, 16, 6, 2, 37, 1, 0.0,
                                       margin=margin)
    planes = [x[1:].copy() for x in planes]           # step 0 is masked
    if case == "one":
        planes[2][0] = planes[1][0]
        planes[2][0, 5] = (planes[1][0, 5] + 1) % 41
        if _lrml_z(spec, state, planes, margin)[5] < 0:
            planes[1][0, 5], planes[2][0, 5] = planes[2][0, 5], planes[1][0, 5]
    z = _lrml_z(spec, state, planes, margin)
    assert int((z > 0).sum()) == (0 if case == "none" else 1)
    _hold_rows(cuda, "rows_epoch_lrml", spec, state, planes, [], 1)


def test_rows_epoch_lrml_contended_ids(cuda):
    spec, state, planes = _lrml_inputs(29, 41, 16, 6, 2, 256, 3, 0.0)
    _hold_rows(cuda, "rows_epoch_lrml", spec, state, _one_id(planes), [], 3)


def test_rows_epoch_lrml_one_step_is_deterministic(cuda):
    """dK, dM and the loss leave each block through its slice, summed in
    block order: one step from one state gives bit-identical K, M, their
    moments and loss in two launches (the rows' grads use atomics, so a
    second step would not)."""
    spec, state, planes = _lrml_inputs(943, 1682, 128, 50, 2, 6144, 17, 0.1)
    planes = [torch.as_tensor(x[1:]).to(cuda) for x in planes]
    sides = [sd for _, sd in spec["planes"]]
    runs = []
    for _ in range(2):
        got = _rows_state(spec, state, cuda)
        loss = T.fused_rows_epoch(*got, planes, [], 17, sides=sides,
                                  spec=spec, lr=0.01)
        runs.append((loss, got))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for k in (2, 5, 8):                       # K, M and their moments
        for a, b in zip(runs[0][1][k], runs[1][1][k]):
            assert torch.equal(a, b), k


def test_rows_epoch_lrml_raises_on_bad_input(cuda):
    spec, state, planes = _lrml_inputs(5, 7, 8, 3, 2, 4, 0, 0.0)
    packed = _rows_state(spec, state, cuda)
    planes = [torch.as_tensor(x).to(cuda) for x in planes]
    sides = [sd for _, sd in spec["planes"]]
    before = T.launches["rows_epoch_lrml"]
    wrong = [(x[1], x[0]) if k % 3 == 2 else x for k, x in enumerate(packed)]
    with pytest.raises(ValueError, match="LRML's form takes"):
        T.fused_rows_epoch(*wrong, planes, [], 0, sides=sides, spec=spec,
                           lr=0.1)
    with pytest.raises(ValueError, match="hinge"):
        T.fused_rows_epoch(*packed, planes, [], 0, sides=sides, lr=0.1,
                           spec={**spec, "lrml": {**spec["lrml"],
                                                  "loss": "bpr"}})
    with pytest.raises(ValueError, match="one device"):
        T.fused_rows_epoch(*packed, [planes[0].cpu()] + planes[1:], [], 0,
                           sides=sides, spec=spec, lr=0.1)
    assert T.launches["rows_epoch_lrml"] == before


def _ratings(path, n_users, n_items, n_rows, seed=3):
    """A random ratings file (UIRT with a header) in ``path/toy``; returns
    the config keys that load it."""
    rng = np.random.default_rng(seed)
    (path / "toy").mkdir()
    pairs = set(zip(rng.integers(0, n_users, n_rows).tolist(),
                    rng.integers(0, n_items, n_rows).tolist()))
    lines = ["u_id,i_id,rating,time"] + [f"{u},{i},5,{t}" for t, (u, i)
                                         in enumerate(sorted(pairs))]
    (path / "toy" / "ratings.csv").write_text("\n".join(lines) + "\n")
    return {"data.root_dir": str(path), "data.dataset": "toy",
            "data.file_name": "ratings.csv", "data.sep": ","}


def test_lightgcn_fused_serving_equals_dense(cuda, tmp_path):
    """LightGCN at d = 64 on a 1,500-item random split: ``auto`` serving
    picks ``fused`` and launches ``dot_scores`` on the propagated item
    rows (a row slice of the [U + I, d] matrix), and its answers equal
    ``dense``'s up to near-tied scores; the ``full_fused`` eval equals
    ``full``."""
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
    from cleverrec_tpu_torch.evalx import Evaluator
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.serving import build_retrieval_fn
    cfg = Config({"recommender": "LightGCN", "data.split_way": "rs",
                  "test.neg_samples": "0", "topk": "[10]",
                  "embed_size": "64", "n_layers": "3", "reg": "0.0001",
                  "init_method": "normal", "stddev": "0.1", "seed": "5",
                  **_ratings(tmp_path, 400, 1500, 30000)})
    data = load_ranking_data(cfg)
    dd = build_device_data(data)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device=cuda)
    aux = {k: torch.as_tensor(v, device=cuda)
           for k, v in model.build_aux(dd, data).items()}
    u = torch.arange(256, device=cuda)
    _, table, _ = model.dot_decomposition(u, aux)
    assert table.storage_offset() == data.user_nums * 64
    fused = build_retrieval_fn(model, aux, dd, k=10, backend="auto",
                               device=cuda)
    dense = build_retrieval_fn(model, aux, dd, k=10, backend="dense",
                               device=cuda)
    assert fused.backend == "fused"
    before = S.launches["dot_scores"]
    got, want = fused(u), dense(u)
    torch.cuda.synchronize()
    assert S.launches["dot_scores"] == before + 1
    (gi, gv), (wi, wv) = [(i.cpu().numpy(), v.cpu().numpy())
                          for i, v in (got, want)]
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
    tol = 1e-4 * np.abs(wv).max()
    for r, j in zip(*np.nonzero(gi != wi)):
        assert (np.abs(np.delete(gv[r], j) - gv[r, j]) <= tol).any()
    ev_fused = Evaluator(model, dd, cfg, device=cuda)
    ev_full = Evaluator(model, dd, cfg.with_overrides(
        **{"eval.fused_kernel": "False"}), device=cuda)
    assert (ev_fused.mode, ev_full.mode) == ("full_fused", "full")
    a, b = ev_fused.evaluate(aux), ev_full.evaluate(aux)
    np.testing.assert_allclose(a[10], b[10], rtol=0, atol=1e-6)


def test_fism_segment_sums_on_the_card_match_the_cpu(cuda, tmp_path):
    """FISM's user vectors (a segment sum over all pairs, ``index_add``
    with f32 atomics on the card) and one step's loss and gradients (the
    sum's backward, ``embedding``'s), from one state and one batch at
    the conf's widths, on the card and on the CPU: within
    1e-5 + 1e-3 |x|, the loss within 1e-5."""
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.data import load_ranking_data
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.train import Trainer
    cfg = Config({"recommender": "FISM", "embed_size": "128",
                  "alpha": "0.4", "reg": "0.001", "reg_bias": "0.001",
                  "lr": "0.001", "neg_ratio": "4", "batch_size": "6144",
                  "optimizer": "Adam", "is_pairwise": "True",
                  "loss_func": "bpr", "init_method": "xavier", "seed": "2",
                  **_ratings(tmp_path, 900, 1600, 60000)})
    data = load_ranking_data(cfg)
    runs, batch = [], None
    for device in ("cpu", cuda):
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                           device=device)
        tr = Trainer(model, data, cfg, device=device)
        tr.init_state()
        if batch is None:
            batch = {k: v[0] for k, v in tr.sample_epoch().items()}
        with torch.no_grad():
            users = model._user_repr(tr.aux, torch.arange(
                data.user_nums, device=device))
        loss = model.loss({k: v.to(device) for k, v in batch.items()},
                          tr.aux)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs.append((users, loss.detach(), grads))
    (u_cpu, l_cpu, g_cpu), (u_gpu, l_gpu, g_gpu) = runs
    assert float(l_gpu) == pytest.approx(float(l_cpu), rel=1e-5)
    for a, b in zip((u_gpu, *g_gpu), (u_cpu, *g_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_dot_scores_at_lr_gccf_width(cuda, with_bias):
    """dot_scores at LR_GCCF's serving shape: 256 users against 1,682
    items at d 256 (four layers of 64 concatenated)."""
    u, q, bits, bias = (None if x is None else torch.as_tensor(x).to(cuda)
                        for x in _inputs(256, 1682, 256, with_bias))
    before = S.launches["dot_scores"]
    _close(S.dot_scores(u, q, bits, bias), S.dot_scores_ref(u, q, bits, bias))
    torch.cuda.synchronize()
    assert S.launches["dot_scores"] == before + 1


SOCIAL_MODELS = ("DiffNet", "DiffNetPlusPlus", "EATNN")


def _trusts(path, n_users, per_user, seed=4):
    """A random trust file beside ``_ratings``' ratings: ``per_user``
    friends a user on average, no self loops."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n_users * per_user)
    v = rng.integers(0, n_users, n_users * per_user)
    lines = ["u_id,v_id"] + [f"{a},{b}" for a, b in zip(u, v) if a != b]
    (path / "toy" / "trusts.csv").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("name", ["DiffNet", "DiffNetPlusPlus", "LR_GCCF",
                                  "WMF", "DMF", "SML", "EATNN"])
def test_slice9_scan_step_on_the_card_matches_the_cpu(cuda, tmp_path, name):
    """One scan step of each model of conf/<name>.properties (its widths,
    its optimizer) from one state on one batch, on the card and on the
    CPU: the loss within 1e-5, every gradient and every parameter after
    the step within 1e-5 + 1e-3 |x|.  The card's segment sums and
    ``embedding`` backward add in another order.  Elements whose CPU
    gradient is nonzero but below 1e-6 of the largest are left out of the
    parameter check: Adam's first step moves each element by
    lr * sign(g), and such a gradient's sign is the rounding's.  EATNN's social term takes
    the keyless hash (no generator) on both."""
    import os

    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.data import load_ranking_data
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.train import Trainer
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    values = {"recommender": name, **_ratings(tmp_path, 900, 1600, 60000)}
    if name in SOCIAL_MODELS:
        _trusts(tmp_path, 900, 8)
    cfg = Config.from_properties(os.path.join(repo, "CleverRec.properties"),
                                 os.path.join(repo, "conf"), values)
    data = load_ranking_data(cfg)
    runs, batch = [], None
    for device in ("cpu", cuda):
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                           device=device)
        tr = Trainer(model, data, cfg, device=device)
        params, state = tr.init_state()
        if batch is None:
            batch = {k: v[0] for k, v in tr.sample_epoch().items()}
        step = {k: v.to(device) for k, v in batch.items()}
        loss = model.loss(step, tr.aux)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), torch.autograd.grad(
                     loss, list(params.values()), allow_unused=True))]
        tr._dropout_gen = None
        params, state, _ = tr._steps(params, state, [step], model.loss)
        runs.append((loss.detach().cpu(), [g.cpu() for g in grads],
                     [p.detach().cpu() for p in params.values()]))
    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = runs
    assert float(l_gpu) == pytest.approx(float(l_cpu), rel=1e-5)
    for a, b in zip(g_gpu, g_cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)
    for a, b, g in zip(p_gpu, p_cpu, g_cpu):
        decided = (g == 0) | (g.abs() >= 1e-6 * g.abs().max())
        np.testing.assert_allclose(a[decided].numpy(), b[decided].numpy(),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", ["RML_DGATs", "SoHRML"])
def test_dual_step_on_the_card_matches_the_cpu(cuda, tmp_path, name):
    """One dual step of conf/<name>.properties (its widths; dropout off,
    the generator being None) from one state on one batch, on the card
    and on the CPU, SoHRML's attention refreshed first on each: the
    attention within 1e-5 + 1e-4 |x|, then the loss, gradients and
    parameters as in the slice-9 test above (the card's segment sums,
    segment maxima and ``embedding`` backward add in another order)."""
    import os

    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.data import load_ranking_data
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.train import Trainer
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    values = {"recommender": name, **_ratings(tmp_path, 900, 1600, 60000),
              "train_batches": "20"}
    _trusts(tmp_path, 900, 8)
    cfg = Config.from_properties(os.path.join(repo, "CleverRec.properties"),
                                 os.path.join(repo, "conf"), values)
    data = load_ranking_data(cfg)
    runs, batch = [], None
    for device in ("cpu", cuda):
        model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                           device=device)
        tr = Trainer(model, data, cfg, device=device)
        params, state = tr.init_state()
        att = None
        if name == "SoHRML":
            with torch.no_grad():
                tr.aux.update(model.pre_epoch(tr.aux))
            att = [tr.aux[k].cpu() for k in ("att_i", "att_s")]
        if batch is None:
            batch = {k: v[0] for k, v in tr.sample_epoch().items()}
        step = {k: v.to(device) for k, v in batch.items()}
        loss = model.loss(step, tr.aux)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), torch.autograd.grad(
                     loss, list(params.values()), allow_unused=True))]
        tr._dropout_gen = None
        params, state, _ = tr._steps(params, state, [step], model.loss)
        runs.append((att, loss.detach().cpu(), [g.cpu() for g in grads],
                     [p.detach().cpu() for p in params.values()]))
    (a_cpu, l_cpu, g_cpu, p_cpu), (a_gpu, l_gpu, g_gpu, p_gpu) = runs
    for a, b in zip(a_gpu or [], a_cpu or []):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert float(l_gpu) == pytest.approx(float(l_cpu), rel=1e-5)
    for a, b in zip(g_gpu, g_cpu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)
    for a, b, g in zip(p_gpu, p_cpu, g_cpu):
        decided = (g == 0) | (g.abs() >= 1e-6 * g.abs().max())
        np.testing.assert_allclose(a[decided].numpy(), b[decided].numpy(),
                                   rtol=1e-3, atol=1e-5)


def test_popularity_draw_on_the_card(cuda):
    """sample_not_in_popular on the card (a CUDA generator, the tables on
    the card): no seen item, and the unseen items' counts against the
    popularity mass renormalised over them, chi-square at p 1e-3, as the
    CPU test (tests/test_torch_popularity.py)."""
    from scipy import stats

    from cleverrec_tpu_torch import sampling
    n_items, n = 60, 200_000
    deg = np.floor(400.0 / np.arange(1, n_items + 1) ** 0.8) + 1
    deg = np.random.default_rng(0).permutation(deg)
    cdf = torch.as_tensor((np.cumsum(deg) / deg.sum()).astype(np.float32),
                          device=cuda)
    seen = sorted(np.argsort(-deg)[:6].tolist()
                  + np.argsort(-deg)[20:26].tolist())
    unseen = np.setdiff1d(np.arange(n_items), seen)
    table = sampling.table_to(
        sampling.build_member_table({0: seen}, 1, n_items), cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    got = sampling.sample_not_in_popular(
        gen, table, torch.zeros(n, dtype=torch.int64, device=cuda), cdf,
        (n,))
    assert got.device.type == "cuda" and got.dtype == torch.int32
    counts = np.bincount(got.cpu().numpy(), minlength=n_items)
    assert counts[seen].sum() == 0
    expect = deg[unseen] / deg[unseen].sum() * n
    assert stats.chisquare(counts[unseen], expect).pvalue > 1e-3


def _ml100k_libfm(path):
    """The repo's ml-100k libFM files under ``path``/ml100k."""
    import shutil
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (path / "ml100k").mkdir()
    for part in ("train", "test"):
        shutil.copy(os.path.join(repo, "benchmarks", "UIRT",
                                 f"ml100k.{part}.libfm"),
                    path / "ml100k" / f"ml100k.{part}.libfm")
    return {"data.root_dir": str(path), "data.dataset": "ml100k",
            "model_type": "rating", "train": ".train.libfm",
            "test": ".test.libfm", "is_real_valued": "True",
            "batch_size": "4096", "reg": "0.001", "lr": "0.001",
            "optimizer": "Adam", "init_method": "normal", "stddev": "0.01",
            "seed": "2026"}


@pytest.mark.parametrize("name,d", [("FM", 16), ("FFM", 8)])
def test_rating_epoch_on_the_card_matches_the_cpu(cuda, tmp_path, name, d):
    """One FM and one FFM epoch at the confs' widths on ml-100k (20 Adam
    steps of 4,096 rows), on the card and on the CPU, from one state on
    one order: parameters, mean loss and training RMSE within
    1e-5 + 1e-3 |x| (``index_put``'s atomics and the einsums add in
    another order on the card)."""
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.data.libfm import load_rating_data
    from cleverrec_tpu_torch.rating import FMTrainer, make_rating_model
    cfg = Config({"recommender": name, "embed_size": str(d),
                  **_ml100k_libfm(tmp_path)})
    data = load_rating_data(cfg)
    runs, order = [], None
    for device in ("cpu", cuda):
        tr = FMTrainer(make_rating_model(cfg, data), data, cfg,
                       device=device)
        params, state = tr.init_state()
        if order is None:
            order, w = (x.cpu() for x in tr.epoch_order())
        params, state, loss, o, ww, y_pres = tr.train_epoch(
            params, state, order=order, w=w)
        runs.append(({k: p.detach().cpu() for k, p in params.items()},
                     float(loss), tr.train_rmse(o, ww, y_pres)))
    (p_cpu, l_cpu, r_cpu), (p_gpu, l_gpu, r_gpu) = runs
    assert order.shape == (20, 4096)
    assert l_gpu == pytest.approx(l_cpu, rel=1e-3, abs=1e-5)
    np.testing.assert_allclose(r_gpu, r_cpu, rtol=1e-3, atol=1e-5)
    for k in p_cpu:
        np.testing.assert_allclose(p_gpu[k].numpy(), p_cpu[k].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


def test_bf16_rescue_on_the_card_matches_plain(cuda, monkeypatch):
    """``rank_fused`` with the bf16 rescue copy (``approx`` serving) on a
    131,072-item catalog, d 128, 256 users, k 20: through ``dot_gmax``
    (one launch) against the same path with ``dot_gmax``'s plain version,
    on the card; scores within 1e-5 + 1e-5 |x|, ids equal but among
    near-ties; and no seen item."""
    from cleverrec_tpu_torch import ranking
    b, n, d, k = 256, 131072, 128, 20
    u, q, bits, _ = (None if x is None else torch.as_tensor(x).to(cuda)
                     for x in _inputs(b, n, d, False, seed=4))

    class Dot(torch.nn.Module):
        cml_like = False

        def __init__(self):
            super().__init__()
            self.q = torch.nn.Parameter(q)

        def dot_decomposition(self, users, aux):
            return u[users], self.q, None

    model = Dot()
    users = torch.arange(b, device=cuda)
    pre = ranking.fused_precompute(model, {}, rescue_bf16=True)
    before = S.launches["dot_gmax"]
    gv, gi = ranking.rank_fused(model, {}, users, bits, k, pre=pre)
    torch.cuda.synchronize()
    assert S.launches["dot_gmax"] == before + 1
    monkeypatch.setattr(ranking, "dot_gmax", S.dot_gmax_ref)
    wv, wi = ranking.rank_fused(model, {}, users, bits, k, pre=pre)
    (gv, gi), (wv, wi) = [(v.cpu().numpy(), i.cpu().numpy())
                          for v, i in ((gv, gi), (wv, wi))]
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5)
    for r, j in zip(*np.nonzero(gi != wi)):
        assert (np.abs(np.delete(gv[r], j) - gv[r, j]) <= 1e-4).any()
    seen = bits.cpu().numpy().view(np.uint32)
    words = np.take_along_axis(seen, gi >> 5, axis=1)
    assert not ((words >> (gi & 31).astype(np.uint32)) & 1).any()


@pytest.mark.parametrize("n_items,op", [(1682, "dot_scores"),
                                        (20000, "dot_gmax")])
def test_fused_artifact_on_the_card_equals_live(cuda, n_items, op):
    """A fused retrieval program exported on the card (BPR, d 128, 943
    users x 40 seen items, 256 users a call, k 10): at ml-100k's catalog
    the narrow branch, past 4,096 items the wide one.  Its answers equal
    the live ``retrieve``'s on the same card, each call launches the
    kernel once, and the graph holds the op, not its arithmetic."""
    import io
    import types

    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.sampling import build_member_table
    from cleverrec_tpu_torch.serving import (build_retrieval_fn,
                                             export_retrieval,
                                             load_serialized)
    rng = np.random.default_rng(n_items)
    cfg = Config({"recommender": "BPR", "embed_size": "128", "reg": "0.01",
                  "init_method": "normal", "stddev": "0.1", "seed": "3"})
    model = make_model(cfg, DataMeta(943, n_items), device=cuda)
    dd = types.SimpleNamespace(seen=build_member_table(
        {u: rng.choice(n_items, 40, replace=False).tolist()
         for u in range(943)}, 943, n_items))
    blob = export_retrieval(model, {}, dd, 256, 10, backend="fused")
    program = torch.export.load(io.BytesIO(blob))
    assert {str(n.target) for n in program.graph.nodes
            if str(n.target).startswith("cleverrec.")} == {
        f"cleverrec.{op}.default"}
    served = load_serialized(blob)
    live = build_retrieval_fn(model, {}, dd, 10, backend="fused")
    for _ in range(3):
        users = torch.as_tensor(np.sort(rng.choice(943, 256, replace=False)),
                                device=cuda)
        before = S.launches[op]
        got = served(users)
        torch.cuda.synchronize()
        assert S.launches[op] == before + 1
        want = live(users)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def _classic_data():
    from cleverrec_tpu_torch.classic import InteractionData
    rng = np.random.default_rng(0)
    pairs = [(u, i) for u in range(60) for i in rng.choice(
        np.arange(0, 25) + (25 if u >= 30 else 0), 12, replace=False)]
    pairs = np.asarray(pairs)
    perm = rng.permutation(len(pairs))
    return InteractionData.from_pairs(pairs[perm[90:]], pairs[perm[:90]],
                                      60, 50)


def _classic_ratings():
    rng = np.random.default_rng(1)
    rows = [(u, i, float(np.clip(3.2 + rng.normal(0, 0.8), 1, 5)))
            for u in range(40) for i in rng.choice(30, 12, replace=False)]
    trust = [(u, int(v)) for u in range(40)
             for v in rng.choice(40, 3, replace=False) if v != u]
    return rows, trust


@pytest.mark.parametrize("name", ["LFM", "FunkSVD", "BiasSVD", "SVDpp",
                                  "TrustSVD"])
def test_classic_epochs_on_the_card_match_the_cpu(cuda, name):
    """Each trained classic model's epoch on the card and on the CPU from
    one initial state and the same draws, 2 epochs: within 1e-5 +
    1e-3 |x| (the card's index_add and gathers' backward sum in a
    run-dependent order); then ``fit`` on the card, the default device,
    gives finite answers."""
    import cleverrec_tpu_torch.classic as C
    rows, trust = _classic_ratings()
    gen = torch.Generator().manual_seed(2)
    models = {dev: getattr(C, name)(batch=128, seed=2, device=dev)
              for dev in ("cpu", "cuda")}
    for model in models.values():
        if name == "LFM":
            model.prepare(_classic_data())
        else:
            model.prepare(rows, 40, 30,
                          *([trust] if name == "TrustSVD" else []))
    params = models["cpu"].init_params(gen)
    draws = [models["cpu"].draws(gen) if name == "LFM"
             else (torch.randperm(models["cpu"].padded, generator=gen),)
             for _ in range(2)]
    out = {}
    for dev, model in models.items():
        p = {k: v.detach().clone().to(dev).requires_grad_() for k, v in
             params.items()}
        state = model.opt.init(p)
        for d in draws:
            model.epoch(p, state, *(x.to(dev) for x in d))
        out[dev] = p
    for k in params:
        np.testing.assert_allclose(out["cuda"][k].detach().cpu().numpy(),
                                   out["cpu"][k].detach().numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    if name == "LFM":
        fitted = C.LFM(batch=128).fit(_classic_data())
        assert np.isfinite(fitted.P).all() and np.isfinite(fitted.Q).all()
        assert (fitted.recommend(np.arange(60), 10) >= 0).all()
    else:
        extra = {"trust_pairs": trust} if name == "TrustSVD" else {}
        fitted = getattr(C, name)(batch=128).fit(rows, 40, 30, **extra)
        assert np.isfinite(fitted.predict(np.arange(40), np.arange(40) % 30)
                           ).all()


def test_slim_on_the_card_matches_the_cpu(cuda):
    import cleverrec_tpu_torch.classic as C
    data = _classic_data()
    got = C.SLIM(iters=100).fit(data)
    want = C.SLIM(iters=100, device="cpu").fit(data)
    np.testing.assert_allclose(got.w, want.w, rtol=1e-5, atol=1e-5)
    users = np.arange(60)
    assert (got.recommend(users, 10) >= 0).all()


# -- the capacity tiers' variants: bf16 storage (bpr_epoch, rows_epoch in
# both forms), CML's frozen partial sums, the grouped trainer epoch -------

# bf16 storage: each output carries bf16 values, and all but a share
# BF16_OUTLIERS of its elements (at least BF16_MIN_OUTLIERS of them) lie
# within one bf16 ulp of the plain version's.  The two sum the row
# gradients in another order (f32 atomics here), so a value near a
# rounding boundary lands on the neighbouring bf16, and Adam's
# normalisation carries a flipped moment into its parameter as a step of
# up to ~lr; over more steps the two trajectories part at the bf16 scale
# (tools/bf16_drift.py), so the epochs here are 2 steps, as
# chip_smoke.py's BF16_HELD_STEPS.
BF16_OUTLIERS, BF16_MIN_OUTLIERS = 2e-3, 2


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def _hold_bf16(got, want, label):
    rounded = got.to(torch.bfloat16).float()
    assert torch.equal(got, rounded), f"{label}: not bf16"
    far = (got - want).abs() > _bf16_ulp(torch.maximum(got.abs(),
                                                       want.abs()))
    assert int(far.sum()) <= max(BF16_MIN_OUTLIERS,
                                 BF16_OUTLIERS * far.numel()), (
        label, int(far.sum()), far.numel())


@pytest.mark.parametrize("u_n,i_n,d,steps,b,t0", [
    (37, 53, 16, 2, 64, 7), (943, 1682, 128, 2, 6144, 65),
    (29, 41, 30, 2, 37, 2), (29, 41, 1024, 2, 64, 1)])
def test_bpr_epoch_bf16_matches_plain(cuda, u_n, i_n, d, steps, b, t0):
    """bf16 storage in bpr_epoch (the half-warp, warp, scalar and
    two-pass variants) against the plain version's."""
    state, ids = _epoch_inputs(u_n, i_n, d, steps, b, t0)
    got, want = _on_card(state, cuda), _on_card(state, cuda)
    ids = _on_card(ids, cuda)
    opts = dict(lr=0.01, reg=0.02, table_dtype=torch.bfloat16)
    before = T.launches["bpr_epoch"]
    loss = T.fused_bpr_epoch(*got, *ids, t0, **opts)
    ref = T.fused_bpr_epoch_ref(*want, *ids, t0, **opts)
    torch.cuda.synchronize()
    assert T.launches["bpr_epoch"] == before + 1
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for name, g, w in zip(("P", "Q", "mP", "vP", "mQ", "vQ"), got, want):
        _hold_bf16(g, w, name)


def _hold_rows_bf16(cuda, kernel, spec, state, planes, floats, t0):
    got, want = _rows_state(spec, state, cuda), _rows_state(spec, state, cuda)
    planes = [torch.as_tensor(x).to(cuda) for x in planes]
    floats = [torch.as_tensor(x).to(cuda) for x in floats]
    sides = [sd for _, sd in spec["planes"]]
    opts = dict(sides=sides, lr=0.01, table_dtype=torch.bfloat16)
    before = dict(T.launches)
    loss = T.fused_rows_epoch(*got, planes, floats, t0, spec=spec, **opts)
    ref = T.fused_rows_epoch_ref(*want, planes, floats, t0,
                                 row_loss=spec["row_loss"], **opts)
    torch.cuda.synchronize()
    assert T.launches == {**before, kernel: before[kernel] + 1}
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for k, (g_side, w_side) in enumerate(zip(got, want)):
        for n, (g, w) in enumerate(zip(g_side, w_side)):
            _hold_bf16(g, w, f"part {k}, tensor {n}")


@pytest.mark.parametrize("u_n,i_n,d,steps,b,t0,masked", [
    (943, 1682, 128, 3, 6144, 81, 0.15), (29, 41, 18, 3, 64, 2, 0.3)])
@pytest.mark.parametrize("name", ["SBPR", "TBPR", "CUNE_BPR"])
def test_rows_epoch_bf16_matches_plain(cuda, name, u_n, i_n, d, steps, b, t0,
                                       masked):
    """bf16 storage in rows_epoch's chain (float4 and scalar rows; SBPR's
    float column and CUNE_BPR's dense s) against the plain version's."""
    spec, state, planes, floats = _rows_inputs(name, u_n, i_n, d, steps, b,
                                               t0, masked)
    # Floats that bf16 does not hold exactly.
    floats = [f + 1.0 / 3.0 for f in floats]
    _hold_rows_bf16(cuda, "rows_epoch", spec, state, planes, floats, t0)


@pytest.mark.parametrize("u_n,i_n,d,mem,steps,b,t0,masked", [
    (943, 1682, 128, 50, 3, 6144, 17, 0.1), (29, 41, 18, 7, 3, 64, 2, 0.3)])
def test_rows_epoch_lrml_bf16_matches_plain(cuda, u_n, i_n, d, mem, steps, b,
                                            t0, masked):
    """bf16 storage in LRML's form against the plain version's."""
    spec, state, planes = _lrml_inputs(u_n, i_n, d, mem, steps, b, t0,
                                       masked)
    _hold_rows_bf16(cuda, "rows_epoch_lrml", spec, state, planes, [], t0)


@pytest.mark.parametrize("u_n,i_n,d,k,steps,b,t0,ur", [
    (29, 41, 16, 4, 4, 64, 3, 20), (943, 1682, 128, 20, 3, 6144, 17, 900),
    (29, 41, 18, 4, 3, 37, 2, 29), (29, 41, 3600, 4, 2, 37, 1, 11)])
def test_cml_epoch_frozen_matches_plain(cuda, u_n, i_n, d, k, steps, b, t0,
                                        ur):
    """cml_epoch with the grouped launch's frozen partial sums against the
    plain version's: the slice's rows from ur on (random, not the zero
    fillers of a real launch, to show they stay out of the regulariser)
    hold no ids; 300 frozen rows enter through their sums."""
    state, ids = _cml_inputs(u_n, i_n, d, k, steps, b, t0)
    u_pad = T.sentinel_dims(u_n, i_n)[0]
    ids[0] = np.where(ids[0] == u_pad - 1, u_pad - 1, ids[0] % ur).astype(
        np.int32)
    rng = np.random.default_rng(9)
    rows = torch.as_tensor(rng.normal(size=(300, d)).astype(np.float32) * 0.1)
    a = rows.sum(dim=1)
    frozen = (ur, 300, *(x.to(cuda) for x in (
        a.sum(), (a * a).sum(), (rows * rows).sum(), rows.sum(dim=0))))
    got, want = _on_card(state, cuda), _on_card(state, cuda)
    ids = _on_card(ids, cuda)
    opts = dict(lr=0.01, reg=10.0, margin=1.0, item_nums=i_n)
    before = T.launches["cml_epoch"]
    loss = T.fused_cml_epoch(*got, *ids, t0, **opts, frozen=frozen)
    ref = T.fused_cml_epoch_ref(*want, *ids, t0, **opts, frozen=frozen)
    torch.cuda.synchronize()
    assert T.launches["cml_epoch"] == before + 1
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL)


GROUPED_MODELS = {
    "BPR": {"is_pairwise": "True", "loss_func": "bpr"},
    "GMF": {"is_pairwise": "False", "loss_func": "cross_entropy"},
    "NeuMF": {"is_pairwise": "False", "loss_func": "cross_entropy",
              "layers": "[32,16]", "reg1": "0.01", "reg2": "0.01"},
    "CML": {"is_pairwise": "True", "loss_func": "hinge", "margin": "1.0",
            "reg": "0.1"},
}


@pytest.mark.parametrize("name", list(GROUPED_MODELS))
def test_grouped_epoch_on_the_card_matches_plain(cuda, tmp_path, name):
    """One grouped epoch (two user groups) of the trainer on the card,
    through the kernels and through their plain versions
    (``ops.train.PLAIN_EPOCH_FNS``) from one state and one draw: one
    launch a group, the loss and every parameter and moment within the
    epoch tolerances.  The tower's groups take 2 steps each (ReLU kinks
    part trajectories over longer runs)."""
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.data import load_ranking_data
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.train import Trainer
    cfg = Config({"recommender": name, "topk": "[10]", "embed_size": "32",
                  "batch_size": "256", "neg_ratio": "3", "lr": "0.01",
                  "reg": "0.01", "optimizer": "Adam", "stddev": "0.1",
                  "seed": "3", "train.fused_kernel": "True",
                  "train.fused_groups": "2", "test.neg_samples": "20",
                  **GROUPED_MODELS[name], **_ratings(tmp_path, 300, 200,
                                                     6000)})
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device=cuda)
    tr = Trainer(model, data, cfg, device=cuda)
    assert tr._groups == 2
    params, state = tr.init_state()
    draw = tr.sample_epoch()
    if name == "NeuMF":
        draw = {"groups": [{k: v[:2] for k, v in g.items()}
                           for g in draw["groups"]]}
    before = ({n: p.detach().clone() for n, p in params.items()},
              {n: m.clone() for n, m in state.mu.items()},
              {n: v.clone() for n, v in state.nu.items()}, state.count)
    kernel = {"NeuMF": "mlp_epoch", "GMF": "gmf_epoch",
              "CML": "cml_epoch"}.get(name, "bpr_epoch")
    launches = T.launches[kernel]
    _, state, loss = tr._run_epoch(params, state, draw)
    torch.cuda.synchronize()
    assert T.launches[kernel] == launches + 2
    got = ({n: p.detach().clone() for n, p in params.items()},
           {n: m.clone() for n, m in state.mu.items()},
           {n: v.clone() for n, v in state.nu.items()})
    for t, saved in zip((params, state.mu, state.nu), before[:3]):
        for n, x in saved.items():
            t[n].detach().copy_(x)
    state.count = before[3]
    tr.epoch_fns = dict(T.PLAIN_EPOCH_FNS)
    _, state, ref = tr._run_epoch(params, state, draw)
    torch.cuda.synchronize()
    assert T.launches[kernel] == launches + 2
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for t, want in zip(got, (params, state.mu, state.nu)):
        for n, g in t.items():
            np.testing.assert_allclose(g.cpu().numpy(),
                                       want[n].detach().cpu().numpy(),
                                       rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                       err_msg=n)
