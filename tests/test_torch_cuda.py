"""The port's CUDA kernels against their plain versions, on the card:
dot_scores, dot_gmax and dot_topk_scores, and the epoch kernels
bpr_epoch, gmf_epoch, mlp_epoch, rows_epoch (the social chain and LRML's
form) and cml_epoch.

Marked ``cuda``: each test skips without an NVIDIA GPU.  The file imports
only torch, numpy and the port, so on the GPU machine it runs without
the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

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


@pytest.mark.parametrize("u_n,i_n,d,steps,b,t0", [
    (37, 53, 16, 4, 64, 0), (37, 53, 16, 4, 64, 7), (29, 41, 40, 3, 37, 2),
    (943, 1682, 128, 3, 6144, 65)])
def test_bpr_epoch_matches_plain(cuda, u_n, i_n, d, steps, b, t0):
    state, ids = _epoch_inputs(u_n, i_n, d, steps, b, t0)
    got = [torch.as_tensor(x).to(cuda) for x in state]
    want = [torch.as_tensor(x).to(cuda) for x in state]
    ids = [torch.as_tensor(x).to(cuda) for x in ids]
    before = T.launches["bpr_epoch"]
    loss = T.fused_bpr_epoch(*got, *ids, t0, lr=0.01, reg=0.02)
    ref = T.fused_bpr_epoch_ref(*want, *ids, t0, lr=0.01, reg=0.02)
    torch.cuda.synchronize()
    assert T.launches["bpr_epoch"] == before + 1
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=EPOCH_RTOL, atol=EPOCH_ATOL)


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


# gmf_epoch and mlp_epoch: as bpr_epoch, f32 atomics sum duplicate ids in
# a run-dependent order.  mlp_epoch's dense params (the W_l, b_l and h)
# also sum every row of a step (6144 on the main path) through one atomic
# per element per block, against cuBLAS's products in the plain version,
# and each step's Adam normalises that rounding into the next: their
# elements, and the loss, which depends on them, are held looser.
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


@pytest.mark.parametrize("u_n,i_n,d,steps,b,t0", [
    (29, 41, 16, 4, 64, 0), (29, 41, 16, 4, 64, 7), (37, 53, 40, 3, 37, 2),
    (943, 1682, 64, 3, 6144, 81)])
def test_gmf_epoch_matches_plain(cuda, u_n, i_n, d, steps, b, t0):
    state, ids, y = _gmf_inputs(u_n, i_n, d, steps, b, t0)
    got = [torch.as_tensor(x).to(cuda) for x in state]
    want = [torch.as_tensor(x).to(cuda) for x in state]
    ids = [torch.as_tensor(x).to(cuda) for x in ids]
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
    ("NeuMF", 943, 1682, 64, [128, 64, 32], 3, 6144, 81)])
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
# run-dependent order; CUNE_BPR's s sums every row of a step through one
# atomic a block, and Adam normalises that rounding into each next step.
ROWS_CASES = [(29, 41, 16, 4, 64, 0, 0.5), (37, 53, 40, 3, 37, 5, 0.5),
              (943, 1682, 128, 3, 6144, 81, 0.15)]


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


@pytest.mark.parametrize("u_n,i_n,d,steps,b,t0,masked", ROWS_CASES)
@pytest.mark.parametrize("name", ["SBPR", "TBPR", "CUNE_BPR"])
def test_rows_epoch_matches_plain(cuda, name, u_n, i_n, d, steps, b, t0,
                                  masked):
    spec, state, planes, floats = _rows_inputs(name, u_n, i_n, d, steps, b,
                                               t0, masked)
    got, want = _rows_state(spec, state, cuda), _rows_state(spec, state, cuda)
    planes = [torch.as_tensor(x).to(cuda) for x in planes]
    floats = [torch.as_tensor(x).to(cuda) for x in floats]
    sides = [sd for _, sd in spec["planes"]]
    before = T.launches["rows_epoch"]
    loss = T.fused_rows_epoch(*got, planes, floats, t0, sides=sides,
                              spec=spec, lr=0.01)
    ref = T.fused_rows_epoch_ref(*want, planes, floats, t0, sides=sides,
                                 row_loss=spec["row_loss"], lr=0.01)
    torch.cuda.synchronize()
    assert T.launches["rows_epoch"] == before + 1
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for k, (g_side, w_side) in enumerate(zip(got, want)):
        for g, w in zip(g_side, w_side):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                       err_msg=f"part {k}")


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
CML_CASES = [(29, 41, 16, 4, 4, 64, 0), (37, 53, 40, 5, 3, 37, 7),
             (943, 1682, 128, 20, 3, 6144, 17)]


def _cml_inputs(u_n, i_n, d, k, steps, b, t0, seed=0):
    rng = np.random.default_rng(seed)
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.15
    invalid[0, :3] = True
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


@pytest.mark.parametrize("u_n,i_n,d,k,steps,b,t0", CML_CASES)
def test_cml_epoch_matches_plain(cuda, u_n, i_n, d, k, steps, b, t0):
    state, ids = _cml_inputs(u_n, i_n, d, k, steps, b, t0)
    got = [torch.as_tensor(x).to(cuda) for x in state]
    want = [torch.as_tensor(x).to(cuda) for x in state]
    ids = [torch.as_tensor(x).to(cuda) for x in ids]
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


def _lrml_inputs(u_n, i_n, d, mem, steps, b, t0, masked, seed=0):
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    cfg = Config({"recommender": "LRML", "embed_size": str(d),
                  "mem_size": str(mem), "reg": "0.001", "margin": "0.2",
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


# LRML's form: K and M sum every row of a step through shared atomics and
# one global atomic per element per block, against autograd's products in
# the plain version, and Adam normalises that rounding into each step.
@pytest.mark.parametrize("u_n,i_n,d,mem,steps,b,t0,masked", [
    (29, 41, 16, 6, 4, 64, 0, 0.5), (37, 53, 40, 7, 3, 37, 5, 0.3),
    (943, 1682, 128, 50, 3, 6144, 17, 0.1)])
def test_rows_epoch_lrml_matches_plain(cuda, u_n, i_n, d, mem, steps, b, t0,
                                       masked):
    spec, state, planes = _lrml_inputs(u_n, i_n, d, mem, steps, b, t0,
                                       masked)
    assert T.rows_epoch_plan(spec)["form"] == "lrml"
    got, want = _rows_state(spec, state, cuda), _rows_state(spec, state, cuda)
    planes = [torch.as_tensor(x).to(cuda) for x in planes]
    sides = [sd for _, sd in spec["planes"]]
    before = dict(T.launches)
    loss = T.fused_rows_epoch(*got, planes, [], t0, sides=sides, spec=spec,
                              lr=0.01)
    ref = T.fused_rows_epoch_ref(*want, planes, [], t0, sides=sides,
                                 row_loss=spec["row_loss"], lr=0.01)
    torch.cuda.synchronize()
    assert T.launches["rows_epoch_lrml"] == before["rows_epoch_lrml"] + 1
    assert T.launches["rows_epoch"] == before["rows_epoch"]
    assert float(loss) == pytest.approx(float(ref), rel=EPOCH_LOSS_RTOL)
    for k, (g_side, w_side) in enumerate(zip(got, want)):
        for g, w in zip(g_side, w_side):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=EPOCH_RTOL, atol=EPOCH_ATOL,
                                       err_msg=f"part {k}")


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
