"""The port's CUDA kernels against their plain versions, on the card:
dot_scores and dot_gmax, and the epoch kernels bpr_epoch, gmf_epoch and
mlp_epoch.

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
