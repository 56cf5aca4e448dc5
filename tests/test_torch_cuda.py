"""The port's CUDA kernels against their plain versions, on the card.

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
