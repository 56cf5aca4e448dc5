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

pytestmark = pytest.mark.cuda

# Masked slots are the exact sentinel in both versions; elsewhere the two
# sum the same f32 products in another order.
ATOL, RTOL = 1e-4, 1e-5


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
