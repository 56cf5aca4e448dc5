"""The port's masked-scoring plain versions (the CPU path of the CUDA
kernels' wrappers) against the JAX package's Pallas kernels in
interpret mode, on identical numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu.ops.pallas_scores import (fused_dot_gmax,
                                             fused_dot_scores,
                                             fused_dot_topk_scores,
                                             permute_item_table)
from cleverrec_tpu_torch.ops import scores as S
from cleverrec_tpu_torch.ops.topk import topk

# f32 dots of width 16, summed in another order by XLA and by torch.
ATOL = 1e-5
B, I, D = 37, 5000, 16          # two 4096-item tiles, ragged tail


def _inputs(with_bias, b=B, i=I):
    rng = np.random.default_rng(3)
    u = rng.normal(size=(b, D)).astype(np.float32)
    q = rng.normal(size=(i, D)).astype(np.float32)
    words = -(-i // 32)
    bits = np.zeros((b, words), np.uint32)
    for r in range(b):
        s = rng.choice(i, size=min(400, i // 4), replace=False)
        np.bitwise_or.at(bits[r], s >> 5, np.uint32(1) << (s & 31))
    bits[0, :3] = 0xFFFFFFFF                       # whole groups seen
    bias = rng.normal(size=(i,)).astype(np.float32) if with_bias else None
    return u, q, bits, bias


def _torch(u, q, bits, bias):
    return (torch.as_tensor(u), torch.as_tensor(q),
            torch.as_tensor(bits.view(np.int32)),
            None if bias is None else torch.as_tensor(bias))


def _assert_masked_close(got, want):
    masked = want == S.NEG
    np.testing.assert_array_equal(got == S.NEG, masked)
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_dot_scores_ref_matches_pallas(with_bias):
    u, q, bits, bias = _inputs(with_bias)
    perm, item_map = fused_dot_scores(
        jnp.asarray(u), jnp.asarray(q), jnp.asarray(bits), block_b=8,
        interpret=True, bias=None if bias is None else jnp.asarray(bias))
    imap = np.asarray(item_map)
    want = np.empty((B, imap.shape[0]), np.float32)
    want[:, imap] = np.asarray(perm)                 # back to item order
    assert (want[:, I:] == S.NEG).all()              # padded items masked
    got = S.dot_scores(*_torch(u, q, bits, bias)).numpy()
    assert got.shape == (B, I)
    _assert_masked_close(got, want[:, :I])


@pytest.mark.parametrize("with_bias", [False, True])
def test_dot_gmax_ref_matches_pallas(with_bias):
    u, q, bits, bias = _inputs(with_bias)
    q_perm, item_map = permute_item_table(jnp.asarray(q))
    bias_perm = None
    if bias is not None:
        padded = np.zeros(item_map.shape[0], np.float32)
        padded[:I] = bias
        bias_perm = jnp.asarray(padded)[item_map]
    want = np.asarray(fused_dot_gmax(
        jnp.asarray(u), q_perm, jnp.asarray(bits), interpret=True,
        item_nums=I, bias_perm=bias_perm))
    groups = -(-I // 32)
    assert (want[:, groups:] == S.NEG).all()         # all-padding groups
    got = S.dot_gmax(*_torch(u, q, bits, bias)).numpy()
    assert got.shape == (B, groups)
    _assert_masked_close(got, want[:, :groups])


def _blocks(b, i, tile):
    bm, bn = S.SCORE_TILES[tile]
    return -(-b // bm) * -(-i // bn)


# dot_scores' tile: the largest whose grid holds at least one block per SM,
# else the smallest.  On an H100 SXM (132 SMs), phase A of chip_smoke.py
# (256 users x 1,682 items) takes the 32 x 64 tile, 216 blocks; its
# 1,024-user eval batches the 64 x 64; the 103,523-item catalog the widest.
@pytest.mark.parametrize("b,i,sms,want", [
    (256, 1682, 132, (32, 64)), (1024, 103523, 132, (128, 128)),
    (1024, 4096, 132, (128, 128)), (512, 1682, 132, (64, 64)),
    (1024, 1682, 132, (64, 64)), (1, 1, 132, (32, 64)),
    (1, 4096, 132, (32, 64)), (1, 103523, 132, (128, 128)),
    (100, 1, 132, (32, 64)), (70000, 1, 132, (128, 128)),
    # Another card's SM count moves the borders.
    (1024, 1682, 108, (128, 128)), (256, 1682, 16, (128, 128)),
    (256, 1682, 1000, (32, 64))])
def test_scores_tile_fills_the_card(b, i, sms, want):
    tile = S._scores_tile(b, i, sms)
    assert S.SCORE_TILES[tile] == want
    if _blocks(b, i, tile) < sms:
        assert tile == len(S.SCORE_TILES) - 1
    assert all(_blocks(b, i, k) < sms for k in range(tile))


# (d, start, 16-byte staging?): q = big[start:].view(10, d), contiguous;
# start = d is big[1:] of a [rows, d] table.
@pytest.mark.parametrize("d,start,want", [
    (8, 0, True), (8, 4, True), (8, 8, True), (8, 1, False), (8, 2, False),
    (6, 0, False), (6, 6, False), (1, 1, False)])
def test_alignment_flag_on_offset_views(d, start, want):
    """16-byte staging needs d % 4 == 0 and 16-byte aligned bases of u
    and q; a contiguous view into a larger buffer may start anywhere."""
    big = torch.randn(12 * d)
    assert big.data_ptr() % 16 == 0
    q = big[start:start + 10 * d].view(10, d)
    u = torch.randn(3, d)
    assert q.is_contiguous()
    assert S._aligned(u, q) is want
    assert S._aligned(q, u) is want
    # The CPU path (the plain version) reads such views as they are.
    bits = torch.zeros(3, 1, dtype=torch.int32)
    torch.testing.assert_close(S.dot_scores(u, q, bits),
                               S.dot_scores_ref(u, q.clone(), bits))


# fused_dot_topk_scores: 1, 2 and 3 tiles of 4096 items with a ragged tail
# (the shapes of tests/test_ops.py).
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("n_items", [200, I, 2 * 4096 + 100])
def test_dot_topk_scores_ref_matches_pallas(n_items, with_bias):
    b = 16
    u, q, bits, bias = _inputs(with_bias, b, n_items)
    j_scores, j_gmax, j_map = (np.asarray(x) for x in fused_dot_topk_scores(
        jnp.asarray(u), jnp.asarray(q), jnp.asarray(bits), block_b=8,
        interpret=True, bias=None if bias is None else jnp.asarray(bias)))
    scores, gmax, item_map = S.dot_topk_scores(*_torch(u, q, bits, bias))
    scores, gmax, item_map = scores.numpy(), gmax.numpy(), item_map.numpy()
    i_pad = -(-n_items // 4096) * 4096
    assert scores.shape == j_scores.shape == (b, i_pad)
    assert gmax.shape == j_gmax.shape == (b, i_pad // 32)
    np.testing.assert_array_equal(item_map, np.arange(i_pad))
    # Both in item order: each package's columns through its own item_map.
    want = np.empty_like(j_scores)
    want[:, j_map] = j_scores
    got = np.empty_like(scores)
    got[:, item_map] = scores
    assert (got[:, n_items:] == S.NEG).all()         # padded items masked
    assert (got[0, :96] == S.NEG).all()              # whole seen words
    _assert_masked_close(got, want)
    # gmax in the TPU kernel's lane layout, element by element.
    _assert_masked_close(gmax, j_gmax)
    lanes = gmax.reshape(b, -1, 128)
    assert (lanes[:, :, 32:] == S.NEG).all()
    # The ranked ids, through each item_map (untied random scores).
    for k in (5, 20):
        _, idx = topk(torch.as_tensor(scores), k)
        _, j_idx = jax.lax.top_k(jnp.asarray(j_scores), k)
        np.testing.assert_array_equal(item_map[idx.numpy()],
                                      j_map[np.asarray(j_idx)])
