"""The port's streaming layer against the JAX package: ``streaming_topk``
on a fixed score matrix (the narrow branch, the grouped branch, ragged
tails, ``approx``), and ``rank_stream`` on each of its masking branches
(bitmap slices, the top-(k + W) post-filter, the per-chunk binary search,
none) for a dot model, a distance model and a model with no dot
decomposition, on one set of random weights carried by
``weights.load_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu import ranking as jranking
from cleverrec_tpu.config import Config as JConfig
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.ops.topk import streaming_topk as j_streaming_topk
from cleverrec_tpu_torch import ranking
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops.topk import streaming_topk
from cleverrec_tpu_torch.weights import load_params
from tests.test_torch_ranking import assert_same_ranking

B, D, N_ITEMS, N_SEEN = 12, 16, 1000, 60


@pytest.mark.parametrize("n,k,chunk,approx", [
    (1000, 12, 128, False),         # narrow: the whole chunk merges
    (1000, 12, 128, True),
    (20000, 10, 8192, False),       # grouped chunks, ragged tail
    (20000, 20, 8192, True),
    (30, 40, 32, False)])           # k past the catalog: -inf slots
def test_streaming_topk_matches_jax(n, k, chunk, approx):
    rng = np.random.default_rng(n + k)
    scores = rng.normal(size=(6, n)).astype(np.float32)
    scores[:, rng.choice(n, n // 10, replace=False)] = -np.inf   # masked
    j_scores, t_scores = jnp.asarray(scores), torch.as_tensor(scores)
    want_v, want_i = (np.asarray(x) for x in j_streaming_topk(
        lambda ids: j_scores[:, ids], n, k, chunk=chunk, approx=approx))
    v, i = streaming_topk(lambda ids: t_scores[:, ids], n, k, chunk=chunk,
                          approx=approx)
    assert v.shape == i.shape == (6, k)
    np.testing.assert_array_equal(v.numpy(), want_v)
    # Untied random scores: the ids too, -inf slots included.
    np.testing.assert_array_equal(i.numpy(), want_i)
    exact = np.sort(scores, axis=1)[:, ::-1][:, :min(k, n)]
    np.testing.assert_array_equal(v.numpy()[:, :min(k, n)], exact)


def _setup(name):
    """JAX and port models of ``name`` on one set of random weights, and
    the users' seen items as sorted rows (sentinel N_ITEMS) and bitmaps."""
    values = {"recommender": name, "embed_size": str(D), "reg": "0.01",
              "layers": "[16,8]", "margin": "0.5", "mem_size": "4"}
    jmodel = j_make_model(JConfig(values), JMeta(B, N_ITEMS))
    rng = np.random.default_rng(len(name))
    params = {key: (rng.normal(size=v.shape) * 0.5).astype(np.float32)
              for key, v in jmodel.init(jax.random.PRNGKey(0)).items()}
    model = make_model(Config(values), DataMeta(B, N_ITEMS), device="cpu")
    load_params(model, params)
    rows = np.full((B, N_SEEN), N_ITEMS, np.int32)
    bits = np.zeros((B, -(-N_ITEMS // 32)), np.uint32)
    for r in range(B):
        s = np.sort(rng.choice(N_ITEMS, N_SEEN - r, replace=False))
        rows[r, :len(s)] = s
        np.bitwise_or.at(bits[r], s >> 5, np.uint32(1) << (s & 31))
    return jmodel, {k: jnp.asarray(v) for k, v in params.items()}, model, \
        rows, bits


@pytest.mark.parametrize("name", ["BPR", "CML", "MLP"])
@pytest.mark.parametrize("branch,chunk", [
    ("bits", 32), ("bits", 64), ("post_filter", 256),
    ("search", 256), ("unfiltered", 256)])
def test_rank_stream_matches_jax(name, branch, chunk):
    jmodel, params, model, rows, bits = _setup(name)
    if branch == "search":
        # Rows wider than 4096 take the per-chunk binary search.
        rows = np.pad(rows, ((0, 0), (0, 4097 - rows.shape[1])),
                      constant_values=N_ITEMS)
    users = np.arange(B, dtype=np.int32)
    with_bits = branch == "bits"
    filter_seen = branch != "unfiltered"
    k = 10
    want = jranking.rank_stream(
        jmodel, params, {}, jnp.asarray(users), jnp.asarray(rows), N_ITEMS,
        k, chunk=chunk, filter_seen=filter_seen,
        seen_bits=jnp.asarray(bits) if with_bits else None)
    got = ranking.rank_stream(
        model, {}, torch.as_tensor(users).long(), torch.as_tensor(rows),
        N_ITEMS, k, chunk=chunk, filter_seen=filter_seen,
        seen_bits=torch.as_tensor(bits.view(np.int32)) if with_bits
        else None)
    got, want = [(np.asarray(v), np.asarray(i)) for v, i in (got, want)]
    assert_same_ranking(got, want)
    np.testing.assert_array_equal(got[1], want[1])   # untied scores
    if filter_seen:
        for r, items in enumerate(got[1]):
            assert not set(items.tolist()) & set(rows[r].tolist())


def test_rank_stream_matches_dense_and_refuses_unaligned_bitmaps():
    """The stream's answer is the dense ranker's, and bitmap slices need
    chunks of whole words."""
    _, _, model, rows, bits = _setup("BPR")
    u = torch.arange(B)
    rows_t, bits_t = torch.as_tensor(rows), torch.as_tensor(
        bits.view(np.int32))
    want = ranking.rank_dense(model, {}, u, rows_t.long(), 20)
    for kwargs in ({"seen_bits": bits_t, "chunk": 96}, {"chunk": 100}):
        got = ranking.rank_stream(model, {}, u, rows_t, N_ITEMS, 20,
                                  **kwargs)
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="32"):
        ranking.rank_stream(model, {}, u, None, N_ITEMS, 20, chunk=100,
                            seen_bits=bits_t)
