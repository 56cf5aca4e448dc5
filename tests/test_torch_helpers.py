"""The JAX package's small public helpers in the port (ROADMAP.md queue
1, item 18): ``metrics.ranking_metrics``, ``common.square_loss``,
``models.register`` and ``data.fastcsv.available``, each against the JAX
function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu import common as j_common
from cleverrec_tpu import metrics as j_metrics
from cleverrec_tpu import models as j_models
from cleverrec_tpu.data import fastcsv as j_fastcsv
from cleverrec_tpu_torch import common, metrics, models
from cleverrec_tpu_torch.data import fastcsv


@pytest.mark.parametrize("k", [1, 5, 10])
@pytest.mark.parametrize("standard_mrr", [False, True])
def test_ranking_metrics_match_jax(k, standard_mrr):
    """HR, MRR and NDCG at k over padded lists, users with no real item
    and misses included: equal to the JAX function's."""
    rng = np.random.default_rng(k)
    real = np.full((40, 4), metrics.PAD_ITEM, np.int32)
    rec = np.full((40, 12), metrics.PAD_ITEM, np.int32)
    for b in range(40):
        n = rng.integers(0, 5)
        real[b, :n] = rng.choice(30, n, replace=False)
        m = rng.integers(k, 13)
        rec[b, :m] = rng.choice(30, m, replace=False)
    got = metrics.ranking_metrics(real, rec, k, standard_mrr=standard_mrr)
    want = j_metrics.ranking_metrics(real, rec, k,
                                     standard_mrr=standard_mrr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("weighted", [False, True])
def test_square_loss_matches_jax(weighted):
    rng = np.random.default_rng(3)
    y, p, w = (rng.normal(size=50).astype(np.float32) for _ in range(3))
    got = common.square_loss(torch.as_tensor(y), torch.as_tensor(p),
                             torch.as_tensor(w) if weighted else None)
    want = j_common.square_loss(jnp.asarray(y), jnp.asarray(p),
                                jnp.asarray(w) if weighted else None)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_register_adds_a_model_as_jax():
    """register() files a class under its name and returns it (a class
    decorator); the registry holds the JAX package's 26 names."""
    assert models.available_models() == j_models.available_models()

    @models.register
    class Toy(models.RecModel):
        name = "ToyModel"

    try:
        assert "ToyModel" in models.available_models()
        assert models._REGISTRY["ToyModel"] is Toy
    finally:
        del models._REGISTRY["ToyModel"]
    assert models.available_models() == j_models.available_models()


def test_fastcsv_available_as_jax(tmp_path):
    """available() is true where the native parser loads, as the JAX
    package's; where it does, the parser reads a file as numpy does."""
    assert fastcsv.available() == j_fastcsv.available()
    if not fastcsv.available():
        return
    path = tmp_path / "x.csv"
    path.write_text("a,b\n1,2.5\n3,4\n")
    cols = fastcsv.read_columns(str(path), ",", 2)
    np.testing.assert_array_equal(cols[0], [1.0, 3.0])
    np.testing.assert_array_equal(cols[1], [2.5, 4.0])
