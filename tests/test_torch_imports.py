"""The port's boundaries: it loads neither JAX, optax, pandas nor the JAX
package; its entry points refuse a missing card instead of falling back
to the CPU; a kernel wrapper given CPU tensors takes the plain path."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import cleverrec_tpu_torch
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.models.base import DataMeta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "pandas", "cleverrec_tpu")

PROBE = """
import importlib, json, pkgutil, sys
import cleverrec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    cleverrec_tpu_torch.__path__, "cleverrec_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(
        cleverrec_tpu_torch.__path__, "cleverrec_tpu_torch.")]


def test_port_never_loads_jax_or_the_jax_package():
    import json
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(report["imported"]) == set(_port_modules())
    for name in ("ops.scores", "ops.train", "models.ncf", "models.social",
                 "data.social", "models.metric", "models.modules",
                 "ops.sparse_adam", "train.checkpoint", "tuning",
                 "models.itemsim", "models.gcn", "models.diffnet",
                 "models.extra", "rating", "data.libfm", "data.fm_convert",
                 "data.fastcsv", "serving", "classic", "classic.mf",
                 "parallel", "parallel.mesh", "parallel.sharding"):
        assert f"cleverrec_tpu_torch.{name}" in report["imported"]
    # A prefix check that tells cleverrec_tpu_torch from cleverrec_tpu.
    bad = [m for m in report["loaded"]
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def _cfg():
    return Config({"recommender": "BPR", "embed_size": "8", "reg": "0.01",
                   "topk": "[5]"})


def test_default_device_raises_without_a_card(monkeypatch):
    from cleverrec_tpu_torch.common import resolve_device
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.classic import (SLIM, LFM, FunkSVD,
                                             InteractionData)
    from cleverrec_tpu_torch.serving import build_rerank_fn, export_rerank
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model(_cfg(), DataMeta(4, 40))
    model = make_model(_cfg(), DataMeta(4, 40), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_rerank_fn(model, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_rerank(model, {}, 2, 3)
    data = InteractionData.from_pairs([(0, 1), (1, 2)], [(0, 2)], 2, 3)
    for classic in (LFM(), SLIM()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            classic.fit(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FunkSVD().fit([(0, 1, 4.0)], 2, 3)
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_model_names_its_slice():
    """No ranking model is left unported: the registry is the JAX
    package's (26 models, RML_DGATs and SoHRML the last), each builds,
    and a name outside it raises KeyError listing them, as under JAX."""
    from cleverrec_tpu.models import available_models as j_available_models
    from cleverrec_tpu_torch.models import available_models, make_model
    assert available_models() == j_available_models()
    assert len(available_models()) == 26
    for name in ("RML_DGATs", "SoHRML"):
        cfg = Config({"recommender": name, "embed_size": "8",
                      "atten_size": "4", "gamma": "0.1", "reg1": "0.1",
                      "reg2": "0.01", "margin": "0.5", "att_type": "2",
                      "mlp_type": "1", "train_batches": "2", "max_i": "0",
                      "max_s": "0", "gat_layer_nums": "2",
                      "node_dropout": "0.1", "message_dropout": "0.1"})
        model = make_model(cfg, DataMeta(4, 40), device="cpu")
        assert model.name == name and model.sampler == "dual"
    with pytest.raises(KeyError, match="unknown model 'FM'.*SoHRML"):
        make_model(Config({"recommender": "FM"}), DataMeta(4, 40),
                   device="cpu")


def test_cpu_tensors_take_the_plain_path():
    from cleverrec_tpu_torch.ops import scores as S
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.normal(size=(3, 8)).astype(np.float32))
    q = torch.as_tensor(rng.normal(size=(70, 8)).astype(np.float32))
    bits = torch.zeros((3, 3), dtype=torch.int32)
    bits[0, 0] = -1                                # items 0..31 seen
    before = dict(S.launches)
    got = S.dot_scores(u, q, bits)
    torch.testing.assert_close(got, S.dot_scores_ref(u, q, bits))
    assert (got[0, :32] == S.NEG).all() and (got[1:] != S.NEG).all()
    gmax = S.dot_gmax(u, q, bits)
    torch.testing.assert_close(gmax, S.dot_gmax_ref(u, q, bits))
    assert gmax.shape == (3, 3) and gmax[0, 0] == S.NEG
    assert S.launches == before                    # no kernel launched
    with pytest.raises(ValueError):
        S.dot_scores(u, q, bits[:, :2])            # malformed bitmap
    with pytest.raises(TypeError):
        S.dot_gmax(u.double(), q.double(), bits)
