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
                 "models.itemsim", "models.gcn"):
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
    from cleverrec_tpu_torch.serving import build_rerank_fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model(_cfg(), DataMeta(4, 40))
    model = make_model(_cfg(), DataMeta(4, 40), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_rerank_fn(model, {})
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_model_names_its_slice():
    from cleverrec_tpu_torch.models import make_model
    cfg = Config({"recommender": "DiffNet"})
    with pytest.raises(NotImplementedError,
                       match="other-ranking-models slice.*item 11"):
        make_model(cfg, DataMeta(4, 40), device="cpu")


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
