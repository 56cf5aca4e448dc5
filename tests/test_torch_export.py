"""Serving export in the port against the JAX package's: the retrieval
and rerank programs (``torch.export`` in place of ``jax.export``) on the
same carried BPR weights, loaded back and called on the same user ids;
the fused program keeps ``cleverrec::dot_scores`` (narrow catalog) or
``cleverrec::dot_gmax`` (wide) as a node of its graph; the bundle's
manifest and a fresh process that loads and serves it."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu.config import Config as JConfig
from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.sampling import build_member_table as j_member_table
from cleverrec_tpu.serving import export_bundle as j_export_bundle
from cleverrec_tpu.serving import export_rerank as j_export_rerank
from cleverrec_tpu.serving import export_retrieval as j_export_retrieval
from cleverrec_tpu.serving import load_serialized as j_load_serialized
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.sampling import build_member_table
from cleverrec_tpu_torch.serving import (build_rerank_fn, build_retrieval_fn,
                                         export_bundle, export_rerank,
                                         export_retrieval, load_retrieval,
                                         load_serialized)
from cleverrec_tpu_torch.weights import load_params
from tests.conftest import base_config, make_toy_interactions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Scores are f32 dots of width 16 of N(0, 1) tables (|score| up to ~15),
# summed by XLA and torch in other orders.
SCORE_TOL = 1e-5
B, K = 8, 5


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy dataset through both loaders on a random split, and BPR
    with the same N(0, 1) tables in both packages."""
    root = tmp_path_factory.mktemp("export")
    (root / "toy").mkdir()
    make_toy_interactions(root / "toy" / "ratings.csv")
    jcfg = base_config({"root": str(root), "name": "toy"},
                       **{"data.split_way": "rs", "test.neg_samples": "0"})
    jdata = j_load_ranking_data(jcfg)
    data = load_ranking_data(Config(jcfg.to_dict()))
    meta = (data.user_nums, data.item_nums)
    rng = np.random.default_rng(11)
    params = {"P": rng.normal(size=(meta[0], 16)).astype(np.float32),
              "Q": rng.normal(size=(meta[1], 16)).astype(np.float32)}
    jmodel = j_make_model(jcfg, JMeta(*meta))
    model = make_model(Config(jcfg.to_dict()), DataMeta(*meta), device="cpu")
    load_params(model, params)
    users = np.sort(rng.choice(meta[0], B, replace=False))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jdd = j_build_device_data(jdata)
    # The JAX dense program's answer, which every retrieval test holds to.
    want = _jax_answer(j_export_retrieval(jmodel, jparams, {}, jdd, B, K,
                                          backend="dense"), users)
    return types.SimpleNamespace(
        jmodel=jmodel, params=jparams, jdd=jdd, model=model,
        dd=build_device_data(data), users=users, want=want)


def _jax_answer(blob, *args):
    items, scores = j_load_serialized(blob)(*(np.asarray(a, np.int32)
                                              for a in args))
    return np.asarray(items), np.asarray(scores)


def _answer(blob, *args):
    items, scores = load_serialized(blob)(*args)
    return items.numpy(), scores.numpy()


def _graph_ops(blob) -> set:
    program = torch.export.load(io.BytesIO(blob))
    return {str(n.target) for n in program.graph.nodes
            if str(n.target).startswith("cleverrec.")}


def _same(got, want, ties=False):
    """Scores within SCORE_TOL, ids equal (``ties``: except where the
    score is tied within SCORE_TOL with another of the row)."""
    (gi, gv), (wi, wv) = got, want
    assert gi.shape == wi.shape == gv.shape
    np.testing.assert_allclose(gv, wv, rtol=0, atol=SCORE_TOL)
    if not ties:
        np.testing.assert_array_equal(gi, wi)
    for r, j in zip(*np.nonzero(gi != wi)):
        assert (np.abs(np.delete(gv[r], j) - gv[r, j]) <= SCORE_TOL).any()


def _past_budget(dd):
    """The device data of a catalog past the bitmap budget: sorted seen
    rows only."""
    return dataclasses.replace(dd, seen=dd.seen._replace(bits=None))


def test_dense_artifact_matches_jax(toy):
    blob = export_retrieval(toy.model, {}, toy.dd, B, K, backend="dense",
                            device="cpu")
    _same(_answer(blob, toy.users), toy.want)
    assert _graph_ops(blob) == set()
    assert load_retrieval is load_serialized


@pytest.mark.parametrize("seen", ["bits", "rows"])
def test_fused_artifact_keeps_dot_scores(toy, seen):
    """The narrow branch: the program calls the op (its plain version on
    the CPU), gathering bitmap rows or building them from the sorted
    rows past the bitmap budget."""
    dd = toy.dd if seen == "bits" else _past_budget(toy.dd)
    blob = export_retrieval(toy.model, {}, dd, B, K, backend="fused",
                            device="cpu")
    assert _graph_ops(blob) == {"cleverrec.dot_scores.default"}
    got = _answer(blob, toy.users)
    _same(got, toy.want, ties=True)
    live = build_retrieval_fn(toy.model, {}, dd, K, backend="fused",
                              device="cpu")(toy.users)
    np.testing.assert_array_equal(got[0], live[0].numpy())
    np.testing.assert_array_equal(got[1], live[1].numpy())


def test_fused_artifact_past_4096_items_keeps_dot_gmax():
    """A 5,000-item catalog pads to two 4,096-item tiles: the wide branch,
    dot_gmax's group maxes and the rescue, against the JAX dense
    program."""
    n_users, n_items = 40, 5000
    rng = np.random.default_rng(5)
    params = {"P": rng.normal(size=(n_users, 16)).astype(np.float32),
              "Q": rng.normal(size=(n_items, 16)).astype(np.float32)}
    sets = {u: rng.choice(n_items, 60, replace=False).tolist()
            for u in range(n_users)}
    values = {"recommender": "BPR", "embed_size": "16", "reg": "0.01"}
    jmodel = j_make_model(JConfig(values), JMeta(n_users, n_items))
    model = make_model(Config(values), DataMeta(n_users, n_items),
                       device="cpu")
    load_params(model, params)
    jdd = types.SimpleNamespace(seen=j_member_table(sets, n_users, n_items))
    dd = types.SimpleNamespace(seen=build_member_table(sets, n_users,
                                                       n_items))
    users = np.arange(0, n_users, 3)[:B]
    want = _jax_answer(j_export_retrieval(jmodel, params, {}, jdd, B, 20,
                                          backend="dense"), users)
    blob = export_retrieval(model, {}, dd, B, 20, backend="fused",
                            device="cpu")
    assert _graph_ops(blob) == {"cleverrec.dot_gmax.default"}
    _same(_answer(blob, users), want, ties=True)


@pytest.mark.parametrize("seen", ["bits", "rows"])
def test_stream_artifact_matches_jax(toy, seen):
    dd = toy.dd if seen == "bits" else _past_budget(toy.dd)
    blob = export_retrieval(toy.model, {}, dd, B, K, backend="stream",
                            device="cpu")
    _same(_answer(blob, toy.users), toy.want)


def test_rerank_artifact_matches_jax(toy):
    rng = np.random.default_rng(3)
    cand = rng.integers(0, toy.dd.item_nums, (B, 12))
    cand[:, 9:] = -1                              # padding never surfaces
    cand[0, 3:] = -1                              # fewer than k real
    want = _jax_answer(j_export_rerank(toy.jmodel, toy.params, {}, B, 12,
                                       K), toy.users, cand)
    got = _answer(export_rerank(toy.model, {}, B, 12, K, device="cpu"),
                  toy.users, cand)
    _same(got, want)
    assert (got[0][0, 3:] == -1).all()


# A serving process: the port and the bundle, nothing of the test's.
SERVE = """
import json, os, sys
import numpy as np
from cleverrec_tpu_torch.serving import load_serialized
out = sys.argv[1]
meta = json.load(open(os.path.join(out, "meta.json")))
def load(name):
    with open(os.path.join(out, meta["artifacts"][name]), "rb") as f:
        return load_serialized(f.read())
users = np.asarray(json.loads(sys.argv[2]))
cand = np.asarray(json.loads(sys.argv[3]))
print(json.dumps({name: [a.tolist() for a in answer] for name, answer in (
    ("retrieval", load("retrieval")(users)),
    ("rerank", load("rerank")(users, cand)))}))
"""


def test_bundle_manifest_and_a_fresh_process(toy, tmp_path):
    """The manifest has the JAX manifest's keys (``tpu_only`` as
    ``cuda_only``), and a fresh process that imports only the port loads
    the fused program and the rerank program and answers as the live
    functions do."""
    jax_manifest = j_export_bundle(toy.jmodel, toy.params, {}, toy.jdd,
                                   str(tmp_path / "jax"), batch=B, n_cand=6,
                                   k=K)
    out = tmp_path / "bundle"
    manifest = export_bundle(toy.model, {}, toy.dd, str(out), batch=B,
                             n_cand=6, k=K, backend="fused", device="cpu")
    assert json.loads((out / "meta.json").read_text()) == manifest
    want_keys = set(jax_manifest) - {"tpu_only"} | {"cuda_only"}
    assert set(manifest) == want_keys
    assert manifest["backend"] == "fused" and not manifest["cuda_only"]
    assert manifest["artifacts"] == {"retrieval": "retrieval.pt2",
                                     "rerank": "rerank.pt2"}
    for key in ("k", "batch", "n_cand", "filter_seen", "user_nums",
                "item_nums", "model"):
        assert manifest[key] == jax_manifest[key], key
    cand = np.random.default_rng(4).integers(0, toy.dd.item_nums, (B, 6))
    done = subprocess.run(
        [sys.executable, "-c", SERVE, str(out),
         json.dumps(toy.users.tolist()), json.dumps(cand.tolist())],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0, done.stderr[-2000:]
    served = json.loads(done.stdout.strip().splitlines()[-1])
    live = {"retrieval": build_retrieval_fn(toy.model, {}, toy.dd, K,
                                            backend="fused",
                                            device="cpu")(toy.users),
            "rerank": build_rerank_fn(toy.model, {}, K, device="cpu")(
                toy.users, cand)}
    for name, (items, scores) in live.items():
        np.testing.assert_array_equal(served[name][0], items.numpy())
        np.testing.assert_allclose(served[name][1], scores.numpy(), rtol=0,
                                   atol=0)
