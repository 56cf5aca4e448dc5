"""The harness finds every piece by name, refuses what is not a name, and
loads neither JAX nor the JAX package; the reference loads nothing of
the port."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.kinds import KINDS

ROOT = harness.ROOT


def test_every_entry_is_found_by_name():
    bench = harness.load_bench()
    for c in bench["configs"]:
        conf = harness.config(c["name"])
        assert conf["name"] == c["name"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        harness.module("configs", c["name"])
        rec = harness.module("recommenders", conf["conf"]["recommender"])
        for entry in ("tables", "weights", "reference"):
            assert callable(getattr(rec, entry))
        assert isinstance(rec.PAD_SLOT_LOSS, float)
        assert rec.CONTROL in ("tf32", "bfloat16", "float16")
    for w in bench["workloads"]:
        assert harness.traffic(w["traffic"])["kind"] in KINDS
        assert harness.config(w["config"])
        assert set(harness.limits(w["name"]))
    for folder, kind in (("end_to_end", "end_to_end"),
                         ("layer_metrics", "per_layer")):
        for m in bench[kind]:
            assert callable(harness.module(folder, m["name"]).read)


def test_each_cell_reports_what_the_contract_asks():
    bench = harness.load_bench()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in harness.metrics_of(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(bench, w["name"], True)
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    m["workloads"]))


@pytest.mark.parametrize("name", ["", "a b", "a/b", "../x", "x,y", "-x",
                                  "é", "a" * 65, None])
def test_names_outside_the_alphabet_are_refused(name):
    with pytest.raises(ValueError):
        harness.check_name(name)
    with pytest.raises(ValueError):
        harness.traffic(name)


@pytest.mark.parametrize("name", ["bpr-amazonbook", "sample_ms.train", "_x",
                                  "a" * 64])
def test_names_inside_the_alphabet_pass(name):
    assert harness.check_name(name) == name


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.workload(harness.load_bench(), "no-such.cell")


FORBIDDEN = ["jax", "jaxlib", "flax", "cleverrec_tpu"]
LOADS = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", LOADS.format(
        root=ROOT, imports=imports)], capture_output=True, text=True,
        check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    bench = harness.load_bench()
    readers = [f"harness.module({f!r}, {m['name']!r})"
               for f, kind in (("end_to_end", "end_to_end"),
                               ("layer_metrics", "per_layer"))
               for m in bench[kind]]
    works = [f"harness.module('configs', {c['name']!r})"
             for c in bench["configs"]] + [
        f"harness.module('recommenders', {r!r})" for r in _recommenders()]
    names = _top_level_names("\n".join([
        "import portbench.run, portbench.calibrate",
        "from portbench import harness, kinds, card, compare, synth",
        # What the kinds load of the port.
        "import cleverrec_tpu_torch.train, cleverrec_tpu_torch.serving",
        "import cleverrec_tpu_torch.data, cleverrec_tpu_torch.models",
        *readers, *works]))
    assert "cleverrec_tpu_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def _recommenders() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(
        harness.HERE, "recommenders")) if f.endswith(".py"))


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level_names("\n".join([
        "import portbench.reference.split, portbench.reference.models, "
        "portbench.reference.ranking, portbench.compare, portbench.synth, "
        "portbench.weights",
        "from portbench import harness",
        *(f"harness.module('recommenders', {r!r})"
          for r in _recommenders())]))
    assert not names & set(FORBIDDEN + ["cleverrec_tpu_torch"])


def test_the_harness_names_no_model():
    # What is a model's own sits in recommenders/<recommender>.py, so a
    # configuration of another model is new files alone.
    for mod in ("kinds.py", "harness.py", "run.py", "compare.py"):
        with open(os.path.join(harness.HERE, mod)) as f:
            text = f.read()
        for rec in _recommenders():
            assert rec not in text, (mod, rec)


def test_run_refuses_without_enough_cards():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "bpr-amazonbook.serve", "--seed", "5", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
