"""The synthetic datasets: the published counts exactly, the k-core, no
repeated pair, the same data from the same seed, read back by the
port's loader as written."""

import json

import numpy as np
import pytest

from portbench import harness, synth

CONFIGS = [c["name"] for c in harness.load_bench()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_degree_sequences_hold_the_published_counts(name):
    ds = harness.config(name)["dataset"]
    for n, other, floor, exp in (
            (ds["users"], ds["items"], ds["min_user"], ds["user_exponent"]),
            (ds["items"], ds["users"], ds["min_item"], ds["item_exponent"])):
        deg = synth.degrees(n, ds["interactions"], floor, exp,
                            ds["rank_offset"], other)
        assert len(deg) == n and deg.sum() == ds["interactions"]
        assert deg.min() >= floor and deg.max() <= other
        assert (np.diff(deg) <= 0).all()


def _spec(**kw):
    spec = {"name": "t", "users": 70, "items": 110, "interactions": 1900,
            "min_user": 10, "min_item": 10, "user_exponent": 1.0,
            "item_exponent": 1.0, "rank_offset": 100, "data_seed": 7}
    spec.update(kw)
    return spec


@pytest.mark.parametrize("spec", [_spec(), _spec(interactions=2600,
                                                 user_exponent=1.5),
                                  _spec(users=500, items=900,
                                        interactions=20000, rank_offset=20)])
def test_generated_counts_are_exact_and_ten_core(spec):
    cols = synth.generate(spec)
    u, i = cols["u"], cols["i"]
    assert len(u) == spec["interactions"]
    du = np.bincount(u, minlength=spec["users"])
    di = np.bincount(i, minlength=spec["items"])
    assert len(du) == spec["users"] and len(di) == spec["items"]
    assert du.min() >= spec["min_user"] and di.min() >= spec["min_item"]
    assert len(np.unique(u * spec["items"] + i)) == len(u)


def test_same_seed_same_data_other_seed_other_data():
    a, b = synth.generate(_spec()), synth.generate(_spec())
    c = synth.generate(_spec(data_seed=8))
    assert all((a[k] == b[k]).all() for k in a)
    assert not (a["i"] == c["i"]).all()


def test_cache_is_written_once_and_read_by_the_port(tmp_path):
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.data import load_ranking_data
    spec = _spec()
    out = synth.ensure(spec, str(tmp_path))
    stamp = (tmp_path / "t" / synth.CSV_NAME).stat().st_mtime_ns
    assert synth.ensure(spec, str(tmp_path)) == out
    assert (tmp_path / "t" / synth.CSV_NAME).stat().st_mtime_ns == stamp
    with open(tmp_path / "t" / synth.SPEC_NAME) as f:
        assert json.load(f) == spec
    raw = synth.load_raw(out)
    conf = dict(harness.config(CONFIGS[0])["conf"])
    conf.update({"data.root_dir": str(tmp_path), "data.dataset": "t",
                 "data.file_name": synth.CSV_NAME, "data.sep": ","})
    data = load_ranking_data(Config(conf))
    assert (data.user_nums, data.item_nums, data.ratings_num) == (
        spec["users"], spec["items"], spec["interactions"])
    from portbench.reference.split import split
    sp = split(raw, conf)
    assert sorted((u, i) for u, items in data.ui_train.items()
                  for i in items) == sorted(zip(sp.train_u.tolist(),
                                                sp.train_i.tolist()))
    assert sorted((u, i) for u, items in data.ui_test.items()
                  for i in items) == sorted(zip(sp.test_u.tolist(),
                                                sp.test_i.tolist()))
