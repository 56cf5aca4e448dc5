"""The port's numpy-only loader, device arrays and membership tables
against the JAX package's on the toy datasets: every array equal."""

import numpy as np
import pytest
import torch

from cleverrec_tpu.data import build_device_data as j_build_device_data
from cleverrec_tpu.data import load_ranking_data as j_load_ranking_data
from cleverrec_tpu.sampling import rows_to_bits as j_rows_to_bits
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import build_device_data, load_ranking_data
from cleverrec_tpu_torch.sampling import rows_to_bits
from tests.conftest import base_config, make_toy_interactions

CASES = {
    "loo_candidates": {},
    "loo_time_sorted": {"data.split_by_time": "True"},
    "rs_candidates": {"data.split_way": "rs"},
    "rs_full_catalog": {"data.split_way": "rs", "test.neg_samples": "0",
                        "data.split_by_time": "True"},
    "rs_filtered": {"data.split_way": "rs", "test.neg_samples": "0",
                    "data.user_min": "12", "data.item_min": "8",
                    "data.split_ratio": "[0.6,0.1,0.3]"},
}


def _load_both(toy, overrides):
    jcfg = base_config(toy, **overrides)
    return (j_load_ranking_data(jcfg),
            load_ranking_data(Config(jcfg.to_dict())))


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_and_device_data_match_jax(toy_dataset, case):
    want, got = _load_both(toy_dataset, CASES[case])
    assert (got.user_nums, got.item_nums, got.ratings_num) == (
        want.user_nums, want.item_nums, want.ratings_num)
    assert got.candidate_eval == want.candidate_eval
    # Same users in the same (ascending) order, same items in row order.
    for g, w in ((got.ui_train, want.ui_train), (got.ui_test, want.ui_test)):
        assert list(g) == list(w)
        assert all(g[u] == list(w[u]) for u in w)

    dw, dg = j_build_device_data(want), build_device_data(got)
    np.testing.assert_array_equal(dg.pos_u, dw.pos_u)
    np.testing.assert_array_equal(dg.pos_i, dw.pos_i)
    np.testing.assert_array_equal(dg.test_users, dw.test_users)
    np.testing.assert_array_equal(dg.real_padded, dw.real_padded)
    if want.candidate_eval:
        np.testing.assert_array_equal(dg.cand, dw.cand)
        np.testing.assert_array_equal(dg.cand_mask, dw.cand_mask)
    else:
        assert dg.cand is None and dg.cand_mask is None
    np.testing.assert_array_equal(dg.seen.rows, np.asarray(dw.seen.rows))
    np.testing.assert_array_equal(dg.seen.lens, np.asarray(dw.seen.lens))
    assert dg.seen.bits.dtype == np.int32
    np.testing.assert_array_equal(dg.seen.bits.view(np.uint32),
                                  np.asarray(dw.seen.bits))


def test_multichar_separator_matches_jax(tmp_path):
    """'::' files (ml-1m style) go through the numpy reader's split path."""
    ds = tmp_path / "toy"
    ds.mkdir()
    make_toy_interactions(ds / "ratings.csv", seed=4)
    text = (ds / "ratings.csv").read_text().replace(",", "::")
    (ds / "ratings.csv").write_text(text)
    toy = {"root": str(tmp_path), "name": "toy"}
    want, got = _load_both(toy, {"data.sep": "::"})
    assert got.ui_train == want.ui_train and got.ui_test == want.ui_test


def test_rows_to_bits_matches_jax(toy_dataset):
    _, got = _load_both(toy_dataset, {})
    seen = build_device_data(got).seen
    want = np.asarray(j_rows_to_bits(seen.rows, got.item_nums))
    bits = rows_to_bits(torch.as_tensor(seen.rows), got.item_nums)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(bits.numpy(), seen.bits)
    # Bit 31 of a word: two's complement in int32.
    rows = torch.tensor([[31, 63, 64]])
    np.testing.assert_array_equal(
        rows_to_bits(rows, 64).numpy().view(np.uint32),
        np.asarray(j_rows_to_bits(rows.numpy().astype(np.int32), 64)))


def _spy_numpy(monkeypatch):
    """Records each call of the numpy parser (and still parses)."""
    from cleverrec_tpu_torch.data import fastcsv
    calls = []
    real = fastcsv._numpy_columns

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(fastcsv, "_numpy_columns", spy)
    return calls


# Each file's lines, header first: the native parser's (one-byte
# separator, numeric first data line) against the numpy parser's.
NATIVE_FILES = {
    "extra_columns": "u,i,r,t,note\n1,2,3.5,17,x\n4,5,1,18,yy\n\n7,8,2,19,z\n",
    "crlf": "u\ti\tr\r\n1\t2\t3.5\r\n4\t5\t1e1\r\n-7\t8\t+2\r\n",
}


@pytest.mark.parametrize("name", sorted(NATIVE_FILES))
def test_native_parser_matches_numpy(tmp_path, monkeypatch, name):
    from cleverrec_tpu_torch.data import fastcsv
    path = tmp_path / "f.csv"
    path.write_bytes(NATIVE_FILES[name].encode())
    sep = "\t" if name == "crlf" else ","
    calls = _spy_numpy(monkeypatch)
    got = fastcsv.read_columns(str(path), sep, 3)
    assert calls == []                         # the native parser took it
    want = fastcsv._numpy_columns(str(path), sep, 3, True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and len(g) == 3
        np.testing.assert_array_equal(g, w)


def test_parser_routes_like_the_jax_package(tmp_path, monkeypatch):
    """A non-numeric first data line and a '::' file go to numpy (which
    raises on a field that is not a number, where the native parser
    would read 0); the '::' file's columns equal the native parser's on
    the same table with ','."""
    from cleverrec_tpu_torch.data import fastcsv
    calls = _spy_numpy(monkeypatch)
    bad = tmp_path / "bad.csv"
    bad.write_text("u,i,r\nx,2,3\n4,5,1\n")
    with pytest.raises(ValueError):
        fastcsv.read_columns(str(bad), ",", 3)
    assert len(calls) == 1
    short = tmp_path / "short.csv"
    short.write_text("u,i,r\n1,2\n4,5,1\n")
    with pytest.raises(ValueError):
        fastcsv.read_columns(str(short), ",", 3)
    assert len(calls) == 2
    ds = tmp_path / "toy"
    ds.mkdir()
    make_toy_interactions(ds / "ratings.csv", seed=4)
    text = (ds / "ratings.csv").read_text()
    (ds / "ratings.dat").write_text(text.replace(",", "::"))
    native = fastcsv.read_columns(str(ds / "ratings.csv"), ",", 4)
    assert len(calls) == 2
    split = fastcsv.read_columns(str(ds / "ratings.dat"), "::", 4)
    assert len(calls) == 3
    for a, b in zip(native, split):
        np.testing.assert_array_equal(a, b)
