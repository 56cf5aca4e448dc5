"""The port's CLI: the default recipe's flow (properties files, --set
overrides, train, eval, best epoch) on the toy dataset on the CPU, the
flags that are not ported yet, and the card the default device needs."""

import logging
import os

import pytest
import torch

from cleverrec_tpu_torch import cli
from cleverrec_tpu_torch.utils.logging import get_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def toy_argv(toy_dataset, tmp_path):
    props = tmp_path / "global.properties"
    props.write_text("\n".join([
        "[default]", "recommender=BPR", "model_type=ranking",
        f"data.root_dir={toy_dataset['root']}",
        f"data.dataset={toy_dataset['name']}", "data.file_name=ratings.csv",
        "data.sep=,", "data.format=UIRT", "data.split_way=loo",
        "test.neg_samples=10", "test.batch_size=16", "topk=[5,10]",
        f"log.dir={tmp_path / 'logs'}", "seed=7", ""]))
    return ["--config", str(props), "--conf-dir", os.path.join(REPO, "conf"),
            "--set", "epoches=3", "--set", "batch_size=64",
            "--set", "embed_size=16", "--set", "lr=0.05"]


@pytest.fixture
def records(tmp_path):
    """A function that makes the CLI's logger afresh, as the CLI makes it
    (stdout as it is when called, a file under tmp_path), and returns the
    list a further handler fills with its records."""
    logger = logging.getLogger("cleverrec_tpu_torch.BPR")

    def drop_handlers():
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()

    def make():
        drop_handlers()
        get_logger(str(tmp_path / "logs"), "BPR")
        handler = Records()
        logger.addHandler(handler)
        return handler.records

    yield make
    drop_handlers()


@pytest.mark.parametrize("fused", ["False", "True"])
def test_cli_trains_the_toy_recipe(toy_argv, records, capsys, tmp_path,
                                   fused):
    records = records()
    rc = cli.main(toy_argv + ["--device", "cpu",
                              "--set", f"train.fused_kernel={fused}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Training loss: " in out and "best_epoch: " in out
    assert "best_epoch: " in (tmp_path / "logs" / "BPR.log").read_text()
    epochs = [r.train for r in records if hasattr(r, "train")]
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    assert epochs[-1]["losses"][-1] < epochs[0]["losses"][0]
    evals = [r.eval for r in records if hasattr(r, "eval")]
    assert [e["epoch"] for e in evals] == [1, 2, 3]
    best = [r for r in records if hasattr(r, "best")]
    assert len(best) == 1 and best[0].getMessage().startswith("best_epoch: ")
    assert best[0].best["epoch"] in (1, 2, 3)
    assert sorted(best[0].best["metrics"]) == [5, 10]


def test_cli_evaluates_every_interval(toy_argv, records):
    records = records()
    rc = cli.main(toy_argv + ["--device", "cpu", "--set", "test.interval=2"])
    assert rc == 0
    assert [r.train["epoch"] for r in records if hasattr(r, "train")] == [2, 3]
    assert [r.eval["epoch"] for r in records if hasattr(r, "eval")] == [2]


@pytest.mark.parametrize("flags", [
    ["--mesh", "2x1"], ["--distributed"], ["--export-serving", "out"],
    ["--tune", "--mesh", "2x1"], ["--set", "model_type=rating"],
    ["--set", "nokey"]])
def test_cli_refuses_what_is_not_ported(toy_argv, flags, capsys):
    assert cli.main(toy_argv + ["--device", "cpu"] + flags) == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err or "bad --set" in err


def test_cli_resumes(toy_argv, records, tmp_path):
    """2 epochs with save.best, then --resume to 3: the resumed run starts
    at the saved epoch + 1."""
    saved = ["--device", "cpu", "--set", f"saved_dir={tmp_path / 'saved'}"]
    assert cli.main(toy_argv + saved + ["--set", "epoches=2",
                                        "--set", "save.best=True"]) == 0
    ckpt = tmp_path / "saved" / "BPR"
    assert (ckpt / "state.pt").exists()
    from cleverrec_tpu_torch.train.checkpoint import load_checkpoint
    done = load_checkpoint(str(ckpt))["epoch"]
    got = records()
    assert cli.main(toy_argv + saved + ["--resume", str(ckpt)]) == 0
    assert [r.train["epoch"] for r in got if hasattr(r, "train")] == list(
        range(done + 1, 4))
    assert any(r.getMessage().startswith("resumed from ") for r in got)


def test_cli_tunes(toy_argv, tmp_path, capsys):
    """--tune runs the grid of the list-valued keys (2 x 1 here) and names
    the best trial; --resume and --export-serving are ignored with it."""
    logger = logging.getLogger("cleverrec_tpu_torch.BPR_tune")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    try:
        rc = cli.main(toy_argv + ["--device", "cpu", "--tune",
                                  "--resume", "nowhere",
                                  "--export-serving", "out",
                                  "--set", "embed_size=[8,16]",
                                  "--set", "epoches=1"])
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    assert rc == 0
    out = capsys.readouterr().out
    assert "ignored with --tune" in out
    assert "== trial {'embed_size': '8'}" in out
    assert "== trial {'embed_size': '16'}" in out
    assert "== best trial: {'embed_size': " in out
    assert not os.path.exists("out")


def test_cli_lists_models(capsys):
    assert cli.main(["--list-models"]) == 0
    assert capsys.readouterr().out.split() == [
        "BPR", "CML", "CUNE_BPR", "FISM", "GMF", "LRML", "LightGCN", "MLP",
        "NAIS", "NAIS_single", "NGCF", "NeuMF", "SAMN", "SAMN_single", "SBPR",
        "TBPR", "TransCF"]


def test_cli_default_device_needs_a_card(toy_argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(toy_argv)


@pytest.mark.parametrize("name,flags", [
    ("FISM", []), ("NAIS", ["--set", "atten_size=8"]),
    ("NAIS_single", ["--set", "atten_size=8"]),
    ("NAIS", ["--set", "atten_size=8",
              "--set", "train.bucketed_histories=False"]),
    ("LightGCN", ["--set", "n_layers=2"]), ("NGCF", ["--set", "n_layers=2"]),
    ("LightGCN", ["--set", "n_layers=2", "--set", "graph.dense_budget_mb=0"]),
])
def test_cli_trains_item_and_graph_models(toy_argv, tmp_path, name, flags):
    """FISM, NAIS, NAIS_single, LightGCN and NGCF on their confs, cut to
    the toy, through the CLI on the CPU: each epoch trains and evaluates,
    and the loss falls."""
    logger = logging.getLogger(f"cleverrec_tpu_torch.{name}")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    get_logger(str(tmp_path / "logs"), name)
    handler = Records()
    logger.addHandler(handler)
    try:
        rc = cli.main(toy_argv + ["--device", "cpu", "--model", name,
                                  "--set", "batch_size=128", *flags])
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    assert rc == 0
    epochs = [r.train for r in handler.records if hasattr(r, "train")]
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    assert epochs[-1]["losses"][-1] < epochs[0]["losses"][0]
    best = [r.best for r in handler.records if hasattr(r, "best")]
    assert len(best) == 1 and sorted(best[0]["metrics"]) == [5, 10]
    buckets = [r.buckets for r in handler.records if hasattr(r, "buckets")]
    bucketed = name.startswith("NAIS") and "train.bucketed_histories=False" \
        not in flags
    assert len(buckets) == bucketed
