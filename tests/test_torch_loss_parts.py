"""The loss in per-rank parts (``loss_parts``), which the scan tier's batch
split over ``data`` sums: for every model of the registry and for FM and
FFM, on the toy data, the rows parts of D contiguous chunks of a batch
plus the tables term equal ``loss`` on the whole batch, and their
gradients the whole loss's (D 2 and 3, uneven chunks); ``loss`` equals
rows + tables of the whole batch bit for bit; EATNN's chunked friend-edge
draw is the whole batch's; a model without parts, or a dual batch cut as
one, makes the split raise.  One process, the port alone."""

import os

import numpy as np
import pytest
import torch

from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.data.libfm import load_rating_data
from cleverrec_tpu_torch.models import _REGISTRY, available_models, make_model
from cleverrec_tpu_torch.models.base import DataMeta, RecModel
from cleverrec_tpu_torch.models.bpr import BPR
from cleverrec_tpu_torch.models.extra import EATNN
from cleverrec_tpu_torch.parallel import Mesh
from cleverrec_tpu_torch.parallel.sharding import chunk_bounds
from cleverrec_tpu_torch.rating import make_rating_model
from cleverrec_tpu_torch.train import Trainer
from tests.conftest import make_toy_interactions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The parts' sum against the whole loss: f32 sums in another order.
LOSS_RTOL = 1e-6
# tests/test_parallel.py's tolerances, on the gradients.
RTOL, ATOL = 1e-4, 1e-5
# Each model's conf cut to the toy; the flat batches of the grouped and
# bucketed models (their scan tier).
SHRINK = {"embed_size": "8", "layers": "[16,8]", "mem_size": "4",
          "atten_size": "4", "neg_ratio": "2", "batch_size": "64",
          "train_batches": "4", "walk_count": "2", "walk_length": "5",
          "walk_dim": "8", "window_size": "2", "topk_f": "5",
          "epoches": "1", "test.neg_samples": "10",
          "data.split_by_time": "False", "train.grouped_pairs": "False",
          "train.bucketed_histories": "False"}
PARTS = (2, 3)
SEED = 11


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy with a trust graph (tests/conftest.py's toysoc) and a libFM
    toy."""
    root = tmp_path_factory.mktemp("parts")
    (root / "toysoc").mkdir()
    make_toy_interactions(root / "toysoc" / "ratings.csv", n_users=30,
                          n_rows=500)
    r = np.random.default_rng(5)
    lines = ["u_id,v_id"]
    for u in range(30):
        for v in r.choice(30, size=r.integers(1, 5), replace=False):
            if v != u:
                lines.append(f"{u},{v}")
    (root / "toysoc" / "trusts.csv").write_text("\n".join(lines) + "\n")
    (root / "toyfm").mkdir()
    rng = np.random.default_rng(0)
    for part, n in (("train", 300), ("test", 40)):
        rows = [f"{3.0 + 0.1 * u - 0.05 * i:.3f},{u}:1,{8 + i}:1"
                for u, i in zip(rng.integers(8, size=n),
                                rng.integers(16, size=n))]
        (root / "toyfm" / f"toyfm.{part}.libfm").write_text(
            "\n".join(rows) + "\n")
    return str(root)


def _cfg(root, name, **extra):
    return Config.from_properties(
        os.path.join(REPO, "CleverRec.properties"), os.path.join(REPO, "conf"),
        {"recommender": name, "data.root_dir": root, "data.dataset": "toysoc",
         "data.file_name": "ratings.csv", "data.sep": ",",
         "social_file": "trusts.csv", "seed": "7", **SHRINK, **extra})


def _ranking(root, name):
    """(model, trainer, the first step's batch of the model's scan or
    dual draw) on the CPU."""
    cfg = _cfg(root, name)
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    trainer = Trainer(model, data, cfg, device="cpu")
    trainer.init_state()
    draw = trainer.sample_epoch()
    return model, trainer, {k: v[0] for k, v in draw.items()}


def _gen():
    return torch.Generator().manual_seed(SEED)


def _grads(model, loss):
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}


def _chunks(batch, parts, whole_rows):
    """The batch's D chunks, each leaf cut by ``torch.tensor_split``; with
    ``whole_rows``, each chunk's (lo, hi, n) as the split hands it."""
    for d in range(parts):
        chunk = {k: torch.tensor_split(v, parts)[d] for k, v in batch.items()}
        if whole_rows:
            n = next(iter(batch.values())).shape[0]
            chunk["chunk"] = (*chunk_bounds(n, parts, d), n)
        yield d, chunk


def _hold(got_loss, got_grads, loss, grads, what):
    assert float(got_loss) == pytest.approx(float(loss), rel=LOSS_RTOL), what
    for k, g in grads.items():
        np.testing.assert_allclose(got_grads[k].numpy(), g.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", available_models())
def test_ranking_parts_sum_to_the_loss(toy, name):
    """Every registry model on its first step's batch: rows of every chunk
    plus the tables term equal the whole loss, with its gradients, each
    chunk drawing from a generator in the whole step's state (a rank's),
    for D 2 and 3; rows + tables of the whole batch is ``loss`` bit for
    bit.  The dual models' two domains are cut leaf by leaf and draw
    nothing (their tier never splits)."""
    model, trainer, batch = _ranking(toy, name)
    dual = model.sampler == "dual"
    aux = trainer.aux

    def with_gen(b):
        return b if dual else {**b, "dropout_gen": _gen()}

    loss = model.loss(with_gen(batch), aux)
    grads = _grads(model, loss)
    rows, tables = model.loss_parts(with_gen(batch), aux)
    assert torch.equal((rows + tables).detach(), loss.detach())
    for parts in PARTS:
        total, summed = 0.0, None
        for d, chunk in _chunks(batch, parts, not dual):
            rows, tables = model.loss_parts(with_gen(chunk), aux)
            part = rows + tables if d == 0 else rows
            g = _grads(model, part)
            total = total + part.detach()
            summed = g if summed is None else {
                k: summed[k] + g[k] for k in summed}
        _hold(total, summed, loss.detach(), grads, f"{name} D={parts}")


@pytest.mark.parametrize("name", ["FM", "FFM"])
def test_rating_parts_sum_to_the_loss(toy, name):
    """FM and FFM on a batch of 128 libFM rows: the square loss of each
    chunk plus the L2 table term equal ``loss``, with its gradients; the
    chunks' predictions joined are the whole batch's."""
    cfg = Config.from_properties(
        os.path.join(REPO, "CleverRec.properties"), os.path.join(REPO, "conf"),
        {"recommender": name, "model_type": "rating", "data.root_dir": toy,
         "data.dataset": "toyfm", "train": ".train.libfm",
         "test": ".test.libfm", "is_real_valued": "True", "embed_size": "4",
         "stddev": "0.1"})
    data = load_rating_data(cfg)
    model = make_rating_model(cfg, data)
    model.init(torch.Generator().manual_seed(3))
    rows = torch.randperm(len(data.y_tr), generator=_gen())[:128]
    xs = (torch.as_tensor(data.x_idx_tr)[rows].long(),
          torch.as_tensor(data.x_val_tr)[rows], torch.as_tensor(data.y_tr)[rows],
          (torch.arange(128) < 120).float())
    loss, y_pre = model.loss(*xs)
    grads = _grads(model, loss)
    r, t, _ = model.loss_parts(*xs)
    assert torch.equal((r + t).detach(), loss.detach())
    for parts in PARTS:
        total, summed, preds = 0.0, None, []
        for d in range(parts):
            r, t, p = model.loss_parts(
                *(torch.tensor_split(x, parts)[d] for x in xs))
            part = r + t if d == 0 else r
            g = _grads(model, part)
            total = total + part.detach()
            preds.append(p.detach())
            summed = g if summed is None else {
                k: summed[k] + g[k] for k in summed}
        _hold(total, summed, loss.detach(), grads, f"{name} D={parts}")
        np.testing.assert_allclose(torch.cat(preds).numpy(),
                                   y_pre.detach().numpy(), rtol=1e-6)


def test_eatnn_chunked_edge_draw_is_the_whole_batchs(toy):
    """EATNN's friend edges of a chunk (lo, hi, n) are rows lo:hi of the
    whole batch's draw, and the generator ends where the whole draw
    leaves it, for every chunk of D 2 and 3."""
    u = torch.arange(65) % 30
    whole_gen = _gen()
    whole = EATNN.edge_draw(u, 50, whole_gen)
    for parts in PARTS:
        for d in range(parts):
            lo, hi = chunk_bounds(65, parts, d)
            gen = _gen()
            got = EATNN.edge_draw(u[lo:hi], 50, gen, (lo, hi, 65))
            assert torch.equal(got, whole[lo:hi])
            assert torch.equal(gen.get_state(), whole_gen.get_state())


def test_the_split_refuses_a_model_without_parts(toy):
    """A registry class whose loss_parts is the base's makes the scan
    tier's split over a 2 x 1 mesh raise, naming the model; a dual batch
    cut as one batch raises too.  Neither falls back to the whole step."""
    cfg = _cfg(toy, "BPR")
    data = load_ranking_data(cfg)
    unsplit = type("Unsplit", (BPR,), {"name": "Unsplit",
                                       "loss_parts": RecModel.loss_parts})
    model = unsplit(cfg, DataMeta(data.user_nums, data.item_nums))
    model.init(_gen())
    with pytest.raises(ValueError, match="Unsplit has no loss_parts"):
        Trainer(model, data, cfg, device="cpu", mesh=Mesh(2, 1, "cpu"))
    assert all(c.loss_parts is not RecModel.loss_parts
               for c in _REGISTRY.values())
    model, trainer, batch = _ranking(toy, "SoHRML")
    with pytest.raises(ValueError, match="does not split"):
        model.loss_parts({**batch, "chunk": (0, 1, 2)}, trainer.aux)
