"""bf16 state storage (``train.fused_bf16``) in the port against the JAX
package: the BPR epoch's and the rows epoch's plain versions with
``table_dtype=torch.bfloat16`` against the Pallas kernels' bf16 storage
in interpret mode (SBPR's and CUNE_BPR's chain, LRML's form), and the
trainer's choice of storage: bf16 where the option is set on the BPR and
rows protocols, f32 where the grouped epoch or the streamed rows epoch
takes precedence, where a padded table reaches 32,768 rows, and on the
other protocols."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleverrec_tpu.models import make_model as j_make_model
from cleverrec_tpu.models.base import DataMeta as JMeta
from cleverrec_tpu.ops.pallas_train import fused_bpr_epoch as j_bpr_epoch
from cleverrec_tpu.ops.pallas_train import fused_rows_epoch as j_rows_epoch
from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import train as T
from cleverrec_tpu_torch.train import Trainer
from tests.conftest import base_config

# bf16 storage, port against JAX: every state element within one bf16
# ulp (f32 sums in another order can round a value to the neighbouring
# bf16), at most MAX_DIFFER of them differing at all; the loss, an f32
# sum, to LOSS_RTOL.
MAX_DIFFER = 0.02
LOSS_RTOL = 1e-5
BF16 = torch.bfloat16

TRAIN = {"epoches": "1", "batch_size": "64", "embed_size": "16",
         "lr": "0.01", "neg_ratio": "2", "is_pairwise": "True",
         "loss_func": "bpr", "reg": "0.05", "stddev": "0.1",
         "social_file": "trusts.csv", "walk_count": "3",
         "walk_length": "6", "walk_dim": "8", "window_size": "2",
         "topk_f": "5", "train.fused_kernel": "True"}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _bf16_ulps(got, want):
    """Elementwise distance in bf16 ulps of two f32 arrays holding bf16
    values (the bit patterns mapped to one ordered integer line)."""
    def key(x):
        bits = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(bits < 0, -(bits & 0x7FFFFFFF), bits) >> 16
    return np.abs(key(got) - key(want))


def _hold_bf16(got, want, label):
    """``got`` carries bf16 values (it equals its own rounding) and lies
    within one bf16 ulp of ``want``, with few elements differing; returns
    the share that differ."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rounded = torch.as_tensor(got).to(BF16).float().numpy()
    np.testing.assert_array_equal(got, rounded, err_msg=f"{label}: not bf16")
    assert _bf16_ulps(got, want).max() <= 1, label
    differ = float((got != want).mean())
    assert differ <= MAX_DIFFER, (label, differ)
    return differ


# -- the BPR epoch (kernel 2.1) ----------------------------------------------

def _bpr_inputs(seed, t0):
    """tests/test_torch_train.py's kernel shapes: 37 x 53 x 16, 4 steps x
    64, 15% sentinel slots; random moments past step 0."""
    rng = np.random.default_rng(seed)
    u_n, i_n, d, steps, b = 37, 53, 16, 4, 64
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.15
    ids = [np.where(invalid, sent - 1,
                    rng.integers(0, n, (steps, b))).astype(np.int32)
           for n, sent in ((u_n, u_pad), (i_n, i_pad), (i_n, i_pad))]
    state = [rng.normal(size=(n, d)).astype(np.float32) * 0.1
             for n in (u_n, i_n)]
    for n in (u_n, u_n, i_n, i_n):
        m = rng.normal(size=(n, d)).astype(np.float32) * 1e-2
        state.append(np.abs(m) * 1e-2 if len(state) % 2 else m)
    if t0 == 0:
        state[2:] = [np.zeros_like(x) for x in state[2:]]
    return state, ids


@pytest.mark.parametrize("t0", [0, 7])
def test_bpr_epoch_bf16_matches_pallas(t0):
    """fused_bpr_epoch's plain version with bf16 storage against the
    Pallas kernel's (table_dtype=bfloat16, interpret mode): the inputs
    rounded on entry, each slot's row gradients rounded before their
    sum, Adam rounding p, m and v on write."""
    state, ids = _bpr_inputs(3 + t0, t0)
    opts = dict(lr=0.01, reg=0.02)
    want = j_bpr_epoch(*(jnp.asarray(x) for x in (*state, *ids)),
                       jnp.asarray(t0, jnp.int32), **opts, blk=8,
                       interpret=True, table_dtype=jnp.bfloat16)
    got = [_t(x) for x in state]
    before = dict(T.launches)
    loss = T.fused_bpr_epoch(*got, *(_t(x) for x in ids), t0, **opts,
                             table_dtype=BF16)
    assert T.launches == before                  # CPU tensors: plain path
    assert float(loss) == pytest.approx(float(want[6]), rel=LOSS_RTOL)
    for name, g, w in zip(("P", "Q", "mP", "vP", "mQ", "vQ"), got, want):
        assert g.dtype == torch.float32
        _hold_bf16(g.numpy(), _np(w), name)
    # bf16 storage is another result than f32 storage.
    f32 = [_t(x) for x in state]
    T.fused_bpr_epoch(*f32, *(_t(x) for x in ids), t0, **opts)
    assert not torch.equal(f32[0], got[0])


def test_bf16_storage_rounds_on_entry_and_keeps_rounding():
    """A second bf16 epoch on bf16 outputs rounds nothing on entry: every
    value it reads is the one it stored."""
    state, ids = _bpr_inputs(5, 3)
    got = [_t(x) for x in state]
    ids = [_t(x) for x in ids]
    T.fused_bpr_epoch(*got, *ids, 3, lr=0.01, reg=0.02, table_dtype=BF16)
    again = [x.clone() for x in got]
    T._store_bf16(again)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    with pytest.raises(ValueError, match="table_dtype"):
        T.fused_bpr_epoch(*got, *ids, 3, lr=0.01, reg=0.02,
                          table_dtype=torch.float16)


# -- the rows epoch (kernel 2.6) ---------------------------------------------

def _both_models(toy, name, **overrides):
    jcfg = base_config(toy, **{**TRAIN, "recommender": name, **overrides})
    cfg = Config(jcfg.to_dict())
    data = load_ranking_data(cfg)
    jmodel = j_make_model(jcfg, JMeta(data.user_nums, data.item_nums))
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    return jmodel, model


def _chain_inputs(rng, name, u_n, i_n, d, steps, b, t0):
    """The chain's planes (20% masked rows), SBPR's float column, P [U,
    d] and the item table [Q | bias] [I, d + 1], CUNE_BPR's s, moments."""
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.2
    planes = [np.where(invalid, u_pad - 1, rng.integers(0, u_n, (steps, b)))]
    planes += [np.where(invalid, i_pad - 1, rng.integers(0, i_n, (steps, b)))
               for _ in range(3)]
    # suk-like floats that bf16 does not hold exactly (1 + 1/3 ...).
    floats = ([(rng.integers(0, 5, (steps, b)) + rng.random((steps, b)))
               .astype(np.float32)] if name == "SBPR" else [])
    shapes = [(u_n, d), (i_n, d + 1)] + ([()] if name == "CUNE_BPR" else [])
    params = [rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
    if name == "CUNE_BPR":
        params[2] = np.asarray(0.3, np.float32)
    moments = []
    for s in shapes:
        m = rng.normal(size=s).astype(np.float32) * 1e-2
        moments.append((m, np.abs(m) * 1e-2) if t0 else
                       (np.zeros(s, np.float32), np.zeros(s, np.float32)))
    return [p.astype(np.int32) for p in planes], floats, params, moments


@pytest.mark.parametrize("name", ["SBPR", "CUNE_BPR"])
def test_rows_epoch_bf16_on_the_chain_matches_pallas(toy_social_dataset,
                                                     name):
    """The rows epoch's plain version with bf16 storage on the port
    model's chain spec against JAX's fused_rows_epoch(table_dtype=
    bfloat16) in interpret mode on the JAX model's spec: SBPR's float
    column rounded to bf16, CUNE_BPR's dense s read from bf16 storage
    with its gradient summed in f32, the item table [Q | bias] split in
    two on the port's side."""
    jmodel, model = _both_models(toy_social_dataset, name, embed_size="8")
    jspec, spec = jmodel.fused_rows_spec(), model.fused_rows_spec()
    rng = np.random.default_rng(41)
    u_n, i_n, d, steps, b, t0, lr = 29, 41, 8, 3, 48, 7, 0.02
    planes, floats, params, moments = _chain_inputs(rng, name, u_n, i_n, d,
                                                    steps, b, t0)
    sides = tuple(sd for _, sd in spec["planes"])

    def vals(k):
        return [params[n] if k is None else moments[n][k]
                for n in range(len(params))]

    want = j_rows_epoch(
        *(x for k in (None, 0, 1) for x in (
            jnp.asarray(vals(k)[0]), jnp.asarray(vals(k)[1]),
            tuple(jnp.asarray(x) for x in vals(k)[2:]))),
        tuple(jnp.asarray(p) for p in planes),
        tuple(jnp.asarray(f) for f in floats), jnp.asarray(t0, jnp.int32),
        sides=sides, row_loss=jspec["row_loss"], lr=lr, blk=16,
        interpret=True, table_dtype=jnp.bfloat16)
    state = []
    for k in (None, 0, 1):
        item = _t(vals(k)[1])
        state.append(((_t(vals(k)[0]),), (item[:, :d].contiguous(),
                                          item[:, d].contiguous()),
                      tuple(_t(x) for x in vals(k)[2:])))
    loss = T.fused_rows_epoch(*state[0], *state[1], *state[2],
                              [_t(p) for p in planes],
                              [_t(f) for f in floats], t0, sides=sides,
                              spec=spec, lr=lr, table_dtype=BF16)
    assert float(loss) == pytest.approx(float(want[9]), rel=LOSS_RTOL)
    for k, (pu, (q, bias), dense) in enumerate(state):
        w_pu, w_qi, w_dense = want[3 * k:3 * k + 3]
        for label, got, exp in (("P", pu[0], w_pu),
                                ("Q", q, _np(w_qi)[:, :d]),
                                ("bias", bias, _np(w_qi)[:, d]),
                                *(("s", g, e) for g, e in zip(dense,
                                                              w_dense))):
            _hold_bf16(got.numpy(), _np(exp), f"{label}, part {k}")


def test_rows_epoch_bf16_on_lrml_matches_pallas(toy_social_dataset):
    """The same on LRML's form: planes (u, i, j), the dense K and M read
    from bf16 storage, their gradients summed in f32."""
    jmodel, model = _both_models(toy_social_dataset, "LRML", embed_size="8",
                                 mem_size="5", loss_func="hinge",
                                 margin="0.5")
    jspec, spec = jmodel.fused_rows_spec(), model.fused_rows_spec()
    rng = np.random.default_rng(43)
    u_n, i_n, d, mem, steps, b, t0, lr = 29, 41, 8, 5, 3, 48, 7, 0.02
    u_pad, i_pad = T.sentinel_dims(u_n, i_n)
    invalid = rng.random((steps, b)) < 0.2
    planes = [np.where(invalid, (u_pad if sd == "u" else i_pad) - 1,
                       rng.integers(0, u_n if sd == "u" else i_n,
                                    (steps, b))).astype(np.int32)
              for _, sd in spec["planes"]]
    shapes = [(u_n, d), (i_n, d), (d, mem), (mem, d)]
    params = [rng.normal(size=s).astype(np.float32) * 0.3 for s in shapes]
    moments = []
    for s in shapes:
        m = rng.normal(size=s).astype(np.float32) * 1e-2
        moments.append((m, np.abs(m) * 1e-2))

    def vals(k):
        return [params[n] if k is None else moments[n][k] for n in range(4)]

    sides = ("u", "i", "i")
    want = j_rows_epoch(
        *(x for k in (None, 0, 1) for x in (
            jnp.asarray(vals(k)[0]), jnp.asarray(vals(k)[1]),
            (jnp.asarray(vals(k)[2]), jnp.asarray(vals(k)[3])))),
        tuple(jnp.asarray(p) for p in planes), (),
        jnp.asarray(t0, jnp.int32), sides=sides, row_loss=jspec["row_loss"],
        lr=lr, blk=16, interpret=True, table_dtype=jnp.bfloat16)
    got = [((_t(vals(k)[0]),), (_t(vals(k)[1]),),
            (_t(vals(k)[2]), _t(vals(k)[3]))) for k in (None, 0, 1)]
    loss = T.fused_rows_epoch(*(x for g in got for x in g),
                              [_t(p) for p in planes], [], t0, sides=sides,
                              spec=spec, lr=lr, table_dtype=BF16)
    assert float(loss) == pytest.approx(float(want[9]), rel=LOSS_RTOL)
    for k, (pu, qi, dense) in enumerate(got):
        w_pu, w_qi, w_dense = want[3 * k:3 * k + 3]
        for label, g, e in (("P", pu[0], w_pu), ("Q", qi[0], w_qi),
                            ("K", dense[0], w_dense[0]),
                            ("M", dense[1], w_dense[1])):
            _hold_bf16(g.numpy(), _np(e), f"{label}, part {k}")


# -- the trainer's choice of storage -----------------------------------------

def _trainer(toy, name, **overrides):
    _, model = _both_models(toy, name, **overrides)
    cfg = Config(base_config(toy, **{**TRAIN, "recommender": name,
                                     **overrides}).to_dict())
    logger = logging.getLogger(f"test_bf16.{name}")
    logger.setLevel(logging.INFO)
    return Trainer(model, load_ranking_data(cfg), cfg, logger=logger,
                   device="cpu")


@pytest.mark.parametrize("name,extra,dtype,says", [
    ("BPR", {}, BF16, "bf16 state storage"),
    ("SBPR", {}, BF16, "bf16 state storage"),
    ("BPR", {"train.fused_groups": "2"}, torch.float32,
     "yields to the grouped epoch"),
    ("SBPR", {"train.fused_stream": "True"}, torch.float32,
     "yields to train.fused_stream"),
    ("GMF", {"is_pairwise": "False", "loss_func": "cross_entropy"},
     torch.float32, "does not apply"),
])
def test_fused_bf16_selects_the_storage(toy_social_dataset, caplog, name,
                                        extra, dtype, says):
    """``train.fused_bf16`` on the BPR and rows protocols stores bf16; the
    grouped epoch and the streamed rows epoch take precedence with f32,
    as in the JAX trainer; GMF's epoch has f32 storage only.  One log
    line says which."""
    with caplog.at_level(logging.INFO):
        tr = _trainer(toy_social_dataset, name,
                      **{"train.fused_bf16": "True", **extra})
    assert tr.fused and tr.table_dtype == dtype
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("fused epoch kernel:")]
    assert len(lines) == 1 and says in lines[0], lines
    params, state = tr.init_state()
    params, state, losses = tr.train_epochs(params, state, 1)
    assert np.isfinite(losses[0])
    if dtype == BF16:
        for x in (*params.values(), *state.mu.values(), *state.nu.values()):
            x = x.detach()
            assert torch.equal(x, x.to(BF16).float())


def test_fused_bf16_declines_past_the_row_limit(toy_social_dataset,
                                                monkeypatch, caplog):
    """bf16 storage takes padded tables below 32,768 rows (the JAX
    planners' limit); past it the epoch runs in f32 and says so."""
    assert T.bf16_fits(32000, 100)
    assert not T.bf16_fits(32767, 100) and not T.bf16_fits(10, 32767)
    # The toy's 128-row padded tables past a limit of 128.
    monkeypatch.setattr(T, "BF16_MAX_ROWS", 128)
    with caplog.at_level(logging.INFO):
        tr = _trainer(toy_social_dataset, "BPR",
                      **{"train.fused_bf16": "True"})
    assert tr.fused and tr.table_dtype == torch.float32
    assert any("declined" in r.getMessage() for r in caplog.records)
