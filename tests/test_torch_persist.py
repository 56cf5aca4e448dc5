"""The persistent epoch kernels' host side on the CPU: the grid plan of
``csrc/persist.cuh`` (one wave from the SM count and the blocks an SM
holds), BPR's plan (every shape its int32 arguments hold), GMF's width
limit and CML's scratch past shared memory, the trainer keeping both on
the fused tier at any width the kernels take, and the order in which CML's plain version sums its distances (the order
of ``csrc/cml_epoch.cu``), held against an independent numpy emulation."""

import math

import numpy as np
import pytest
import torch

from cleverrec_tpu_torch.config import Config
from cleverrec_tpu_torch.data import load_ranking_data
from cleverrec_tpu_torch.models import make_model
from cleverrec_tpu_torch.models.base import DataMeta
from cleverrec_tpu_torch.ops import train as T
from cleverrec_tpu_torch.train import Trainer
from tests.conftest import base_config


@pytest.mark.parametrize("sms,per_sm,steps,threads", [
    (132, 1, 17, 512), (132, 1, 81, 1024), (132, 2, 81, 512),
    (132, 3, 0, 512), (1, 1, 1, 512), (7, 4, 210, 512), (100000, 1, 2, 1024)])
def test_persist_plan_fills_one_wave(sms, per_sm, steps, threads):
    """Every SM holds ``per_sm`` blocks at once, so the grid is exactly one
    wave of them (a cooperative launch keeps it resident across the
    barriers), and part_loss is a slice of the blocks a step."""
    plan = T.persist_plan(sms, per_sm, steps, threads)
    assert plan["blocks"] == sms * per_sm
    assert plan["threads"] == threads
    assert plan["warps"] == plan["blocks"] * threads // 32
    assert plan["part_loss"] == (steps, plan["blocks"])
    assert T.persist_plan(sms, per_sm)["threads"] == T.PERSIST_THREADS


@pytest.mark.parametrize("sms,per_sm", [(132, 0), (0, 2), (-1, 1)])
def test_persist_plan_refuses_a_kernel_that_fits_no_sm(sms, per_sm):
    with pytest.raises(ValueError, match="fits an SM"):
        T.persist_plan(sms, per_sm)


@pytest.mark.parametrize("sms,per_sm,threads,steps", [
    (132, 1, 768, 67), (132, 1, 768, 0), (1, 1, 768, 3), (7, 2, 256, 210),
    (100000, 1, 768, 2)])
def test_bpr_epoch_plan_takes_one_wave(sms, per_sm, threads, steps):
    """The SMs times the blocks an SM holds, at the kernel's own threads a
    block (bpr_epoch_occupancy reports both); part_loss a slice of the
    blocks a step."""
    plan = T.bpr_epoch_plan(943, 1682, 128, steps, sms, per_sm, threads)
    assert plan["blocks"] == sms * per_sm and plan["threads"] == threads
    assert plan["part_loss"] == (steps, sms * per_sm)
    assert plan["warps"] == sms * per_sm * threads // 32


@pytest.mark.parametrize("u,i,d,steps,b,t0", [
    (2 ** 31 - 1, 2 ** 31 - 1, 1, 1, 1, 0), (5, 7, 2 ** 31 - 1, 1, 1, 0),
    (2 ** 31 - 1, 1, 2 ** 31 - 1, 0, 0, 0), (0, 0, 0, 0, 0, 0),
    (943, 1682, 128, 65, 2 ** 31 - 1, 0),
    (943, 1682, 128, 65, 6144, 2 ** 31 - 66)])
def test_bpr_epoch_plan_has_no_limit_short_of_int32(u, i, d, steps, b, t0):
    """Every shape the kernel's int32 arguments hold has a plan: no width
    or size limit, no other tier."""
    assert T.bpr_epoch_plan(u, i, d, steps, 132, b=b, t0=t0)["blocks"] == 132


@pytest.mark.parametrize("u,i,d,steps,b,t0", [
    (-1, 5, 8, 1, 1, 0), (5, -1, 8, 1, 1, 0), (5, 7, -1, 1, 1, 0),
    (2 ** 31, 5, 8, 1, 1, 0), (5, 7, 2 ** 31, 1, 1, 0),
    (5, 7, 8, 1, 2 ** 31, 0), (5, 7, 8, 65, 6144, 2 ** 31 - 65)])
def test_bpr_epoch_plan_refuses_shapes_past_int32(u, i, d, steps, b, t0):
    with pytest.raises(ValueError, match="fused_bpr_epoch.*int32"):
        T.bpr_epoch_plan(u, i, d, steps, 132, b=b, t0=t0)


def test_bpr_epoch_plan_refuses_a_kernel_that_fits_no_sm():
    with pytest.raises(ValueError, match="fits an SM"):
        T.bpr_epoch_plan(943, 1682, 128, 65, 132, 0, 768)


@pytest.mark.parametrize("d", [1, 18, 64, 65, 200, 256, 300, 4096])
def test_gmf_epoch_plan_takes_widths_up_to_4096(d):
    """And on up to GMF_MAX_D, 4096 (past 64 the wide kernel)."""
    plan = T.gmf_epoch_plan(d, steps=81, sms=132, per_sm=2)
    assert plan["blocks"] == 264 and plan["part"] == (264, d)
    assert plan["part_loss"] == (81, 264)


@pytest.mark.parametrize("d", [0, 4097, 5000])
def test_gmf_epoch_plan_refuses_other_widths(d):
    with pytest.raises(ValueError, match="4096"):
        T.gmf_epoch_plan(d)


@pytest.mark.parametrize("d", [1, 18, 128, 3584, 3585, 5000])
def test_cml_epoch_plan_takes_widths_up_to_3584(d):
    """And past it: up to CML_SMEM_D the warps' column sums sit in shared memory; past
    it in a [blocks, 16, d] scratch (no width limit)."""
    plan = T.cml_epoch_plan(d, steps=17, sms=132, per_sm=1)
    assert plan["blocks"] == 132 and plan["part"] == (132, d)
    assert plan["part_loss"] == (17, 132)
    assert plan["colwarp"] == (None if d <= T.CML_SMEM_D else (132, 16, d))


@pytest.mark.parametrize("d", [0, -3])
def test_cml_epoch_plan_refuses_other_widths(d):
    with pytest.raises(ValueError, match="at least 1"):
        T.cml_epoch_plan(d)


@pytest.mark.parametrize("name,embed", [("GMF", 16), ("GMF", 256),
                                        ("GMF", 300), ("GMF", 4096),
                                        ("CML", 4000)])
def test_trainer_keeps_the_fused_tier_at_wide_widths(toy_dataset, name,
                                                     embed):
    """The GMF and CML kernels take these widths, so the trainer trains
    them on the fused tier (no route to the scan tier)."""
    extra = ({"loss_func": "cross_entropy"} if name == "GMF" else
             {"loss_func": "hinge", "margin": "0.5", "reg": "1.0",
              "neg_ratio": "3"})
    cfg = Config(base_config(toy_dataset, recommender=name,
                             embed_size=str(embed), is_pairwise="False",
                             optimizer="Adam",
                             **{**extra, "train.fused_kernel": "True"}
                             ).to_dict())
    data = load_ranking_data(cfg)
    model = make_model(cfg, DataMeta(data.user_nums, data.item_nums),
                       device="cpu")
    assert Trainer(model, data, cfg, device="cpu").fused is True


def _emulate(a, b, width):
    """|a - b|^2 of each row as a warp of csrc/cml_epoch.cu adds it, one
    f32 operation at a time: lane l adds the squares of columns
    32 width p + width l + e, p-major, then the xor butterfly."""
    d = a.shape[-1]
    passes = math.ceil(d / (32 * width))
    out = np.empty(a.shape[0], np.float32)
    for r in range(a.shape[0]):
        lanes = np.zeros(32, np.float32)
        for lane in range(32):
            acc = np.float32(0)
            for p in range(passes):
                for e in range(width):
                    c = 32 * width * p + width * lane + e
                    x = np.float32(a[r, c] - b[r, c]) if c < d else \
                        np.float32(0)
                    acc = np.float32(acc + np.float32(x * x))
            lanes[lane] = acc
        off = 16
        while off:
            lanes = (lanes + lanes[np.arange(32) ^ off]).astype(np.float32)
            off //= 2
        out[r] = lanes[0]
    return out


@pytest.mark.parametrize("width,d", [(1, 8), (1, 18), (1, 40), (1, 130),
                                     (4, 8), (4, 40), (4, 128), (4, 200)])
def test_lane_sq_dist_sums_in_the_kernels_order(width, d):
    """_lane_sq_dist is bit for bit the kernel's sum, in both variants, on
    rows whose squares span many magnitudes (so that another order would
    round differently)."""
    rng = np.random.default_rng(d + width)
    a = (rng.normal(size=(40, d)) * 10.0 ** rng.integers(-3, 3, (40, d))
         ).astype(np.float32)
    b = rng.normal(size=(40, d)).astype(np.float32)
    got = T._lane_sq_dist(torch.as_tensor(a), torch.as_tensor(b), width)
    np.testing.assert_array_equal(got.numpy(), _emulate(a, b, width))
    if d > 32:
        # The other variant's order is another sum: the test can tell them
        # apart.
        other = T._lane_sq_dist(torch.as_tensor(a), torch.as_tensor(b),
                                5 - width)
        assert not np.array_equal(other.numpy(), got.numpy())


def test_cml_width_follows_alignment():
    p, q = torch.zeros(5, 16), torch.zeros(7, 16)
    moments = [torch.zeros_like(x) for x in (p, p, q, q)]
    assert T.cml_width(p, q, *moments) == 4
    buf = torch.zeros(7 * 16 + 1)
    assert T.cml_width(p, buf[1:].view(7, 16), *moments) == 1
    p18, q18 = torch.zeros(5, 18), torch.zeros(7, 18)
    assert T.cml_width(p18, q18, *(torch.zeros_like(x)
                                   for x in (p18, p18, q18, q18))) == 1
