"""Small stand-ins for the benchmark's configurations, for CPU tests.

``small(cell)`` gives a cell's configuration and traffic mix at a size a
test can hold: the same conf keys and kinds, a few dozen users and
items, narrow tables.  Tests that need the card are marked ``cuda`` and
skip inside the ``card`` fixture where there is none.
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def small(cell: str):
    """(bench, conf, mix) of ``cell`` at a test's size."""
    bench = harness.load_bench()
    w = harness.workload(bench, cell)
    conf = copy.deepcopy(harness.config(w["config"]))
    conf["dataset"].update(users=60, items=90, interactions=1500,
                           name=f"small-{conf['dataset']['name']}")
    conf["conf"].update({"embed_size": "16", "batch_size": "128",
                         "test.batch_size": "32"})
    mix = dict(harness.traffic(w["traffic"]))
    if mix["kind"] == "train":
        # The card's tier where the model has an epoch kernel (the fused
        # tier), on the kernel's plain version.
        conf["conf"]["train.fused_kernel"] = "True"
    if mix["kind"] == "eval":
        # The card's evaluator mode (full_fused), on the kernels' plain
        # versions.
        conf["conf"]["eval.fused_kernel"] = "True"
    if mix["kind"] == "serve":
        mix.update(users_per_call=12, pool_calls=4, check_calls=4)
        if "calls_per_s" in mix:
            mix["calls_per_s"] = 2000
    return bench, conf, mix


@pytest.fixture
def run_small(tmp_path):
    """run_small(cell, device="cpu", replace=None) -> the result fields of
    a short run of ``cell`` at a test's size."""
    import time

    def run(cell, device="cpu", replace=None, seed=2_500_000_017):
        bench, conf, mix = small(cell)
        return harness.run_cell(cell, seed, 0.2, False, device,
                                time.perf_counter(), bench=bench, conf=conf,
                                mix=mix, data_root=str(tmp_path),
                                replace=replace)
    return run


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda:0"
