"""Where a block of the rows epoch kernels spends its time, on a GPU.

    python3 tools/rows_phases.py [--lrml-epochs 20] [--no-atomics]

Builds ``csrc/rows_epoch.cu`` with ``-DROWS_CLOCKS`` (nvcc, ``sm_90a``)
into ``build/kernels/phases/``: thread 0 of each block of ``lrml_tiles``
then adds up the ``clock64()`` cycles of each phase over the block's tiles
(each phase ends at a barrier), and thread 0 of each block of
``rows_chain`` times its warp's rows: their loads, dots and loss, their
grads and atomics, and the block's slice.  Runs one epoch through the port's wrapper on
``tools/rows_ab.py``'s inputs (phases F's and G's shapes) and reads the
cycles of the epoch's last step.  Prints one JSON line per input: each
phase's SM clock cycles, the median and the largest over the blocks, and
the device ms of an epoch of this build by kernel (torch.profiler); then
the card's name, power limit and SM clock (``nvidia-smi``), at which
cycles become time.  ``--no-atomics`` also builds with
``-DROWS_NO_ATOMICS``: the row-gradient float4 atomics are left out (the
results are then wrong), so the two runs' device ms give the atomics'
share.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
import rows_ab  # noqa: E402
from cleverrec_tpu_torch.models import make_model  # noqa: E402
from cleverrec_tpu_torch.models.base import DataMeta  # noqa: E402
from cleverrec_tpu_torch.ops import build  # noqa: E402
from cleverrec_tpu_torch.ops import train as T  # noqa: E402

# csrc/rows_epoch.cu's ROWS_PHASES, ROWS_STAMP_BLOCKS
PHASES, BLOCKS = 15, 1024
NAMES = {"chain": ["loads+dots+loss", "grads+atomics", "block slice"],
         "lrml": ["stage K, M", "ids", "gather rows", "a = ue * x",
                  "logits a K", "softmax", "r = att M, e", "dist+hinge",
                  "active list+loss", "g_att = g_e M^T, dM", "g_l",
                  "dK", "g_a = g_l K^T", "row grads (atomics)",
                  "slice store"]}


def probe_lib(no_atomics: bool) -> ctypes.CDLL:
    out = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out, exist_ok=True)
    src, _, _ = build.paths("rows_epoch")
    flags = ["-DROWS_CLOCKS"] + (["-DROWS_NO_ATOMICS"] if no_atomics else [])
    lib = os.path.join(out, f"librows_epoch{'_na' if no_atomics else ''}.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", lib, src],
                   check=True, capture_output=True)
    return ctypes.CDLL(lib)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--lrml-epochs", type=int, default=20)
    parser.add_argument("--no-atomics", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("rows_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    rows_ab.make_inputs(args.lrml_epochs)
    lib = probe_lib(args.no_atomics)
    build.load = lambda name: lib        # the wrapper loads the probe build
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rec in torch.load(rows_ab.INPUTS):
        cfg = cs.config("ml-100k", recommender=rec["model"])
        spec = make_model(cfg, DataMeta(rec["U"], rec["I"]),
                          device="cpu").fused_rows_spec()
        planes = [x.cuda() for x in rec["planes"]]
        floats = [x.cuda() for x in rec["floats"]]
        state = [tuple(x.cuda() for x in g) for g in rec["groups"]]

        def epoch():
            T.fused_rows_epoch(*state, planes, floats, rec["t0"],
                               sides=[sd for _, sd in spec["planes"]],
                               spec=spec, lr=rec["lr"])
        device_ms = rows_ab.by_kernel(epoch)
        epoch()
        torch.cuda.synchronize()
        cycles = np.zeros((BLOCKS, PHASES), np.int64)
        err = lib.rows_read_clocks(cycles.ctypes.data_as(ctypes.c_void_p))
        if err != 0:
            raise RuntimeError(f"rows_read_clocks: cudaError {err}")
        plan = T.rows_epoch_plan(spec, planes[0].shape[1], sms)
        names = NAMES[plan["form"]]
        c = cycles[:min(plan["blocks"], BLOCKS), :len(names)]
        print(json.dumps({
            "model": rec["model"], "epochs_in": rec["epochs_in"],
            "active_share": rec.get("active_share"), "blocks": plan["blocks"],
            "no_atomics": args.no_atomics, "device_ms": device_ms,
            "phases": {n: {"median": int(np.median(c[:, k])),
                           "max": int(c[:, k].max())}
                       for k, n in enumerate(names)},
            "sum_of_medians": int(np.median(c, axis=0).sum())}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
