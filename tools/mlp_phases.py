"""Where a block of the tower epoch kernel spends its time, on a GPU.

    python3 tools/mlp_phases.py [--seed 0] [--models NeuMF,MLP]

Builds ``csrc/mlp_epoch.cu`` with ``-DMLP_CLOCKS`` (nvcc, ``sm_90a``) into
``build/kernels/phases/``: thread 0 of each block of ``mlp_rows`` then
stamps ``clock64()`` at the end of each phase.  Runs one epoch through
the port's wrapper on ``tools/mlp_ab.py``'s inputs (phase E's shapes)
and reads the stamps of the epoch's last step.  Prints one JSON line per
model: each phase's SM clock cycles, the median and the largest over the
blocks, and the block's whole span; then the card's name, power limit
and SM clock (``nvidia-smi``), at which cycles become time.
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
import mlp_ab  # noqa: E402
from cleverrec_tpu_torch.ops import build  # noqa: E402
from cleverrec_tpu_torch.ops import train as T  # noqa: E402

STAMPS, BLOCKS = 24, 1024   # csrc/mlp_epoch.cu's MLP_STAMPS, MLP_STAMP_BLOCKS


def phase_names(n_layers: int) -> list:
    """The phases the stamps close, in order."""
    back = []
    for l in reversed(range(n_layers)):
        back += [f"dW{l}", f"dx{l}"]
        if l > 0:
            back.append(f"mask+db{l - 1}")
    return (["stage+ids", "gather+scale"]
            + [f"forward{l}" for l in range(n_layers)]
            + ["loss", "dh+top"] + back + ["row grads"])


def probe_lib() -> ctypes.CDLL:
    out = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out, exist_ok=True)
    src, _, _ = build.paths("mlp_epoch")
    lib = os.path.join(out, "libmlp_epoch.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DMLP_CLOCKS", "-o",
                    lib, src], check=True, capture_output=True)
    return ctypes.CDLL(lib)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--models", default="NeuMF,MLP")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("mlp_phases: no CUDA device", file=sys.stderr)
        return 1
    lib = probe_lib()
    build.load = lambda name: lib        # the wrapper loads the probe build
    for name in args.models.split(","):
        cfg, spec, groups, ids, cols = mlp_ab.epoch_inputs(name, args.seed)
        T.fused_mlp_epoch(*groups, *ids, *cols, mlp_ab.T0, spec=spec,
                          lr=cfg.lr)
        torch.cuda.synchronize()
        stamps = np.zeros((BLOCKS, STAMPS), np.int64)
        err = lib.mlp_read_clocks(stamps.ctypes.data_as(ctypes.c_void_p))
        if err != 0:
            raise RuntimeError(f"mlp_read_clocks: cudaError {err}")
        n_layers = (len(spec["dense"]) - 1) // 2
        names = phase_names(n_layers)
        blocks = -(-mlp_ab.B // T.mlp_epoch_plan(
            spec["gmf_width"], [tuple(x.shape) for x in groups[2][:n_layers]],
            mlp_ab.B, torch.cuda.get_device_properties(0)
            .multi_processor_count)["rows"])
        s = stamps[:blocks, :len(names) + 1]
        cycles = np.diff(s, axis=1)
        print(json.dumps({
            "model": name, "blocks": blocks,
            "phases": {n: {"median": int(np.median(cycles[:, k])),
                           "max": int(cycles[:, k].max())}
                       for k, n in enumerate(names)},
            "span": {"median": int(np.median(s[:, -1] - s[:, 0])),
                     "max": int((s[:, -1] - s[:, 0]).max())}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
