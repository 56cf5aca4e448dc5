"""How far do bf16 storage's kernel and plain version part, step by step?

    python3 tools/bf16_drift.py [--steps 1,2,3,5,0]

(on a GPU).  For BPR (phase C's recipe), SBPR and LRML (their confs) with
``train.fused_bf16=True`` on ``chip_smoke.py``'s rebuilt ml-100k: the
state one bf16 epoch in and the next epoch's draw, its first N steps
(0: the whole epoch) through the kernel (bpr_epoch, rows_epoch) and
through the plain version from that state.  Prints one JSON line a
model and N: each state tensor's share of elements more than one bf16
ulp apart (of the larger of the two values) and its largest difference,
and the loss's relative difference; then the card's name and power
limit.  The two sum each step's row gradients in another order, so a
value near a rounding boundary lands on the neighbouring bf16, and
Adam's normalisation carries a flipped moment into its parameter:
``chip_smoke.py`` holds bf16 over its first BF16_HELD_STEPS steps.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from cleverrec_tpu_torch.ops import train as T  # noqa: E402


def drift(got, want):
    """Each (name, tensor) pair's share past one bf16 ulp and largest
    difference."""
    out = {}
    for (name, g), (_, w) in zip(got, want):
        far = (g - w).abs() > cs.bf16_ulp(torch.maximum(g.abs(), w.abs()))
        out[name] = {"past_one_ulp": far.float().mean().item(),
                     "max_abs": (g - w).abs().max().item()}
    return out


def bpr(steps_list):
    cfg, data, model, _, params, state, tensors = cs.one_epoch_in(
        "BPR", **{"train.fused_bf16": "True"})
    ids = cs.sentinel_ids(data, tensors, ("u", "i", "j"))
    names = ("P", "Q", "mP", "vP", "mQ", "vQ")
    base = (params["P"].detach(), params["Q"].detach(), state.mu["P"],
            state.nu["P"], state.mu["Q"], state.nu["Q"])
    opts = {"lr": cfg.lr, "reg": model.reg, "table_dtype": torch.bfloat16}
    for steps in steps_list:
        held = [x[:steps or None] for x in ids]
        got, want = [x.clone() for x in base], [x.clone() for x in base]
        loss = T.fused_bpr_epoch(*got, *held, state.count, **opts)
        ref = T.fused_bpr_epoch_ref(*want, *held, state.count, **opts)
        torch.cuda.synchronize()
        yield "BPR", held[0].shape[0], loss, ref, list(zip(names, got)), \
            list(zip(names, want))


def rows(name, steps_list):
    cfg, data, model, _, params, state, tensors = cs.one_epoch_in(
        name, **{"train.fused_bf16": "True"})
    spec = model.fused_rows_spec()
    planes = cs.sentinel_ids(data, tensors, [n for n, _ in spec["planes"]])
    floats = [tensors[n].to(torch.float32).contiguous()
              for n in spec["floats"]]
    opts = {"sides": [sd for _, sd in spec["planes"]], "lr": cfg.lr,
            "table_dtype": torch.bfloat16}

    def packed():
        return [(f"{part}{k}.{j}", x.clone())
                for part, t in (("", params), ("m_", state.mu),
                                ("v_", state.nu))
                for k, group in enumerate(spec["pack"](t))
                for j, x in enumerate(group)]

    for steps in steps_list:
        held = [x[:steps or None] for x in planes]
        held_f = [x[:steps or None] for x in floats]
        got, want = packed(), packed()

        def regroup(flat):
            it = iter(x for _, x in flat)
            return [tuple(next(it) for _ in group)
                    for t in (params, state.mu, state.nu)
                    for group in spec["pack"](t)]
        loss = T.fused_rows_epoch(*regroup(got), held, held_f, state.count,
                                  spec=spec, **opts)
        ref = T.fused_rows_epoch_ref(*regroup(want), held, held_f,
                                     state.count, row_loss=spec["row_loss"],
                                     **opts)
        torch.cuda.synchronize()
        yield name, held[0].shape[0], loss, ref, got, want


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", default="1,2,3,5,0")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bf16_drift: no CUDA device", file=sys.stderr)
        return 1
    steps = [int(s) for s in args.steps.split(",")]
    cs.build.build()
    cs.write_ml100k()
    cs.write_trusts()
    runs = [bpr(steps), rows("SBPR", steps), rows("LRML", steps)]
    for run in runs:
        for name, n, loss, ref, got, want in run:
            print(json.dumps({
                "model": name, "steps": n,
                "loss_rel": abs(loss.item() - ref.item()) / abs(ref.item()),
                "tensors": drift(got, want)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
