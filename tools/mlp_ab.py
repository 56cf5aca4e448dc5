"""Time the tower epoch kernel (``mlp_epoch``) of this checkout against
another checkout's (the parent commit's) on one GPU, in turns: parent,
change, change, parent.

    python3 tools/mlp_ab.py --parent DIR [--seed 0] [--models NeuMF,MLP]

Each turn is a process that imports one checkout's package, which builds
that checkout's ``csrc/mlp_epoch.cu`` on first use: each version runs
through its own wrapper and its own argument struct.  The inputs are the
shapes of ``chip_smoke.py``'s phase E: ml-100k's 943 users and 1,682
items, batches of 6,144 rows, 81 steps (495,285 real rows, the last
step's tail padded with w = 0 at the sentinel ids), each model at the
widths and regularisers of its conf (``conf/NeuMF.properties``,
``conf/MLP.properties``), its parameters from the model's own seeded
init, Adam moments and the draw from numpy with ``--seed``, Adam's step
count 81.  Each turn, for each model:

- holds the kernel to its plain version over ``MLP_HELD_STEPS`` steps
  with ``chip_smoke.mlp_hold`` (the tolerances of the smoke);
- times whole epochs: ``ms`` is CUDA events over 5 epochs, a mean;
  ``device_ms`` the device time of one epoch by kernel name
  (torch.profiler over 3 epochs), with their sum;
- names the row tile and the blocks of a step.

Prints one JSON line per (model, version, turn), then the card's name
and power limit; exits 1 if any hold failed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("parent", "change", "change", "parent")
U, I, B, STEPS, REAL = 943, 1682, 6144, 81, 495285
T0 = 81
CONFS = {"NeuMF": {"embed_size": "64", "layers": "[128,64,32]",
                   "reg1": "0.01", "reg2": "0.01"},
         "MLP": {"layers": "[128,64,32]", "reg": "0.01"}}


def epoch_inputs(name: str, seed: int):
    """(cfg, spec, the state groups of mlp_run's order on the card, ids,
    cols) of one model, from the imported checkout's package."""
    from cleverrec_tpu_torch.config import Config
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.ops import train as T
    cfg = Config({"recommender": name, "lr": "0.001", "stddev": "0.01",
                  "seed": str(seed), **CONFS[name]})
    model = make_model(cfg, DataMeta(U, I), device="cpu")
    spec = model.fused_mlp_spec()
    p = {n: x.detach() for n, x in model.named_parameters()}
    rng = np.random.default_rng(seed)
    groups = []
    for scale in (None, 1e-3, 1e-7):
        t = {n: x if scale is None else torch.as_tensor(
            rng.normal(size=tuple(x.shape)).astype(np.float32)) * scale
            for n, x in p.items()}
        if scale is not None and scale < 1e-3:
            t = {n: x.abs() for n, x in t.items()}
        groups += [torch.cat([t[n] for n in spec["u"]], 1).cuda(),
                   torch.cat([t[n] for n in spec["i"]], 1).cuda(),
                   [t[n].cuda() for n in spec["dense"]]]
    u_pad, i_pad = T.sentinel_dims(U, I)
    real = (np.arange(STEPS * B) < REAL).reshape(STEPS, B)
    ids = [torch.as_tensor(np.where(real, rng.integers(0, n, (STEPS, B)),
                                    pad - 1).astype(np.int32)).cuda()
           for n, pad in ((U, u_pad), (I, i_pad))]
    cols = [torch.as_tensor((rng.random((STEPS, B)) < 0.2)
                            .astype(np.float32)).cuda(),
            torch.as_tensor(real.astype(np.float32)).cuda()]
    return cfg, spec, groups, ids, cols


def copies(groups):
    return [[x.clone() for x in g] if isinstance(g, list) else g.clone()
            for g in groups]


def by_kernel(fn, calls: int = 3) -> dict:
    """Device ms of one fn() call by kernel name (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            key = re.match(r"(?:void )?([\w:]*)", name).group(1)
            key = key.split("::")[-1] or name[:40]
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def plan(T, dg, shapes, sms):
    """The row tile and blocks a step, through whichever signature the
    checkout's ``mlp_epoch_plan`` has."""
    try:
        lay = T.mlp_epoch_plan(dg, shapes, b=B, sms=sms)
    except TypeError:
        lay = T.mlp_epoch_plan(dg, shapes)
    return lay["rows"], -(-B // lay["rows"])


def time_tree(tree: str, seed: int, models) -> None:
    """One turn: ``tree``'s kernel on every model, a JSON line each."""
    sys.path[:0] = [tree]
    import chip_smoke as cs
    from cleverrec_tpu_torch.ops import train as T
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in models:
        cfg, spec, groups, ids, cols = epoch_inputs(name, seed)
        head = [x[:cs.MLP_HELD_STEPS] for x in ids + cols]
        got, want = copies(groups), copies(groups)
        loss = T.fused_mlp_epoch(*got, *head, T0, spec=spec, lr=cfg.lr)
        ref = T.fused_mlp_epoch_ref(*want, *head, T0,
                                    row_loss=spec["row_loss"], lr=cfg.lr)
        torch.cuda.synchronize()
        try:
            errors, loss_rel = cs.mlp_hold(spec, got, want, loss, ref)
            held = True
        except cs.SmokeError as e:
            errors, loss_rel, held = {}, None, str(e)
        state = copies(groups)

        def epoch():
            T.fused_mlp_epoch(*state, *ids, *cols, T0, spec=spec, lr=cfg.lr)
        n_layers = (len(spec["dense"]) - 1) // 2
        shapes = [tuple(x.shape) for x in groups[2][:n_layers]]
        rows, blocks = plan(T, spec["gmf_width"], shapes, sms)
        split = by_kernel(epoch)
        print(json.dumps({
            "model": name, "rows": rows, "blocks": blocks, "steps": STEPS,
            "held": held, "max_err": max(errors.values(), default=None),
            "loss_rel_err": loss_rel, "ms": cs.timed(epoch, iters=5)[0],
            "device_ms": sum(split.values()), "by_kernel": split}),
            flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--models", default="NeuMF,MLP")
    parser.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("mlp_ab: no CUDA device", file=sys.stderr)
        return 1
    models = args.models.split(",")
    if args.time_tree:
        time_tree(args.time_tree, args.seed, models)
        return 0
    parent = os.path.abspath(args.parent)
    ok = True
    for turn, tag in enumerate(TURNS):
        tree = parent if tag == "parent" else ROOT
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent", parent,
             "--time-tree", tree, "--seed", str(args.seed), "--models",
             args.models], capture_output=True, text=True)
        if run.returncode != 0:
            print(f"mlp_ab: the {tag} turn failed:\n{run.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        for line in run.stdout.splitlines():
            rec = json.loads(line)
            ok &= rec["held"] is True
            print(json.dumps({**rec, "version": tag, "turn": turn}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
