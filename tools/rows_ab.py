"""Time the rows epoch kernels (``rows_epoch``, the social chain, and
``rows_epoch_lrml``, LRML's form) of this checkout against another
checkout's (the parent commit's) on one GPU, in turns: parent, change,
change, parent.

    python3 tools/rows_ab.py --parent DIR [--lrml-epochs 20]

The inputs are made once, by this checkout, before the turns, at the
shapes of ``chip_smoke.py``'s phases F and G: ml-100k rebuilt from the
repo, the trust graph of ``chip_smoke.write_trusts``, each model at its
conf and the conf's seed.  SBPR, TBPR and CUNE_BPR: the
state one epoch in and the next epoch's draw (``chip_smoke.one_epoch_in``);
LRML the same, and again ``--lrml-epochs`` epochs in, where fewer rows'
hinges are active.  Each LRML input carries the share of real rows whose
hinge is active over its epoch (the plain version's count).  They go to
``build/rows_ab/inputs.pt``.  Each turn is a process that imports one
checkout's package, which builds that checkout's ``csrc/rows_epoch.cu``
on first use, and for each input:

- holds the kernel to its plain version over the epoch with that
  checkout's ``chip_smoke.hold``, at the smoke's tolerances;
- times whole epochs: ``ms`` is CUDA events over 5 epochs, a mean;
  ``device_ms`` the device time of one epoch by kernel name
  (torch.profiler over 3 epochs), with their sum.

Prints one JSON line per (input, version, turn), then the card's name and
power limit; exits 1 if any hold failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from mlp_ab import TURNS, by_kernel  # noqa: E402

INPUTS = os.path.join(ROOT, "build", "rows_ab", "inputs.pt")
SOCIAL = ("SBPR", "TBPR", "CUNE_BPR")


def make_inputs(lrml_epochs: int) -> None:
    """Every input of the turns, into INPUTS (this checkout's trainer)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cleverrec_tpu_torch.ops import train as T
    cs.write_ml100k()
    cs.write_trusts()
    out = []
    for name in (*SOCIAL, "LRML"):
        cfg, data, model, trainer, params, state, draw = cs.one_epoch_in(name)
        spec = model.fused_rows_spec()
        for epochs in (1, lrml_epochs) if name == "LRML" else (1,):
            if epochs > 1:
                for _ in range(epochs - 1):
                    params, state, _ = trainer.train_epoch(params, state)
                draw = trainer.sample_epoch()
            planes = cs.sentinel_ids(data, draw,
                                     [n for n, _ in spec["planes"]])
            floats = [draw[n].to(torch.float32).contiguous()
                      for n in spec["floats"]]
            groups = [tuple(x.detach().cpu().clone() for x in group)
                      for t in (params, state.mu, state.nu)
                      for group in spec["pack"](t)]
            rec = {"model": name, "epochs_in": epochs, "groups": groups,
                   "planes": [x.cpu() for x in planes],
                   "floats": [x.cpu() for x in floats], "t0": state.count,
                   "lr": cfg.lr, "U": data.user_nums, "I": data.item_nums}
            if name == "LRML":
                counting, active = cs.counting_hinge(spec, model.margin)
                T.fused_rows_epoch_ref(
                    *[tuple(x.cuda() for x in g) for g in groups], planes,
                    [], state.count, sides=("u", "i", "i"),
                    row_loss=counting, lr=cfg.lr)
                rec["active_share"] = active[0] / active[1]
            out.append(rec)
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    torch.save(out, INPUTS)


def time_tree(tree: str) -> None:
    """One turn: ``tree``'s kernel on every input, a JSON line each."""
    sys.path[:0] = [tree]
    import chip_smoke as cs
    from cleverrec_tpu_torch.models import make_model
    from cleverrec_tpu_torch.models.base import DataMeta
    from cleverrec_tpu_torch.ops import train as T
    torch.backends.cuda.matmul.allow_tf32 = False
    for rec in torch.load(INPUTS):
        name = rec["model"]
        cfg = cs.config("ml-100k", recommender=name)
        model = make_model(cfg, DataMeta(rec["U"], rec["I"]), device="cpu")
        spec = model.fused_rows_spec()
        planes = [x.cuda() for x in rec["planes"]]
        floats = [x.cuda() for x in rec["floats"]]
        opts = {"sides": [sd for _, sd in spec["planes"]], "lr": rec["lr"]}

        def state():
            return [tuple(x.cuda() for x in g) for g in rec["groups"]]
        got, want = state(), state()
        loss = T.fused_rows_epoch(*got, planes, floats, rec["t0"], spec=spec,
                                  **opts)
        ref = T.fused_rows_epoch_ref(*want, planes, floats, rec["t0"],
                                     row_loss=spec["row_loss"], **opts)
        torch.cuda.synchronize()
        loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
        try:
            errors = cs.hold(name, zip(map(str, range(99)),
                                       (x for g in got for x in g),
                                       (x for g in want for x in g)),
                             cs.EPOCH_ATOL, cs.EPOCH_RTOL)
            held = loss_rel <= cs.EPOCH_LOSS_RTOL or f"loss {loss_rel}"
        except cs.SmokeError as e:
            errors, held = {}, str(e)
        k_state = state()

        def epoch():
            T.fused_rows_epoch(*k_state, planes, floats, rec["t0"],
                               spec=spec, **opts)
        split = by_kernel(epoch)
        print(json.dumps({
            "model": name, "epochs_in": rec["epochs_in"],
            "active_share": rec.get("active_share"), "held": held,
            "max_err": max(errors.values(), default=None),
            "loss_rel_err": loss_rel, "ms": cs.timed(epoch, iters=5)[0],
            "device_ms": sum(split.values()), "by_kernel": split}),
            flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--lrml-epochs", type=int, default=20)
    parser.add_argument("--time-tree", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("rows_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.time_tree:
        time_tree(args.time_tree)
        return 0
    make_inputs(args.lrml_epochs)
    parent = os.path.abspath(args.parent)
    ok = True
    for turn, tag in enumerate(TURNS):
        tree = parent if tag == "parent" else ROOT
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent", parent,
             "--time-tree", tree], capture_output=True, text=True)
        if run.returncode != 0:
            print(f"rows_ab: the {tag} turn failed:\n{run.stderr[-4000:]}",
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
