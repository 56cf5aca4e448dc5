"""How far ``mlp_epoch`` lands from its plain version, over many states.

    python3 tools/mlp_states.py [--states 40] [--repeats 3] [--steps 4]

(on a GPU).  For NeuMF and MLP at the main shape of ``chip_smoke.py``
phase E: each state is a fresh trainer one epoch in (that epoch itself
through the kernel, so every state differs in rounding), then the first
``--steps`` steps of the next epoch's draw (0: all 81) through the plain
version and the kernel, ``--repeats`` times.  Prints,
per state, the largest ratio of an error of the dense params and their
moments to chip_smoke's DENSE bound (1e-4 + 1e-3 |x|; above 1 passes
it), the tensor it falls on and how many of its elements pass, and
whether chip_smoke's own check (``mlp_hold``) passed every repeat; then
the sorted ratios of each model and how many states failed that check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def worst(spec, got, want):
    """(largest ratio to the DENSE bound, its tensor, elements past it)."""
    out = (0.0, "", 0)
    for k, part in enumerate(("", "m_", "v_")):
        for j, n in enumerate(spec["dense"]):
            g, w = got[3 * k + 2][j], want[3 * k + 2][j]
            r = (g - w).abs() / (cs.DENSE_ATOL + cs.DENSE_RTOL * w.abs())
            out = max(out, (r.max().item(), part + n, int((r > 1).sum())))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--states", type=int, default=40)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--steps", type=int, default=cs.MLP_HELD_STEPS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("mlp_states: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.write_ml100k()
    cs.build.build(["mlp_epoch"])
    for name in ("NeuMF", "MLP"):
        cfg = cs.config("ml-100k", recommender=name)
        data = cs.load_ranking_data(cfg)
        ratios, failed = [], 0
        for state_id in range(args.states):
            model = cs.make_model(cfg, cs.DataMeta(data.user_nums,
                                                   data.item_nums))
            trainer = cs.Trainer(model, data, cfg)
            params, state = trainer.init_state()
            params, state, _ = trainer.train_epoch(params, state)
            tensors = trainer.sample_epoch()
            spec = model.fused_mlp_spec()
            held = slice(0, args.steps or None)
            ids = [x[held] for x in cs.sentinel_ids(data, tensors,
                                                    ("u", "i"))]
            cols = [tensors[k][held].to(torch.float32).contiguous()
                    for k in ("y", "w")]
            reps, verdicts = [], []
            for _ in range(args.repeats):
                got, want, loss, ref, _ = cs.mlp_run(cfg, spec, params,
                                                     state, ids, cols)
                reps.append(worst(spec, got, want))
                try:
                    cs.mlp_hold(spec, got, want, loss, ref)
                    verdicts.append("ok")
                except cs.SmokeError as e:
                    verdicts.append(str(e))
            ratio, tensor, past = max(reps)
            ratios.append(ratio)
            failed += any(v != "ok" for v in verdicts)
            print(json.dumps({"model": name, "state": state_id,
                              "ratio": ratio, "tensor": tensor,
                              "elements_past": past,
                              "smoke_check": sorted(set(verdicts))}),
                  flush=True)
        print(json.dumps({"model": name, "states": args.states,
                          "steps": args.steps,
                          "failed_smoke_check": failed,
                          "sorted_ratios": sorted(ratios)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
