"""Run one cell of the port's benchmark on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, then ``card`` and ``checks`` (each number that decides
``correct`` beside its limit; also the last lines of standard error).
Exits non-zero and prints no result without enough CUDA cards, without
the port beside it, where a per-layer metric found nothing to read, or
where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Whatever the card's libraries cache goes inside the checkout, at fixed
# paths; the port's own kernels build into <checkout>/build/kernels.
CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("CUDA_CACHE_PATH", "cuda"))
FORBIDDEN = {"jax", "jaxlib", "flax", "cleverrec_tpu"}


def forbidden_modules() -> list[str]:
    """Top-level names, compared whole, of loaded modules that the run
    must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES:
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)

    from portbench import card, harness
    bench = harness.load_bench()
    w = harness.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(w["chips"])):
        say(f"portbench: {args.workload} needs {w['chips']} CUDA card(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    try:
        import cleverrec_tpu_torch
    except ImportError as e:
        say(f"portbench: the port is not beside the benchmark: {e}")
        return 3
    if not os.path.abspath(cleverrec_tpu_torch.__file__).startswith(
            os.path.join(ROOT, "")):
        say("portbench: the port loaded from outside the checkout: "
            f"{cleverrec_tpu_torch.__file__}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = card.card_line()
    say(f"card: {line}; peaks (H100 SXM data sheet, at 700 W): FP32 "
        f"{card.PEAK_FP32:.3g} FLOP/s, HBM {card.PEAK_BYTES:.3g} B/s")
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", T_START, bench=bench)
    bad = forbidden_modules()
    if bad:
        say(f"portbench: the run loaded {', '.join(bad)}")
        return 4
    missing = out.pop("missing")
    if missing:
        say("portbench: no device record, or none of the named kernel, for "
            + ", ".join(missing))
        return 5
    out["card"] = line
    checks = out.pop("checks")
    out["checks"] = checks
    for name, c in checks.items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
