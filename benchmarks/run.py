"""The benchmark of dpig_tpu_torch on one NVIDIA card.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json: set-up, a window of `--seconds`, the
check of what the window produced against the plain reference, and, with
`--trace 1`, the per-layer metrics. The last line of standard output is
the result as one JSON object; the numbers the check compared, each
beside its limit, are the last lines of standard error. Exits non-zero,
printing no result, without a CUDA card (or with fewer than the cell
asks for), and when JAX or the JAX package was loaded."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmarks import spec
    cell = spec.load_cell(args.workload)
    spec.entry(cell)  # imports the program: without it, no run
    import torch
    print(f"setup imports={time.perf_counter() - T0:.3f}s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmarks import harness
    result, rows = harness.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T0)
    bad = spec.forbidden_loaded(sys.modules)
    if bad:
        print(f"the run loaded {bad}: nothing of JAX or the JAX package may "
              "run in the benchmark", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
