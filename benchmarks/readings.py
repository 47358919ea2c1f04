"""Readings for the limits of a cell's check (not part of a benchmark run).

    python3 benchmarks/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

One process, one line of JSON per reading on standard output:
  program     the program against the reference (float64; the lower
              readings);
  control     the reference in float32 with TF32 on in cuBLAS and cuDNN,
              the nearest precision below the configuration's float32, in
              the program's place (the upper readings);
  half_batch  (training cells) the reference in float32 stepping on the
              first half of each batch alone, the mean over it, in the
              program's place: one of the faults a training cell's
              numbers are held against.
A training cell runs its checked steps, a transfer cell one pass over its
ring after the warm-up (more batches than a run compares)."""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from benchmarks import check, harness, spec
    F32 = torch.float32
    cell = spec.load_cell(args.workload)
    dev = harness.Device(args.device)
    mod = spec.entry(cell)
    train = cell.traffic["entry"] == "stage1_train"

    def first_step(got, ref):
        """Each first-step loss's gap, beside the numbers."""
        r0, g0 = ref["losses"][0], got["losses"][0]
        return {**check.train_numbers(got, ref),
                **{f"first.{k}": abs(g0[k] - r0[k]) / abs(r0[k])
                   for k in check.FIRST_STEP_LOSSES}}

    def emit(kind, seed, numbers, t):
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                          "seconds": round(time.perf_counter() - t, 3),
                          **numbers}), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.fault_seeds)):
        s = harness.Seeds(seed)
        t = time.perf_counter()
        if train:
            ref = mod.reference_steps(cell, s, dev)
            if seed in args.seeds:
                emit("program", seed, first_step(
                    mod.program_numbers(cell, s, dev), ref), t)
            if seed in args.control_seeds:
                emit("control", seed, first_step(
                    mod.reference_steps(cell, s, dev, F32, tf32=True), ref),
                    t)
            if seed in args.fault_seeds:
                half = slice(0, cell.traffic["batch_size"] // 2)
                emit("half_batch", seed, first_step(
                    mod.reference_steps(cell, s, dev, F32, rows=half), ref),
                    t)
        else:
            kept = mod.program_outputs(cell, s, dev)
            if seed in args.seeds:
                emit("program", seed, check.transfer_numbers(
                    mod.reference_pairs(cell, s, dev, kept)), t)
            if seed in args.control_seeds:
                ctrl = [((ci, cp, cs), ref) for (_, ref), (_, (ci, cp, cs))
                        in zip(mod.reference_pairs(cell, s, dev, kept),
                               mod.reference_pairs(cell, s, dev, kept, F32,
                                                   tf32=True))]
                emit("control", seed, check.transfer_numbers(ctrl), t)
        dev.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
