"""Probes of the port's open faults on the card (ROADMAP §3).

    python scripts/port_fault_probe.py grads [--processes 6] [--iters 6]
    python scripts/port_fault_probe.py dstep [--reps 20]
    python scripts/port_fault_probe.py profiler [--sessions 10]

grads     §3.1 and §3.2: `[train parity]`'s step (model 1, batch 2 at full
          Market width, seed-99 batch) in float32 on the card, each
          gradient tensor against the card's float64 step from the same
          weights, the D step of both from the float64 step's updated G.
          Arms: `dcgan` (the port as it is: the DCGAN D's convs on
          PyTorch's own kernels, its BatchNorm as `models/layers.py` runs
          it), `dcgan_bn_cudnn_off` (that BatchNorm's forward, and so its
          backward, inside `torch.backends.cudnn.flags(enabled=False)`),
          `region` (`--D_arch=DCGANRegion`, every conv on cuDNN) and the
          control `dcgan_conv_cudnn` (the DCGAN D's convs back on cuDNN,
          where PR 15 saw cuDNN's float32 backward-data go wrong). Each of
          `--processes` fresh processes builds each arm's float64 step
          once and then runs `--iters` float32 steps of each arm, each on
          a fresh app. A tensor is an outlier in a step where its error
          (||diff|| / ||grad||) exceeds OUTLIER_RATIO times its median over
          every step of the arm. Prints one line per step and a JSON
          summary: per arm, the D gradient's and each G net's error
          (min / median / max), and each outlier.
dstep     The D step's device ms (the `d_forward_backward` and `d_update`
          phases of `utils.profiling.train_phase_ms`, model 1, batch 16,
          full width) with the DCGAN D's BatchNorm as it is and with its
          forward inside `cudnn.flags(enabled=False)`, in turns (as is,
          off, off, as is).
profiler  §3.3: the profiling session of
          `tests/test_torch_cuda.py::test_step_noise_is_one_copy` (a
          Stage-II app's step noise copied to the card inside
          `torch.profiler.profile(activities=[CUDA])`), `--sessions` times
          in each variant, in a fresh process and after one of: the card
          file's DCGAN D conv test, its [train parity] test (pytest
          in-process), or 120 s asleep. Variants: as the test has it;
          with 200 ms inside the session before the copy and after it;
          that with CPU activity too. Counts the sessions that saw the
          pinned copy and names the events of one that did not; then one
          long session of 15 copies 100 ms apart: which copies kept
          their device record, and its offset from the runtime call.

Needs a card. Reads nothing but the checkout; writes nothing but a
temporary directory.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

OUTLIER_RATIO = 4.0
ARMS = ("dcgan", "dcgan_bn_cudnn_off", "region", "dcgan_conv_cudnn")


@contextlib.contextmanager
def bn_cudnn_off():
    """The port's BatchNorm with its forward inside cuDNN-off flags (the
    backward follows the forward's implementation)."""
    from dpig_tpu_torch.models import layers
    forward = layers.BatchNorm.forward

    def off(self, *args, **kw):
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=False, allow_tf32=cudnn.allow_tf32):
            return forward(self, *args, **kw)
    layers.BatchNorm.forward = off
    try:
        yield
    finally:
        layers.BatchNorm.forward = forward


def _app(cfg, device, state, arm):
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.models.layers import Conv
    app = Stage1App(cfg, device, state=state)
    if arm == "dcgan_conv_cudnn":
        for m in app.disc.modules():
            if isinstance(m, Conv):
                m.cudnn = True
    return app


def _tensor_errors(ref, got):
    out = {}
    for n, r in ref.grads.items():
        d = got.grads[n].double() - r
        out[n] = float(d.norm() / r.norm()) if float(r.norm()) else 0.0
    return out


def grads_worker(iters: int) -> None:
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.train.parity import (recorded_train_step,
                                             step_errors, to_float64)
    card = torch.device("cuda")
    batch = next(SyntheticLoader(2, 128, 64, seed=99))
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        refs, cfgs, states = {}, {}, {}
        for arm in ARMS:
            cfgs[arm] = Config(platform="", batch_size=2, model_dir=tmp,
                               D_arch="DCGANRegion" if arm == "region"
                               else "DCGAN")
            cpu = Stage1App(Config(platform="cpu", batch_size=2,
                                   model_dir=tmp, D_arch=cfgs[arm].D_arch),
                            torch.device("cpu"))
            states[arm] = {k: {n: t.clone() for n, t in
                               m.state_dict().items()}
                           for k, m in (("Encoder", cpu.encoder),
                                        ("ID_AE", cpu.generator),
                                        ("Discriminator", cpu.disc))}
            ctx = bn_cudnn_off() if arm == "dcgan_bn_cudnn_off" \
                else contextlib.nullcontext()
            with ctx:
                ref = recorded_train_step(
                    to_float64(_app(cfgs[arm], card, states[arm], arm)),
                    batch)
            ref.grads = {n: g.double() for n, g in ref.grads.items()}
            ref.state = None
            refs[arm] = ref
        for it in range(iters):
            for arm in ARMS:
                ctx = bn_cudnn_off() if arm == "dcgan_bn_cudnn_off" \
                    else contextlib.nullcontext()
                with ctx:
                    got = recorded_train_step(
                        _app(cfgs[arm], card, states[arm], arm), batch,
                        g_updated=refs[arm].g_updated)
                errs = step_errors(refs[arm], got)
                row = {"arm": arm, "iter": it,
                       "steps": {k: errs[k] for k in
                                 ("Encoder", "ID_AE", "Discriminator")},
                       "tensors": _tensor_errors(refs[arm], got)}
                print("[grads] " + json.dumps(
                    {"arm": arm, "iter": it, **row["steps"]}), flush=True)
                rows.append(row)
                del got
    print("ROWS " + json.dumps(rows), flush=True)


def grads(processes: int, iters: int) -> dict:
    rows = []
    for p in range(processes):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, __file__, "grads-worker", "--iters",
             str(iters)], capture_output=True, text=True, check=False)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            raise RuntimeError(f"grads worker {p} failed: "
                               f"{out.stdout[-2000:]}")
        got = [json.loads(line[5:]) for line in out.stdout.splitlines()
               if line.startswith("ROWS ")][0]
        for r in got:
            r["process"] = p
        rows += got
        print(f"[grads] process {p}: {len(got)} steps in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    summary = {}
    for arm in ARMS:
        mine = [r for r in rows if r["arm"] == arm]
        med = {n: statistics.median(r["tensors"][n] for r in mine)
               for n in mine[0]["tensors"]}
        outliers = [{"process": r["process"], "iter": r["iter"],
                     "tensor": n, "err": e, "median": med[n]}
                    for r in mine for n, e in r["tensors"].items()
                    if e > OUTLIER_RATIO * med[n] and e > 0.0]
        summary[arm] = {
            "steps": len(mine),
            "processes": processes,
            **{k: [min(r["steps"][k] for r in mine),
                   statistics.median(r["steps"][k] for r in mine),
                   max(r["steps"][k] for r in mine)]
               for k in ("Encoder", "ID_AE", "Discriminator")},
            "steps_with_an_outlier": len({(o["process"], o["iter"])
                                          for o in outliers}),
            "outliers": outliers[:40]}
    return summary


def dstep(reps: int) -> dict:
    from dpig_tpu_torch.apps.common import batch_to_device
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.utils.profiling import train_phase_ms
    card = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        app = Stage1App(Config(platform="", model_dir=tmp), card)
        state = app.init_state()
        batch = batch_to_device(next(SyntheticLoader(16, 128, 64, seed=1)),
                                card)
        out = {"as is": [], "BatchNorm cuDNN off": []}
        for label in ("as is", "BatchNorm cuDNN off", "BatchNorm cuDNN off",
                      "as is"):
            ctx = bn_cudnn_off() if "off" in label \
                else contextlib.nullcontext()
            with ctx:
                ms = train_phase_ms(app, state, batch, reps)
            out[label].append({"d_step_ms": ms["d_forward_backward"]
                               + ms["d_update"], "step_ms": sum(ms.values()),
                               **ms})
    return out


def _session(app, kind):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if kind.startswith("cpu+cuda"):
        acts.append(ProfilerActivity.CPU)
    pad = 0.2 if "pads" in kind else 0.0
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(pad)
        app.step_noise(torch.Generator().manual_seed(3), 4)
        torch.cuda.synchronize()
        time.sleep(pad)
    names = [e.name for e in prof.events()]
    copies = [n for n in names if "HtoD" in n]
    return {"copy": len(copies) == 1 and "Pinned" in copies[0],
            "names": names}


def _long_session(n=15, gap=0.1):
    """One CUDA-only session of n pinned copies `gap` s apart: for each
    copy's runtime call (host clock), whether the profiler kept its device
    record, and the device record's start minus the runtime call's, and
    the runtime call's start from the trace start, in ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            torch.randn(4, 352 + i).pin_memory().to("cuda", non_blocking=True)
            torch.cuda.synchronize()
            time.sleep(gap)
    res = prof.profiler.kineto_results
    start = res.trace_start_ns()
    events = res.events()
    device = {e.correlation_id(): e for e in events if "HtoD" in e.name()}
    rows = []
    for e in events:
        if "Memcpy" in e.name() and "HtoD" not in e.name():
            d = device.get(e.correlation_id())
            rows.append({"at_ms": (e.start_ns() - start) / 1e6,
                         "kept": d is not None,
                         "device_minus_runtime_ms": None if d is None else
                         (d.start_ns() - e.start_ns()) / 1e6})
    return {"runtime_calls": len(rows), "device_records": len(device),
            "names": sorted({e.name() for e in events}), "rows": rows}


AGE = {"the two D tests": "dcgan_d_convs or d_gradient_to_float64",
       "the conv test": "dcgan_d_convs",
       "the parity test": "d_gradient_to_float64"}


def profiler_worker(before: str, sessions: int) -> dict:
    import pytest
    from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
    from dpig_tpu_torch.config import Config
    kinds = ("as the test", "200 ms pads", "cpu+cuda with 200 ms pads")
    out = {"before": before}
    with tempfile.TemporaryDirectory() as tmp:
        app = Stage2AppApp(Config(platform="", model_dir=tmp, img_H=32,
                                  img_W=16, batch_size=4,
                                  conv_hidden_num=16, z_num=16),
                           torch.device("cuda"))
        t0 = time.perf_counter()
        for when in ("fresh", f"after {before}"):
            if when != "fresh":
                if before in AGE:
                    out["pytest rc"] = int(pytest.main([
                        "-q", "--noconftest", "-p", "no:cacheprovider",
                        "tests/test_torch_cuda.py", "-k", AGE[before]]))
                else:
                    time.sleep(float(before.split()[1]))
            for kind in kinds:
                got = [_session(app, kind) for _ in range(sessions)]
                missed = [g["names"] for g in got if not g["copy"]]
                out[f"{when}: {kind}"] = {
                    "sessions": sessions,
                    "saw the pinned copy": sessions - len(missed),
                    "a session without it": missed[0] if missed else None,
                    "process age s": time.perf_counter() - t0}
            out[f"{when}: long session"] = _long_session()
            print(f"[profiler] {json.dumps(out)}", flush=True)
    return out


def profiler(sessions: int) -> dict:
    out = {}
    for before in ("the conv test", "the parity test", "sleep 120"):
        run = subprocess.run(
            [sys.executable, __file__, "profiler-worker", "--before", before,
             "--sessions", str(sessions)], capture_output=True, text=True,
            check=False)
        sys.stderr.write(run.stderr[-3000:])
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        out[before] = json.loads(lines[-1][7:]) if lines else {
            "rc": run.returncode, "tail": run.stdout[-2000:]}
        print(f"[profiler] before {before}: {json.dumps(out[before])}",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("grads", "grads-worker", "dstep",
                                     "profiler", "profiler-worker"))
    ap.add_argument("--before", default="the two D tests")
    ap.add_argument("--processes", type=int, default=6)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sessions", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_fault_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.what == "grads-worker":
        grads_worker(args.iters)
        return 0
    if args.what == "profiler-worker":
        print("RESULT " + json.dumps(profiler_worker(args.before,
                                                     args.sessions)))
        return 0
    result = {"grads": lambda: grads(args.processes, args.iters),
              "dstep": lambda: dstep(args.reps),
              "profiler": lambda: profiler(args.sessions)}[args.what]()
    print(smi)
    print(json.dumps({args.what: result, "card": smi,
                      "torch": torch.__version__,
                      "cudnn": torch.backends.cudnn.version()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
