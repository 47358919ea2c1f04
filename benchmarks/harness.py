"""One run of one cell: the entry's set-up, window and outputs, then the
checks, the per-layer readers and the result's line."""
from __future__ import annotations

import dataclasses
import gc
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import check, measure, spec


class Seeds:
    """Independent streams from the run's seed: the weights, the traffic
    and the sample of outputs that the check compares."""

    def __init__(self, seed: int):
        kids = np.random.SeedSequence(int(seed) % 2 ** 64).spawn(3)
        self.weights, self.data, self.sample = (
            int(k.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for k in kids)


@dataclasses.dataclass
class Outcome:
    """What an entry hands back: the end-to-end metrics, what the per-layer
    readers read (`ctx`), the numbers compared with the limits, the work
    attempted and failed, the device's peak memory and the reduced trace
    of a traced run."""
    e2e: Dict[str, float]
    ctx: Dict
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[measure.TraceSummary] = None


class Device:
    """The device of a run, and what the entries ask of it."""

    def __init__(self, name: str):
        self.torch = torch.device(name)
        self.cuda = self.torch.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.torch)

    def peak_bytes(self) -> int:
        return (int(torch.cuda.max_memory_allocated(self.torch))
                if self.cuda else 0)

    def free(self) -> None:
        """Return what freed tensors held, before the reference runs."""
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def kind(self) -> str:
        return (torch.cuda.get_device_name(self.torch) if self.cuda
                else "cpu")


class SetupClock:
    """Seconds of each part of set-up (synchronized), printed to standard
    error: where set-up goes, for PERF.md."""

    def __init__(self, dev: Device):
        self.dev, self.laps, self.last = dev, [], time.perf_counter()

    def lap(self, name: str) -> None:
        self.dev.sync()
        now = time.perf_counter()
        self.laps.append((name, now - self.last))
        self.last = now

    def report(self, t0: float) -> None:
        first = self.last - sum(s for _, s in self.laps) - t0
        parts = [("start+import+cuda", first)] + self.laps
        print("setup " + " ".join(f"{n}={s:.3f}s" for n, s in parts),
              file=sys.stderr, flush=True)


def model_dir() -> str:
    """A fresh directory under TMPDIR for the program's `model_dir`."""
    return tempfile.mkdtemp(prefix="dpig_bench_")


def remove(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, t0: float):
    """-> (the result's dict, [(check, value, limit)])."""
    dev = Device(device)
    out: Outcome = spec.entry(cell).run(cell, Seeds(seed), seconds, trace,
                                        dev, t0)
    ok, rows = check.judge(out.numbers, cell.traffic["limits"])
    if trace:
        out.ctx["device_kind"] = dev.kind()
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out.e2e}
    device_info = {"platform": "gpu" if dev.cuda else "cpu",
                   "kind": dev.kind(), "count": cell.chips,
                   "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": ok, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device_info}
    if out.trace is not None:
        device_info["busy_s"] = out.trace.busy_s
        device_info["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.top_ops(10),
                               "idle_gaps": out.trace.idle_gaps(10)}
    if dev.cuda:
        device_info["power_limit"] = measure.power_limit()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    return result, rows
