"""Timing and trace reduction of the benchmark: the window's statistics, the
profiler trace reduced to the device's busy time, its top operations and
its idle gaps, and what the card is (name, power limit)."""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW_MARK = "bench.traced_window"


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of all values, linearly interpolated."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(units: float, seconds: float) -> float:
    return units / seconds


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by [start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceSummary:
    """A chrome trace of one profiled stretch, reduced: the stretch's
    bounds (the WINDOW_MARK annotation), the device's operations clipped
    to it, and the host's ops. Times in seconds."""

    def __init__(self, events: Sequence[Dict]):
        marks = [e for e in events if e.get("name") == WINDOW_MARK
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise ValueError(f"the trace has no {WINDOW_MARK!r} annotation")
        t0 = marks[0]["ts"]
        t1 = t0 + marks[0]["dur"]
        self.window_s = (t1 - t0) * 1e-6
        self.device_ops: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                s, f = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
                if f > s:
                    self.device_ops.append((e["name"], (s - t0) * 1e-6,
                                            (f - t0) * 1e-6))
        self.host_ops = [(e["name"], (e["ts"] - t0) * 1e-6,
                          (e["ts"] + e["dur"] - t0) * 1e-6)
                         for e in events
                         if e.get("cat") in HOST_CATS and "dur" in e]
        self.busy_s = union_length([(s, f) for _, s, f in self.device_ops])

    def kernel_seconds(self, substring: str) -> List[float]:
        """Durations of the device operations whose name holds
        `substring`."""
        return [f - s for n, s, f in self.device_ops if substring in n]

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, s, f in self.device_ops:
            total[name] += f - s
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The `n` longest stretches with no device operation, each named
        by the innermost host op running at its middle."""
        gaps, last = [], 0.0
        for s, f in merged([(s, f) for _, s, f in self.device_ops]):
            if s > last:
                gaps.append((last, s))
            last = max(last, f)
        if self.window_s > last:
            gaps.append((last, self.window_s))
        out = []
        for s, f in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (s + f) / 2
            around = [h for h in self.host_ops if h[1] <= mid <= h[2]]
            name = (max(around, key=lambda h: h[1])[0] if around
                    else "host: no recorded op")
            out.append([name, f - s])
        return out


def profile(fn: Callable[[], None], sync: Callable[[], None]
            ) -> TraceSummary:
    """Run `fn` under torch.profiler (CPU and CUDA activity) inside the
    WINDOW_MARK annotation, synchronized at both ends, and reduce the
    trace. The trace file goes to TMPDIR and is deleted."""
    from torch.profiler import ProfilerActivity, profile as tprofile, \
        record_function
    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_MARK):
            fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return TraceSummary(events)


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].split(",")[-1].strip() if out.returncode == 0 and line \
        else None
