"""In-memory spans at the port's layer boundaries, for the benchmark's
per-layer metrics and `utils/profiling.py`.

    from dpig_tpu_torch.utils import spans
    spans.enable()
    ...                     # Trainer.step, transfer_step, batch_to_device
    table = spans.summary()
    spans.reset()
    spans.disable()

The recorder is off by default. Off, `span(name)` returns one shared
context manager that does nothing, so an instrumented call costs one
global test: no CUDA event, no `record_function`, no tensor hook, no
allocation. On, each span records its name, the span open around it (its
parent), the step it belongs to (every span opened with no span open
around it starts a new step id, which the spans inside it share), its
host start and end (`time.perf_counter_ns`), its device start and end (a
`torch.cuda.Event(enable_timing=True)` pair on the current stream, once
the process has initialized CUDA; the host clock otherwise) and optional
counts (`Span.add`, e.g. bytes). It also opens
`torch.profiler.record_function(name)`, so under a profiler session the
span is a `user_annotation` on the kernels' clock.

`split_backward` times a backward pass net by net: a hook on each named
tensor opens that net's backward span when the tensor's gradient is
complete, closing the one before; `end_backward` closes the last. These
spans are opened and closed on autograd's thread and open no
`record_function`.

Spans nest on one thread (the one that runs the steps). Event times are
resolved only in `summary()`, which synchronizes the card once.
"""
from __future__ import annotations

import time
from math import inf
from typing import Dict, List, Optional, Sequence, Tuple

import torch


class _Off:
    """The recorder's stand-in while it is off: enters to None."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded interval (see the module's docstring)."""

    __slots__ = ("name", "parent", "step", "host", "events", "counts",
                 "_annotation")

    def __init__(self, name: str, parent: Optional["Span"], step: int):
        self.name, self.parent, self.step = name, parent, step
        self.host = [time.perf_counter_ns(), None]
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.counts: Dict[str, float] = {}
        self._annotation = None

    def add(self, **counts: float) -> None:
        """Add to this span's counts."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def close(self) -> None:
        if self.events is not None:
            self.events[1].record()
        self.host[1] = time.perf_counter_ns()

    def __enter__(self) -> "Span":
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        _open.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        if _open and _open[-1] is self:   # not if `reset` came in between
            _open.pop()
        self.close()
        self._annotation.__exit__(*exc)
        self._annotation = None
        return False


_on = False
_records: List[Span] = []      # every span opened since the last reset
_open: List[Span] = []         # the spans open now, outermost first
_steps = 0                     # step ids handed out since the last reset
_backward: Optional[Span] = None   # the backward span a hook opened last


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forget every span recorded (open ones included)."""
    global _steps, _backward
    _records.clear()
    _open.clear()
    _steps, _backward = 0, None


def _new(name: str, parent: Optional[Span]) -> Span:
    global _steps
    if parent is None:
        _steps += 1
    s = Span(name, parent, parent.step if parent is not None else _steps)
    _records.append(s)
    return s


def span(name: str):
    """A context manager that records `name` while the recorder is on; the
    shared no-op while it is off. It enters to the `Span` (None off)."""
    if not _on:
        return _OFF
    return _new(name, _open[-1] if _open else None)


def split_backward(*named: Tuple[torch.Tensor, str]) -> None:
    """For `(tensor, name)` pairs whose gradients complete in this order
    in the coming backward pass: when the gradient of each is complete
    (its tensor hook, run just before its `grad_fn`), close the backward
    span opened before and open `name`, under the span open now. Call
    only while the recorder is on; `end_backward` closes the last."""
    parent = _open[-1] if _open else None

    def boundary(name):
        def hook(grad):
            global _backward
            if _backward is not None:
                _backward.close()
            _backward = _new(name, parent)
            return None
        return hook

    for tensor, name in named:
        tensor.register_hook(boundary(name))


def end_backward() -> None:
    """Close the backward span that `split_backward`'s hooks opened last,
    after the backward pass has returned."""
    global _backward
    if _backward is not None:
        _backward.close()
        _backward = None


def _device_bounds(spans: Sequence[Span]) -> Dict[int, Tuple[float, float]]:
    """{id(span): (start, end)} in ms: on the card from the first span's
    start event, else from its host start."""
    first = spans[0]
    out = {}
    for s in spans:
        if s.events is not None and first.events is not None:
            a = first.events[0].elapsed_time(s.events[0])
            out[id(s)] = (a, a + s.events[0].elapsed_time(s.events[1]))
        else:
            out[id(s)] = ((s.host[0] - first.host[0]) / 1e6,
                          (s.host[1] - first.host[0]) / 1e6)
    return out


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """Sorted disjoint [start, end] intervals covering `intervals`."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals: Sequence[Tuple[float, float]], lo: float = -inf,
            hi: float = inf) -> float:
    """Length of [lo, hi] that the union of `intervals` covers."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def summary() -> Dict[str, Dict]:
    """The closed spans by name, in order of first opening: `count`, and
    per instance its `step`, its `parent`'s name (None at the root), its
    `device_ms` and `host_ms`, and its `self_ms` (device time less the
    part of its interval that its closed child spans cover); `counts`
    summed over the instances."""
    done = [s for s in _records if s.host[1] is not None]
    if not done:
        return {}
    if any(s.events is not None for s in done):
        torch.cuda.synchronize()
    bounds = _device_bounds(done)
    children: Dict[int, List[Span]] = {}
    for s in done:
        if s.parent is not None:
            children.setdefault(id(s.parent), []).append(s)
    out: Dict[str, Dict] = {}
    for s in done:
        row = out.setdefault(s.name, {
            "count": 0, "step": [], "parent": [], "device_ms": [],
            "host_ms": [], "self_ms": [], "counts": {}})
        a, b = bounds[id(s)]
        row["count"] += 1
        row["step"].append(s.step)
        row["parent"].append(s.parent.name if s.parent is not None else None)
        row["device_ms"].append(b - a)
        row["host_ms"].append((s.host[1] - s.host[0]) / 1e6)
        row["self_ms"].append((b - a) - covered(
            [bounds[id(c)] for c in children.get(id(s), [])], a, b))
        for k, v in s.counts.items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    return out
