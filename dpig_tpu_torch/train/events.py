"""TensorBoard event files, written without TensorFlow or tensorboard: the
port's counterpart of the JAX package's `tf.summary` writer
(`dpig_tpu/train/harness.py:37-46,84-92`), which it opens when TF
imports. (`torch.utils.tensorboard` needs the tensorboard package, which
imports TensorFlow where TF is installed.)

An event file is a tfrecord file (`data/tfrecord.py:TFRecordWriter`) of
`Event` protos: the first holds `file_version` "brain.Event:2", each
later one a step's `Summary`. Scalars are written as `simple_value`s;
histograms as tf.summary.histogram writes them: a [30, 3] float64 tensor
of (left edge, right edge, count) under the "histograms" plugin, bucketed
as tensorboard's `summary_v2._buckets` does. TensorBoard reads both.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Mapping

import numpy as np

from ..data.example import field, int_field
from ..data.tfrecord import TFRecordWriter

BUCKETS = 30              # tf.summary.histogram's default
DT_DOUBLE = 2


def _event(step: int, summary: bytes = b"", version: bytes = b"") -> bytes:
    out = b"\x09" + struct.pack("<d", time.time())   # wall_time (double)
    if step:
        out += int_field(2, step)
    if version:
        out += field(3, version)
    if summary:
        out += field(5, summary)
    return out


def histogram_buckets(values: np.ndarray, count: int = BUCKETS
                      ) -> np.ndarray:
    """[count, 3] float64 (left edge, right edge, count) of `values`, as
    tensorboard's histogram summary buckets them: `count` equal buckets
    from min to max (the last closed), a single value's count in the last
    bucket, zeros for no values."""
    data = np.asarray(values, np.float64).ravel()
    if data.size == 0:
        return np.zeros((count, 3))
    lo, hi = data.min(), data.max()
    counts = np.zeros(count)
    if hi == lo:
        counts[-1] = data.size
        return np.stack([np.full(count, hi), np.full(count, hi), counts], 1)
    idx = np.minimum(np.floor((data - lo) / ((hi - lo) / count)).astype(
        np.int64), count - 1)
    np.add.at(counts, idx, 1.0)
    edges = np.linspace(lo, hi, count + 1)
    edges[-1] = hi
    return np.stack([edges[:-1], edges[1:], counts], 1)


class EventWriter:
    """`events.out.tfevents.<time>.<host>.<pid>.v2` in `logdir`."""

    def __init__(self, logdir: str):
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.v2")
        self.path = os.path.join(logdir, name)
        self._w = TFRecordWriter(self.path)
        self._w.write(_event(0, version=b"brain.Event:2"))

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        """One Summary of float32 `simple_value`s."""
        summary = b"".join(
            field(1, field(1, tag.encode()) + b"\x15"
                  + struct.pack("<f", float(v)))
            for tag, v in values.items())
        self._w.write(_event(step, summary))

    def histogram(self, step: int, tag: str, values: np.ndarray) -> None:
        table = histogram_buckets(values)
        shape = b"".join(field(2, int_field(1, n)) for n in table.shape)
        tensor = (int_field(1, DT_DOUBLE) + field(2, shape)
                  + field(4, table.astype("<f8").tobytes()))
        meta = field(1, field(1, b"histograms"))
        value = field(1, tag.encode()) + field(8, tensor) + field(9, meta)
        self._w.write(_event(step, field(1, value)))

    def flush(self) -> None:
        self._w.flush()

    def close(self) -> None:
        self._w.close()
