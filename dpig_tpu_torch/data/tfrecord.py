"""TFRecord file format reader/writer, no TensorFlow: the port's copy of
`dpig_tpu/data/tfrecord.py`.

Format (tensorflow/core/lib/io/record_writer.h):
  uint64 length (LE) | uint32 masked_crc32c(length) |
  bytes  data[length] | uint32 masked_crc32c(data)

masked_crc = ((crc >> 15) | (crc << 17)) + 0xa282ead8, crc = CRC32-Castagnoli.

The CRC and the record index come from the native scanner
(`data/native.py`, built by g++ on first use); `crc32c_plain` (a table in
Python) and `read_records(native=False)` (a plain reader) are their plain
versions, which the tests and `chip_smoke.py` hold them against.
"""
from __future__ import annotations

import os
import struct
from typing import Iterator, List

import numpy as np

from . import native


def _crc_table() -> List[int]:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _crc_table()
_MASK_DELTA = 0xA282EAD8


def crc32c_plain(data: bytes) -> int:
    """CRC32-Castagnoli, a byte at a time (the plain version of
    `native.crc32c`)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _mask(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    return _mask(native.crc32c(data))


def masked_crc_plain(data: bytes) -> int:
    return _mask(crc32c_plain(data))


class TFRecordWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify_crc: bool = False,
                 native_scan: bool = True) -> Iterator[bytes]:
    """Stream the raw records of a tfrecord file.

    The native scanner indexes the file in one pass (CRC32C in C++) and
    the records are sliced from an mmap. `native_scan=False` reads them
    with the plain reader (Python `struct`, the table CRC). Either raises
    IOError on a truncated record and, with `verify_crc`, on a corrupt
    one."""
    if native_scan:
        offsets, lengths = native.scan_tfrecord(path, verify_crc)
        if len(offsets):
            mm = np.memmap(path, dtype=np.uint8, mode="r")
            for o, n in zip(offsets, lengths):
                yield mm[int(o):int(o) + int(n)].tobytes()
        return
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise IOError(f"truncated record header in {path}")
            (length,) = struct.unpack("<Q", header)
            len_crc = f.read(4)
            if len(len_crc) != 4:
                raise IOError(f"truncated record header in {path}")
            if verify_crc and masked_crc_plain(header) != struct.unpack(
                    "<I", len_crc)[0]:
                raise IOError(f"corrupt length crc in {path}")
            data = f.read(length)
            data_crc = f.read(4)
            if len(data) != length or len(data_crc) != 4:
                raise IOError(f"truncated record body in {path}")
            if verify_crc and masked_crc_plain(data) != struct.unpack(
                    "<I", data_crc)[0]:
                raise IOError(f"corrupt record crc in {path}")
            yield data


def count_records(path: str) -> int:
    """Number of records in a tfrecord file, via header-seek only (no
    payload reads, no CRC), cheap enough for loader init."""
    n = 0
    end = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 12 <= end:
            header = f.read(8)
            if len(header) != 8:
                break
            (length,) = struct.unpack("<Q", header)
            pos += 12 + length + 4
            if pos > end:  # truncated tail record: don't count it
                break
            f.seek(pos)
            n += 1
    return n


def list_shards(pattern_dir: str, prefix: str) -> List[str]:
    """All tfrecord shards in a directory matching `prefix*`."""
    return sorted(
        os.path.join(pattern_dir, f) for f in os.listdir(pattern_dir)
        if f.startswith(prefix) and ".tfrecord" in f)
