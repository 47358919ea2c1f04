"""The port's host-side tfrecord scanner and tf.Example parser
(`csrc/tfrecord_scanner.cc`), bound with ctypes: the counterpart of
`dpig_tpu/data/_native/__init__.py`.

The library is built by g++ on first use into `kernels/_build/`
(`kernels/_build.py:load_host`). A failed build raises with the compiler's
output: nothing falls back to another parser quietly. The plain versions
are `data/tfrecord.py:read_records(native=False)` and
`crc32c_plain`, and `data/example.py:parse_example_features_plain`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence, Tuple, Union

import numpy as np

from ..kernels import _build

_lib = None
_lock = threading.Lock()

_I64P = ctypes.POINTER(ctypes.c_int64)


def get_lib() -> ctypes.CDLL:
    """The scanner library, built and bound on first use (thread-safe: the
    loader's worker threads may be the first to ask)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = _build.load_host("tfrecord_scanner")
                lib.tfr_scan.restype = ctypes.c_int64
                lib.tfr_scan.argtypes = [ctypes.c_char_p, _I64P, _I64P,
                                         ctypes.c_int64, ctypes.c_int]
                lib.tfr_count.restype = ctypes.c_int64
                lib.tfr_count.argtypes = [ctypes.c_char_p, ctypes.c_int]
                lib.tfr_crc32c.restype = ctypes.c_uint32
                lib.tfr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
                lib.tfr_parse.restype = ctypes.c_int64
                lib.tfr_parse.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), _I64P,
                    _I64P, ctypes.POINTER(ctypes.c_int32), _I64P, _I64P]
                _lib = lib
    return _lib


def crc32c(data: bytes) -> int:
    """CRC32-Castagnoli of `data` (unmasked)."""
    return int(get_lib().tfr_crc32c(data, len(data)))


def scan_tfrecord(path: str, verify_crc: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets, lengths) of the record payloads of a tfrecord file.
    Raises IOError on an unreadable file, or a malformed one (and, with
    `verify_crc`, a corrupt one)."""
    lib = get_lib()
    n = lib.tfr_count(path.encode(), 0)
    if n == -1:
        raise IOError(f"cannot open {path}")
    if n == -2:
        raise IOError(f"malformed tfrecord {path}")
    offsets = np.zeros(n, np.int64)
    lengths = np.zeros(n, np.int64)
    got = lib.tfr_scan(path.encode(), offsets.ctypes.data_as(_I64P),
                       lengths.ctypes.data_as(_I64P), n, int(verify_crc))
    if got == -2:
        raise IOError(f"corrupt tfrecord {path}")
    if got < 0:
        raise IOError(f"cannot open {path}")
    return offsets[:got], lengths[:got]


class MmapRecordFile:
    """Zero-copy random access to tfrecord payloads via mmap + the native
    index."""

    def __init__(self, path: str, verify_crc: bool = False):
        self.offsets, self.lengths = scan_tfrecord(path, verify_crc)
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, i: int) -> bytes:
        o = int(self.offsets[i])
        return self._mm[o:o + int(self.lengths[i])].tobytes()


Feature = Union[None, Tuple[int, int], np.ndarray, int]


def parse_example_features(record: bytes, wanted: Sequence[Tuple[str, int]]
                           ) -> Dict[str, Feature]:
    """Single-pass native tf.Example parse (`tfr_parse`).

    wanted: (name, capacity) pairs; capacity is the most numeric elements
    to decode (0 for a bytes feature). Returns {name: None if absent |
    (offset, length) of the first bytes element | float32 array of the
    values | int}: an int means the feature held more than `capacity`
    elements, and is their true count, so that a caller fails loudly
    instead of reading a truncated value. Raises IOError on a malformed
    record."""
    lib = get_lib()
    n = len(wanted)
    names = b"\0".join(name.encode() for name, _ in wanted) + b"\0"
    bufs = [np.zeros(max(cap, 1), np.float32) for _, cap in wanted]
    fptrs = (ctypes.c_void_p * n)(
        *[b.ctypes.data_as(ctypes.c_void_p) for b in bufs])
    caps = (ctypes.c_int64 * n)(*[cap for _, cap in wanted])
    counts = (ctypes.c_int64 * n)()
    types = (ctypes.c_int32 * n)()
    boffs = (ctypes.c_int64 * n)()
    blens = (ctypes.c_int64 * n)()
    rc = lib.tfr_parse(record, len(record), names, n, fptrs, caps, counts,
                       types, boffs, blens)
    if rc < 0:
        raise IOError("malformed tf.Example record")
    out: Dict[str, Feature] = {}
    for i, (name, cap) in enumerate(wanted):
        if types[i] == 0:
            out[name] = None
        elif types[i] == 1:
            out[name] = (int(boffs[i]), int(blens[i]))
        elif counts[i] > cap:
            out[name] = int(counts[i])
        else:
            out[name] = bufs[i][:int(counts[i])]
    return out
