"""TF V2 tensor bundles (the format of TF1 checkpoints) read and written
without TensorFlow: the port's counterpart of `load_tf1_variables`
(`dpig_tpu/train/tf1_import.py:31-38`, `tf.train.load_checkpoint`).

A bundle with prefix P is two or more files:

  P.index                   a leveldb-format table (uncompressed blocks),
                            keys in byte order: "" -> a BundleHeaderProto
                            (num_shards, endianness, version), each tensor
                            name -> a BundleEntryProto (dtype, shape,
                            shard_id, offset, size, crc32c)
  P.data-0000k-of-0000n     the tensors' raw little-endian bytes, each at
                            its entry's offset in shard k

The table ends in a 48-byte footer: the varint handles (offset, size) of
its metaindex and index blocks, zero padding, and the magic
0xdb4775248b80fb57. The index block maps a separator key to each data
block's handle. A block is prefix-compressed entries (shared, non-shared
and value lengths as varints, the key's new bytes, the value), a restart
array of uint32 offsets and its count; then a 5-byte trailer: the
compression type (0: none) and the masked CRC32C of the block and that
byte. The protos are decoded here by a small varint reader.

`read_bundle(prefix)` returns {name: np.ndarray} as
`tf.train.load_checkpoint` gives it, bit for bit, keeping the names
`load_tf1_variables` keeps (`is_model_variable`). Each tensor's CRC32C
(TF stores it masked, as tfrecords do) is checked with the native CRC of
`csrc/tfrecord_scanner.cc` (`data/tfrecord.py:masked_crc`). What it
cannot read raises a named `BundleError`: a compressed block, a
big-endian bundle, a dtype other than float32, float64, int32 or int64,
a partitioned variable (`slices`), a bad CRC.

`write_bundle(prefix, tensors)` writes a one-shard bundle of the same
format, which TensorFlow reads back: the checks and tests write the
bundles they read on machines without TensorFlow.
"""
from __future__ import annotations

import os
import re
import struct
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..data.example import field, int_field, varint
from ..data.tfrecord import masked_crc

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
BLOCK_BYTES = 262144          # TF's table block size (table_options.h)
RESTART_INTERVAL = 16         # leveldb's and TF's restart interval
# types.proto's DataType numbers of the supported dtypes
DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"),
          9: np.dtype("<i8")}
DTYPE_NAMES = {1: "float32", 2: "float64", 3: "int32", 4: "uint8",
               5: "int16", 6: "int8", 7: "string", 8: "complex64",
               9: "int64", 10: "bool", 14: "bfloat16", 19: "float16"}
_DTYPE_NUMBERS = {v: k for k, v in DTYPES.items()}


class BundleError(ValueError):
    """A tensor bundle this reader cannot read."""


class CompressedBlockError(BundleError):
    """A table block stored compressed (type 1 is snappy)."""


class BigEndianBundleError(BundleError):
    """A bundle written big-endian."""


class UnsupportedDtypeError(BundleError):
    """A tensor of a dtype other than float32, float64, int32, int64."""


class PartitionedVariableError(BundleError):
    """A partitioned variable (an entry with `slices`)."""


class CorruptBundleError(BundleError):
    """A bad magic, a malformed block or proto, or a CRC mismatch."""


def is_model_variable(name: str) -> bool:
    """`load_tf1_variables`'s rule: no optimizer slots, no beta powers."""
    return (not name.endswith(("Adam", "Adam_1", "RMSProp", "RMSProp_1"))
            and "power" not in name)


# ------------------------------------------------------------- varints
def _varint(buf: bytes, pos: int, limit: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= limit or shift > 63:
            raise CorruptBundleError("truncated or over-long varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _proto_fields(buf: bytes) -> Dict[int, List]:
    """A protobuf message -> {field number: [values]}: varints and fixed
    ints as ints, length-delimited fields as bytes."""
    out: Dict[int, List] = {}
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _varint(buf, pos, end)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(buf, pos, end)
        elif wire == 1:
            val, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos, end)
            val, pos = bytes(buf[pos:pos + n]), pos + n
        elif wire == 5:
            val, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        else:
            raise CorruptBundleError(f"protobuf wire type {wire}")
        if pos > end:
            raise CorruptBundleError("truncated protobuf field")
        out.setdefault(field, []).append(val)
    return out


def _one(fields: Dict[int, List], number: int, default=0):
    vals = fields.get(number)
    return vals[-1] if vals else default


# --------------------------------------------------------------- table
def _block(data: bytes, offset: int, size: int, what: str) -> bytes:
    """The contents of the block at `offset`, its trailer checked."""
    end = offset + size
    if offset < 0 or end + BLOCK_TRAILER_BYTES > len(data):
        raise CorruptBundleError(f"{what} block handle ({offset}, {size}) "
                                 f"past the end of the index file")
    kind = data[end]
    if kind != 0:
        raise CompressedBlockError(
            f"{what} block at {offset} has compression type {kind}"
            f"{' (snappy)' if kind == 1 else ''}; this reader reads "
            f"uncompressed tables only")
    contents = data[offset:end]
    stored = struct.unpack_from("<I", data, end + 1)[0]
    if masked_crc(data[offset:end + 1]) != stored:
        raise CorruptBundleError(f"{what} block at {offset}: CRC mismatch")
    return contents


def _block_entries(contents: bytes, what: str) -> List[Tuple[bytes, bytes]]:
    """(key, value) of each entry of a block, the prefix-compressed keys
    rebuilt; every restart point must start an entry that shares
    nothing with the key before it."""
    if len(contents) < 4:
        raise CorruptBundleError(f"{what} block of {len(contents)} bytes")
    n_restarts = struct.unpack_from("<I", contents, len(contents) - 4)[0]
    limit = len(contents) - 4 * (n_restarts + 1)
    if limit < 0:
        raise CorruptBundleError(f"{what} block: {n_restarts} restarts "
                                 f"in {len(contents)} bytes")
    restarts = set(struct.unpack_from(f"<{n_restarts}I", contents, limit))
    entries, key, pos = [], b"", 0
    while pos < limit:
        start = pos
        shared, pos = _varint(contents, pos, limit)
        fresh, pos = _varint(contents, pos, limit)
        vlen, pos = _varint(contents, pos, limit)
        if shared > len(key) or pos + fresh + vlen > limit or (
                start in restarts and shared):
            raise CorruptBundleError(f"{what} block: bad entry at {start}")
        restarts.discard(start)
        key = key[:shared] + contents[pos:pos + fresh]
        pos += fresh
        entries.append((key, contents[pos:pos + vlen]))
        pos += vlen
    if restarts - ({0} if not entries else set()):
        raise CorruptBundleError(f"{what} block: restart points "
                                 f"{sorted(restarts)} start no entry")
    return entries


def _table(index_path: str) -> List[Tuple[bytes, bytes]]:
    """Every (key, value) of a leveldb-format table file, in key order."""
    with open(index_path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise CorruptBundleError(f"{index_path}: {len(data)} bytes, no "
                                 "table footer")
    footer = data[-FOOTER_BYTES:]
    if struct.unpack_from("<Q", footer, 40)[0] != TABLE_MAGIC:
        raise CorruptBundleError(f"{index_path}: not a table (bad magic)")
    handles = _table_handles(data)
    _block(data, *handles[0], "metaindex")
    out = []
    for _sep, handle in _block_entries(_block(data, *handles[1], "index"),
                                       "index"):
        off, p = _varint(handle, 0, len(handle))
        size, _ = _varint(handle, p, len(handle))
        out += _block_entries(_block(data, off, size, "data"), "data")
    return out


def _table_handles(data: bytes) -> List[Tuple[int, int]]:
    """The footer's (offset, size) handles: the metaindex, the index."""
    footer, pos, out = data[-FOOTER_BYTES:], 0, []
    for _ in range(2):
        off, pos = _varint(footer, pos, 40)
        size, pos = _varint(footer, pos, 40)
        out.append((off, size))
    return out


# -------------------------------------------------------------- reader
def resolve_prefix(path: str) -> str:
    """A checkpoint prefix, or a directory whose `checkpoint` file names
    one (`model_checkpoint_path`, relative to the directory or absolute),
    as `tf.train.load_checkpoint` takes either."""
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if not os.path.exists(state):
            raise FileNotFoundError(f"{path} is a directory without a "
                                    "`checkpoint` file")
        with open(state) as f:
            m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"',
                          f.read(), re.M)
        if not m:
            raise BundleError(f"{state} names no model_checkpoint_path")
        name = m.group(1).encode().decode("unicode_escape")
        path = name if os.path.isabs(name) else os.path.join(path, name)
    if not os.path.exists(path + ".index"):
        raise FileNotFoundError(f"no tensor bundle at {path} "
                                f"({path}.index missing)")
    return path


def _shape(buf: bytes, name: str) -> Tuple[int, ...]:
    fields = _proto_fields(buf)
    if _one(fields, 3):
        raise BundleError(f"{name}: a shape of unknown rank")
    return tuple(_one(_proto_fields(d), 1) for d in fields.get(2, []))


def read_bundle(path: str,
                keep: Optional[Callable[[str], bool]] = is_model_variable
                ) -> Dict[str, np.ndarray]:
    """{name: array} of the bundle at `path` (a prefix, or a directory
    with a `checkpoint` file), each tensor's CRC checked. `keep` picks the
    names (default `is_model_variable`; None keeps all)."""
    prefix = resolve_prefix(path)
    entries = _table(prefix + ".index")
    if not entries or entries[0][0] != b"":
        raise CorruptBundleError(f"{prefix}.index has no bundle header")
    header = _proto_fields(entries[0][1])
    if _one(header, 2) == 1:
        raise BigEndianBundleError(f"{prefix} was written big-endian")
    num_shards = _one(header, 1, 1)
    out: Dict[str, np.ndarray] = {}
    files: Dict[int, object] = {}
    try:
        for key, value in entries[1:]:
            if key.startswith(b"\x00"):
                continue  # a slice's key; its variable has its own entry
            name = key.decode()
            if keep is not None and not keep(name):
                continue
            e = _proto_fields(value)
            if e.get(7):
                raise PartitionedVariableError(
                    f"{name} is a partitioned variable (slices)")
            code = _one(e, 1)
            if code not in DTYPES:
                raise UnsupportedDtypeError(
                    f"{name}: dtype {DTYPE_NAMES.get(code, code)}; read "
                    f"are {[str(d) for d in DTYPES.values()]}")
            dtype, shape = DTYPES[code], _shape(_one(e, 2, b""), name)
            shard, offset, size = _one(e, 3), _one(e, 4), _one(e, 5)
            count = int(np.prod(shape, dtype=np.int64))
            if size != count * dtype.itemsize or shard >= num_shards:
                raise CorruptBundleError(
                    f"{name}: {size} bytes in shard {shard} of "
                    f"{num_shards} for {dtype} {shape}")
            if shard not in files:
                files[shard] = open(f"{prefix}.data-{shard:05d}-of-"
                                    f"{num_shards:05d}", "rb")
            f = files[shard]
            f.seek(offset)
            arr = np.empty(count, dtype)
            if f.readinto(memoryview(arr).cast("B")) != size:
                raise CorruptBundleError(f"{name}: data past the end of "
                                         f"shard {shard}")
            if masked_crc(arr) != _one(e, 6):
                raise CorruptBundleError(f"{name}: CRC mismatch")
            out[name] = arr.reshape(shape)
    finally:
        for f in files.values():
            f.close()
    return out


# -------------------------------------------------------------- writer
class _BlockBuilder:
    def __init__(self):
        self.buf, self.restarts, self.count, self.last = bytearray(), [0], \
            0, b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.count % RESTART_INTERVAL:
            while (shared < min(len(key), len(self.last))
                   and key[shared] == self.last[shared]):
                shared += 1
        elif self.count:
            self.restarts.append(len(self.buf))
        self.buf += (varint(shared) + varint(len(key) - shared)
                     + varint(len(value)) + key[shared:] + value)
        self.last, self.count = key, self.count + 1

    def size(self) -> int:
        """The finished block's bytes (leveldb's size estimate)."""
        return len(self.buf) + 4 * (len(self.restarts) + 1)

    def finish(self) -> bytes:
        return bytes(self.buf) + struct.pack(
            f"<{len(self.restarts) + 1}I", *self.restarts,
            len(self.restarts))


def _write_block(f, contents: bytes) -> bytes:
    """Write a block and its trailer; returns its handle."""
    handle = varint(f.tell()) + varint(len(contents))
    trailer = b"\x00"
    f.write(contents + trailer + struct.pack(
        "<I", masked_crc(contents + trailer)))
    return handle


def write_bundle(prefix: str, tensors: Mapping[str, np.ndarray]) -> str:
    """Write `tensors` as a one-shard bundle at `prefix` (P.index,
    P.data-00000-of-00001); returns the prefix."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    rows = []
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        for name in sorted(tensors, key=str.encode):
            arr = np.asarray(tensors[name])
            if arr.dtype.newbyteorder("<") not in _DTYPE_NUMBERS:
                raise UnsupportedDtypeError(f"{name}: dtype {arr.dtype}")
            arr = np.ascontiguousarray(
                arr, arr.dtype.newbyteorder("<")).reshape(arr.shape)
            shape = b"".join(field(2, int_field(1, d)) for d in arr.shape)
            entry = (int_field(1, _DTYPE_NUMBERS[arr.dtype])
                     + field(2, shape)
                     + (int_field(4, f.tell()) if f.tell() else b"")
                     + (int_field(5, arr.nbytes) if arr.nbytes else b"")
                     + b"\x35" + struct.pack(
                         "<I", masked_crc(arr)))
            f.write(arr.tobytes())
            rows.append((name.encode(), entry))
    header = int_field(1, 1) + field(3, int_field(1, 1))
    with open(prefix + ".index", "wb") as f:
        index, block = _BlockBuilder(), _BlockBuilder()
        for key, value in [(b"", header)] + rows:
            block.add(key, value)
            if block.size() >= BLOCK_BYTES:
                index.add(key, _write_block(f, block.finish()))
                block = _BlockBuilder()
        if block.count:
            index.add(block.last, _write_block(f, block.finish()))
        meta = _write_block(f, _BlockBuilder().finish())
        handles = meta + _write_block(f, index.finish())
        f.write(handles + bytes(40 - len(handles))
                + struct.pack("<Q", TABLE_MAGIC))
    return prefix
