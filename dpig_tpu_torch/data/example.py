"""The tf.Example wire format without protobuf: the plain version of the
native parser (`csrc/tfrecord_scanner.cc:tfr_parse`) and an encoder, with
`build_pair_example`, the one assembly of the pair schema's features
(the counterpart of `dpig_tpu/data/convert/builder.py:33`, whose
peaks-to-masks half is `data/convert/builder.py`).

Wire layout (tensorflow/core/example/example.proto + feature.proto):
  Example     { Features features = 1; }
  Features    { map<string, Feature> feature = 1; }   // repeated entry
  map entry   { string key = 1; Feature value = 2; }
  Feature     { oneof { BytesList bytes_list = 1;
                        FloatList float_list = 2;
                        Int64List int64_list = 3; } }
  BytesList   { repeated bytes value = 1; }
  FloatList   { repeated float value = 1 [packed]; }  // or unpacked
  Int64List   { repeated int64 value = 1 [packed]; }  // or unpacked

`parse_example_features_plain` follows `tfr_parse` step for step, in
Python with the packed lists decoded by numpy (varints included), so the
two agree on every input, malformed ones too: protobuf's semantics for
well-formed records (packed and unpacked lists, the last entry of a
duplicated key wins) and the C++ parser's own for the rest.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from . import pose_tools as pt
from .native import Feature

_U64 = (1 << 64) - 1


class _Cursor:
    """`Cursor` of tfrecord_scanner.cc over rec[p:end]."""

    __slots__ = ("rec", "p", "end", "ok")

    def __init__(self, rec: bytes, p: int, end: int):
        self.rec, self.p, self.end, self.ok = rec, p, end, True

    def varint(self) -> int:
        v, shift, rec = 0, 0, self.rec
        while self.p < self.end and shift < 64:
            b = rec[self.p]
            self.p += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v & _U64
            shift += 7
        self.ok = False
        return 0

    def tag(self) -> Tuple[int, int]:
        """(field number, wire type); field 0 at the end or on an error."""
        if self.p >= self.end:
            return 0, 0
        t = self.varint()
        if not self.ok:
            return 0, 0
        return (t >> 3) & 0xFFFFFFFF, t & 7

    def skip(self, wt: int) -> None:
        if wt == 0:
            self.varint()
        elif wt in (1, 5):
            size = 8 if wt == 1 else 4
            if self.end - self.p < size:
                self.ok = False
                return
            self.p += size
        elif wt == 2:
            n = self.varint()
            if n > self.end - self.p:
                self.ok = False
                return
            self.p += n
        else:
            self.ok = False
        if self.p > self.end:
            self.ok = False


class _Slot:
    """One wanted feature's outputs, as tfr_parse keeps them: the buffer
    persists across a duplicate key's reset, as the C++ one does."""

    __slots__ = ("cap", "buf", "count", "type", "boff", "blen")

    def __init__(self, cap: int):
        self.cap = cap
        self.buf = np.zeros(max(cap, 1), np.float32)
        self.reset()

    def reset(self) -> None:
        self.count, self.type, self.boff, self.blen = 0, 0, -1, 0

    def write(self, vals: np.ndarray) -> None:
        if self.count < self.cap:
            k = min(len(vals), self.cap - self.count)
            self.buf[self.count:self.count + k] = vals[:k]
        self.count += len(vals)


def _packed_varints(seg: np.ndarray) -> Tuple[np.ndarray, bool]:
    """Packed varints -> (int64 values, whether the run was whole). Like
    the C++ loop, a truncated or over-long (> 10 byte) varint ends the run
    and keeps the values before it."""
    ends = np.flatnonzero(seg < 0x80)
    starts = np.concatenate(([0], ends[:-1] + 1)).astype(np.int64)
    lens = ends - starts + 1
    whole = bool(ends.size) and ends[-1] == seg.size - 1
    too_long = np.flatnonzero(lens > 10)
    if too_long.size:
        ends, starts, lens = (a[:too_long[0]] for a in (ends, starts, lens))
        whole = False
    if not ends.size:
        return np.zeros(0, np.int64), seg.size == 0
    if (lens == 1).all():
        return seg[ends].astype(np.int64), whole
    body = seg[:ends[-1] + 1]
    pos = np.arange(body.size) - np.repeat(starts, lens)
    parts = (body & 0x7F).astype(np.uint64) << (7 * pos).astype(np.uint64)
    return np.bitwise_or.reduceat(parts, starts).view(np.int64), whole


def _parse_feature(rec: bytes, arr: np.ndarray, c: _Cursor,
                   s: _Slot) -> None:
    """`ParseFeature` of tfrecord_scanner.cc: an error ends this feature
    quietly, keeping what it had."""
    while True:
        field, wt = c.tag()
        if not field:
            return
        if wt != 2:
            c.skip(wt)
            continue
        n = c.varint()
        if not c.ok or n > c.end - c.p:
            return
        lst = _Cursor(rec, c.p, c.p + n)
        c.p += n
        if field == 1:  # BytesList
            s.type = 1
            while True:
                lf, lwt = lst.tag()
                if not lf:
                    break
                if lf == 1 and lwt == 2:
                    bn = lst.varint()
                    if not lst.ok or bn > lst.end - lst.p:
                        return
                    if s.count == 0:  # first element only
                        s.boff, s.blen = lst.p, bn
                    s.count += 1
                    lst.p += bn
                else:
                    lst.skip(lwt)
                    if not lst.ok:
                        return
        elif field in (2, 3):  # FloatList, Int64List
            s.type = field
            while True:
                lf, lwt = lst.tag()
                if not lf:
                    break
                if lf != 1:
                    lst.skip(lwt)
                    continue
                if lwt == 2:  # packed
                    bn = lst.varint()
                    if not lst.ok or bn > lst.end - lst.p:
                        return
                    if field == 2:
                        s.write(np.frombuffer(rec, "<f4", bn // 4, lst.p))
                        lst.p += bn
                        continue
                    vals, whole = _packed_varints(arr[lst.p:lst.p + bn])
                    lst.p += bn
                    s.write(vals.astype(np.float32))
                    if not whole:
                        return
                elif field == 2 and lwt == 5:  # unpacked float
                    if 4 > lst.end - lst.p:
                        return
                    s.write(np.frombuffer(rec, "<f4", 1, lst.p))
                    lst.p += 4
                elif field == 3 and lwt == 0:  # unpacked varint
                    v = lst.varint()
                    if not lst.ok:
                        return
                    s.write(np.array([v], np.uint64).view(np.int64)
                            .astype(np.float32))
                else:
                    lst.skip(lwt)
                    if not lst.ok:
                        return


def parse_example_features_plain(record: bytes,
                                 wanted: Sequence[Tuple[str, int]]
                                 ) -> Dict[str, Feature]:
    """The plain version of `native.parse_example_features`: the same
    arguments, the same results, IOError where tfr_parse returns -1."""
    rec = bytes(record)
    arr = np.frombuffer(rec, np.uint8)
    keys = [name.encode() for name, _ in wanted]
    slots = [_Slot(cap) for _, cap in wanted]
    seen = [False] * len(wanted)
    ex = _Cursor(rec, 0, len(rec))
    while True:
        field, wt = ex.tag()
        if not field:
            break
        if field != 1 or wt != 2:
            ex.skip(wt)
            continue
        flen = ex.varint()
        if not ex.ok or flen > ex.end - ex.p:
            raise IOError("malformed tf.Example record")
        feats = _Cursor(rec, ex.p, ex.p + flen)
        ex.p += flen
        while True:
            ffield, fwt = feats.tag()
            if not ffield:
                break
            if ffield != 1 or fwt != 2:
                feats.skip(fwt)
                continue
            elen = feats.varint()
            if not feats.ok or elen > feats.end - feats.p:
                raise IOError("malformed tf.Example record")
            entry = _Cursor(rec, feats.p, feats.p + elen)
            feats.p += elen
            key = val = None
            while True:
                ef, ewt = entry.tag()
                if not ef:
                    break
                if ewt != 2:
                    entry.skip(ewt)
                    continue
                n = entry.varint()
                if not entry.ok or n > entry.end - entry.p:
                    raise IOError("malformed tf.Example record")
                if ef == 1:
                    key = rec[entry.p:entry.p + n]
                elif ef == 2:
                    val = (entry.p, n)
                entry.p += n
            if key is None or val is None:
                continue
            for i, k in enumerate(keys):
                if key == k:
                    if seen[i]:  # a duplicate key: the last entry wins
                        slots[i].reset()
                    seen[i] = True
                    _parse_feature(rec, arr, _Cursor(rec, val[0],
                                                     val[0] + val[1]),
                                   slots[i])
                    break
    if not ex.ok:
        raise IOError("malformed tf.Example record")
    out: Dict[str, Feature] = {}
    for (name, cap), s in zip(wanted, slots):
        if s.type == 0:
            out[name] = None
        elif s.type == 1:
            out[name] = (s.boff, s.blen)
        elif s.count > cap:
            out[name] = s.count
        else:
            out[name] = s.buf[:s.count]
    return out


# ------------------------------------------------------------- encoding
def varint(v: int) -> bytes:
    v &= _U64
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vals: np.ndarray) -> bytes:
    """`varint` of each int64, concatenated, in numpy: seven bits a byte,
    the high bit set on all but a value's last byte, negatives as their
    64-bit two's complement (ten bytes)."""
    u = vals.view(np.uint64)
    shifts = np.arange(10, dtype=np.uint64) * np.uint64(7)
    groups = (u[:, None] >> shifts) & np.uint64(0x7F)
    n = np.maximum(1, 10 - np.argmax(
        (u[:, None] >> shifts)[:, ::-1] != 0, axis=1))
    n[u == 0] = 1
    k = np.arange(10)
    groups |= np.where(k < n[:, None] - 1, 0x80, 0).astype(np.uint64)
    return groups[k < n[:, None]].astype(np.uint8).tobytes()


def field(number: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return varint(number << 3 | 2) + varint(len(payload)) + payload


def int_field(number: int, value: int) -> bytes:
    """A varint field."""
    return varint(number << 3) + varint(value)


def _encode_feature(kind: str, values) -> bytes:
    """One Feature: kind 'bytes' (a sequence of bytes), 'float' (packed
    float32, each value rounded from float64 as protobuf does) or 'int64'
    (packed varints, negatives in ten bytes)."""
    if kind == "bytes":
        return field(1, b"".join(field(1, v) for v in values))
    if kind == "float":
        vals = np.asarray(values, np.float64).ravel().astype("<f4")
        return field(2, field(1, vals.tobytes()) if vals.size else b"")
    if kind == "int64":
        vals = np.asarray(values).ravel()
        if vals.dtype.kind in "iub" and vals.size and (
                vals.min() >= 0 and vals.max() < 0x80):
            packed = vals.astype(np.uint8).tobytes()  # one byte each
        else:
            packed = _varints(vals.astype(np.int64))
        return field(3, field(1, packed) if vals.size else b"")
    raise ValueError(f"unknown feature kind {kind!r}")


def encode_example(features: Mapping[str, Tuple[str, object]]) -> bytes:
    """{name: (kind, values)} -> a serialized tf.Example, one map entry
    per name in the given order."""
    entries = b"".join(
        field(1, field(1, name.encode()) + field(2, _encode_feature(*kv)))
        for name, kv in features.items())
    return field(1, entries)


def build_pair_example(
    *,
    name_0: str, name_1: str,
    image_raw_0: bytes, image_raw_1: bytes,
    peaks_0: Optional[list], peaks_1: Optional[list],
    height: int, width: int,
    label: int, id_0: int, id_1: int, cam_0: int = 0, cam_1: int = 0,
    masks_0: Mapping[str, np.ndarray], masks_1: Mapping[str, np.ndarray],
    part_bbox_0, part_vis_0, part_bbox_1, part_vis_1,
    roi10_0: Optional[np.ndarray] = None,
    roi10_1: Optional[np.ndarray] = None,
    attrs_0: Optional[Sequence[int]] = None,
    attrs_1: Optional[Sequence[int]] = None,
    attrs_w2v_0: Optional[Mapping[int, Sequence[float]]] = None,
    attrs_w2v_1: Optional[Mapping[int, Sequence[float]]] = None,
    keypoint_num: int = 18,
    image_format: str = "jpg",
) -> Optional[bytes]:
    """One pair record of the published schema, or None if a pose is
    missing: the one place the port assembles the schema's features, those
    of the JAX package's `build_pair_example`
    (`dpig_tpu/data/convert/builder.py:33`), whose parse equals it. Peaks
    are OpenPose's, one list per keypoint, `[[x, y, ...]]` or `[]`; the
    rcv coordinates, the 16x8 grid and the radius-4 sparse pose come from
    them here. The masks ({feature key: [H, W] array}, e.g.
    'pose_mask_r4' and 'pose_mask_r6' for Market), the 37 part bboxes and
    their visibility, DeepFashion's [H, W, 10] `roi10` masks and the
    word2vec attributes ({dim: floats}) come from the caller: the
    converter (`data/convert/builder.py`) computes them from the peaks,
    `data/synthetic.py` passes its fixtures'."""
    if peaks_0 is None or peaks_1 is None:
        return None
    f = {"image_name_0": ("bytes", [name_0.encode()]),
         "image_name_1": ("bytes", [name_1.encode()]),
         "image_raw_0": ("bytes", [image_raw_0]),
         "image_raw_1": ("bytes", [image_raw_1]),
         "label": ("int64", [label]), "id_0": ("int64", [id_0]),
         "id_1": ("int64", [id_1]), "cam_0": ("int64", [cam_0]),
         "cam_1": ("int64", [cam_1]),
         "image_format": ("bytes", [image_format.encode()]),
         "image_height": ("int64", [height]),
         "image_width": ("int64", [width]), "real_data": ("int64", [1]),
         "attrs_0": ("int64", attrs_0 if attrs_0 is not None else [0] * 27),
         "attrs_1": ("int64", attrs_1 if attrs_1 is not None else [0] * 27)}
    for suffix, w2v in (("_0", attrs_w2v_0), ("_1", attrs_w2v_1)):
        for dim, vals in (w2v or {}).items():
            f[f"attrs_w2v{dim}{suffix}"] = ("float", vals)
    for suffix, peaks, masks, bbox, vis, roi10 in (
            ("_0", peaks_0, masks_0, part_bbox_0, part_vis_0, roi10_0),
            ("_1", peaks_1, masks_1, part_bbox_1, part_vis_1, roi10_1)):
        # rcv coords + 16x8-grid one-hot (convert_market.py:465-492)
        rcv = np.zeros([keypoint_num, 3], np.float32)
        grid = np.zeros([16, 8, keypoint_num], np.float32)
        h_unit, w_unit = height / 16, width / 8
        for k, p in enumerate(peaks):
            if len(p) != 0:
                rcv[k] = [p[0][1], p[0][0], 1]
                grid[int(p[0][1] / h_unit), int(p[0][0] / w_unit), k] = 1
        f[f"pose_peaks{suffix}"] = ("float", grid)
        f[f"pose_peaks{suffix}_rcv"] = ("float", rcv)
        indices, values, shape = pt.get_sparse_pose(
            peaks, height, width, keypoint_num, radius=4, mode="Solid")
        ind, shape_flat = pt.one_dim_sparse(indices, shape)
        f[f"indices_r4{suffix}"] = ("int64", ind)
        f[f"values_r4{suffix}"] = ("float", values)
        for key, mask in masks.items():
            f[f"{key}{suffix}"] = ("int64", np.asarray(mask, np.int64))
        f[f"part_bbox{suffix}"] = ("int64", np.asarray(bbox, np.int64))
        f[f"part_vis{suffix}"] = ("int64", np.asarray(vis, np.int64))
        if roi10 is not None:
            f[f"roi10_mask{suffix}"] = ("int64", np.asarray(roi10, np.int64))
    f["shape"] = ("int64", [shape_flat])
    return encode_example(f)
