"""TFRecord pair-dataset reader: the port's copy of
`dpig_tpu/data/loader.py` (reference datasets/market1501.py:50-162,
datasets/deepfashion.py:50-171 + trainer.py:537-564 input pipeline).

Parses the published tfrecord schema into numpy batch dicts:
  x, x_target              [B,H,W,3] float32 in [-1,1]  (jpeg -> PIL)
  pose_rcv(_target)        [B,18,3]  float32 raw pixel coords
  mask_r4/r6(_target)      [B,H,W,1] float32 {0,1}
  part_bbox(_target)       [B,37,4]  int32
  part_vis(_target)        [B,37]    int32

Pose maps are not rendered here: they rasterize on the device inside the
step (`ops/pose.py`, the CUDA kernel on the card), so the host->device
copy per sample is 54 floats instead of a 147k-element map.

Records are indexed and parsed by the native scanner
(`csrc/tfrecord_scanner.cc`, built by g++ on first use) and nothing else:
the JAX package falls back to protobuf where the native library is
missing or a record is malformed; the port imports no protobuf, and a
record the native parser cannot take raises. `parser="plain"` parses with
its plain version (`data/example.py`) instead, for the checks.

Determinism: test iteration is single-stream file order (the reference
forces num_threads=1 at test, trainer.py:108-110); training uses a
shuffle buffer with a seeded RNG, the JAX package's algorithm, so the
same seed gives the same batches in the same order.
"""
from __future__ import annotations

import io
import os
import pickle
import queue
import random
import threading
import functools
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
from PIL import Image

from . import native, tfrecord
from .example import parse_example_features_plain

# mask_a fills the batch's primary "mask_r6" slot (the mask the trainers
# consume): r6 for Market (trainer.py:548-549), r4 for DF
# (trainer_256.py:240-247 reads pose_mask_r4 as `self.mask`).
MARKET_KEYS = dict(mask_b="pose_mask_r4", mask_a="pose_mask_r6")
DF_KEYS = dict(mask_b="pose_mask_r8", mask_a="pose_mask_r4")


_PARSERS = {"native": native.parse_example_features,
            "plain": parse_example_features_plain}


def _features(record: bytes, wanted, parser: str):
    if parser not in _PARSERS:
        raise ValueError(f"parser must be 'native' or 'plain', got "
                         f"{parser!r}")
    return _PARSERS[parser](record, wanted)


def _n_values(feature):
    """What a parsed feature holds, for an error message: its element
    count (an int is the true count of an over-capacity feature)."""
    if feature is None or isinstance(feature, int):
        return feature or 0
    return "a bytes" if isinstance(feature, tuple) else feature.size


def _wrong_size(name: str, got, want: int) -> ValueError:
    return ValueError(f"feature {name} has {_n_values(got)} values, "
                      f"expected {want}")


def parse_example(record: bytes, img_h: int, img_w: int, part_num: int = 37,
                  keypoint_num: int = 18, mask_a: str = "pose_mask_r6",
                  mask_b: str = "pose_mask_r4",
                  fields: str = "all",
                  parser: str = "native") -> Dict[str, np.ndarray]:
    """One tfrecord Example -> numpy sample dict (un-batched).

    Uses the native single-pass wire parser (`tfr_parse`); `parser="plain"`
    its plain version. A record with a feature missing or of the wrong
    size raises (KeyError for the masks, which name the dataset flavor,
    ValueError for the rest), as the JAX package's protobuf path does.

    fields="pose_only" parses ONLY the pose keypoint coordinates and fills
    images/masks/bboxes with zeros. Exact for the sampled-appearance
    serving path (model 11 `--sample_app`): the generator consumes
    mapper-sampled embeddings and pose maps rendered on the device, so the
    encoder inputs are dead (the port's tester does not run the encoder
    there), and decoding the JPEGs on the host would burn a core for
    nothing."""
    if fields == "pose_only":
        return _parse_pose_only(record, img_h, img_w, part_num,
                                keypoint_num, parser)
    return _parse_example_native(record, img_h, img_w, part_num,
                                 keypoint_num, mask_a, mask_b, parser)


_POSE_ONLY_ZEROS: Dict[tuple, tuple] = {}


def _parse_pose_only(record: bytes, img_h: int, img_w: int,
                     part_num: int, keypoint_num: int,
                     parser: str = "native") -> Dict[str, np.ndarray]:
    """fields="pose_only" parse: real pose_rcv(+_target), zero fillers for
    the image-branch keys (the same dict schema)."""
    wanted = [(f"pose_peaks{s}_rcv", keypoint_num * 3) for s in ("_0", "_1")]
    feats = _features(record, wanted, parser)
    rcvs = {}
    for name, cap in wanted:
        v = feats[name]
        if not isinstance(v, np.ndarray) or v.size != cap:
            raise _wrong_size(name, v, cap)
        rcvs[name] = v.reshape(keypoint_num, 3)
    # shared read-only zero fillers (one allocation per shape per process;
    # consumers treat loader output as immutable)
    key = (img_h, img_w, part_num)
    if key not in _POSE_ONLY_ZEROS:
        _POSE_ONLY_ZEROS[key] = (
            np.zeros((img_h, img_w, 3), np.float32),
            np.zeros((img_h, img_w, 1), np.float32),
            np.zeros((part_num, 4), np.int32),
            np.zeros((part_num,), np.int32))
    zero_img, zero_mask, zero_bbox, zero_vis = _POSE_ONLY_ZEROS[key]
    out: Dict[str, np.ndarray] = {}
    for suffix, tag in (("_0", ""), ("_1", "_target")):
        out[f"x{tag}"] = zero_img
        out[f"pose_rcv{tag}"] = rcvs[f"pose_peaks{suffix}_rcv"]
        out[f"mask_r6{tag}"] = zero_mask
        out[f"mask_r4{tag}"] = zero_mask
        out[f"part_bbox{tag}"] = zero_bbox
        out[f"part_vis{tag}"] = zero_vis
    return out


def _parse_example_native(record: bytes, img_h: int, img_w: int,
                          part_num: int, keypoint_num: int,
                          mask_a: str, mask_b: str,
                          parser: str = "native") -> Dict[str, np.ndarray]:
    px = img_h * img_w
    wanted = []
    for s in ("_0", "_1"):
        wanted += [(f"image_raw{s}", 0),
                   (f"pose_peaks{s}_rcv", keypoint_num * 3),
                   (f"{mask_a}{s}", px), (f"{mask_b}{s}", px),
                   (f"part_bbox{s}", part_num * 4),
                   (f"part_vis{s}", part_num)]
    feats = _features(record, wanted, parser)
    out: Dict[str, np.ndarray] = {}
    for suffix, tag in (("_0", ""), ("_1", "_target")):
        raw = feats[f"image_raw{suffix}"]
        if not isinstance(raw, tuple) or raw[0] < 0:
            raise ValueError(f"feature image_raw{suffix} is not a bytes "
                             "feature")
        off, ln = raw
        img = np.asarray(Image.open(io.BytesIO(record[off:off + ln]))
                         .convert("RGB"), np.float32)
        out[f"x{tag}"] = img / 127.5 - 1.0
        rcv = feats[f"pose_peaks{suffix}_rcv"]
        if not isinstance(rcv, np.ndarray) or rcv.size != keypoint_num * 3:
            raise _wrong_size(f"pose_peaks{suffix}_rcv", rcv,
                              keypoint_num * 3)
        out[f"pose_rcv{tag}"] = rcv.reshape(keypoint_num, 3)
        for store, key in (("mask_r6", mask_a), ("mask_r4", mask_b)):
            vals = feats[f"{key}{suffix}"]
            if not isinstance(vals, np.ndarray) or vals.size != px:
                raise KeyError(
                    f"feature {key}{suffix} has {_n_values(vals)} values, "
                    "expected "
                    f"{img_h}x{img_w} — wrong dataset flavor? (Market stores "
                    "pose_mask_r4/r6, DF stores pose_mask_r4/r8; the flavor "
                    "is chosen by whether 'market' is in the dataset name, "
                    "as in the reference trainer.py:35)")
            out[f"{store}{tag}"] = vals.reshape(img_h, img_w, 1)
        for name, n in (("part_bbox", part_num * 4), ("part_vis", part_num)):
            v = feats[f"{name}{suffix}"]
            if not isinstance(v, np.ndarray) or v.size != n:
                raise _wrong_size(f"{name}{suffix}", v, n)
        out[f"part_bbox{tag}"] = feats[f"part_bbox{suffix}"].astype(
            np.int32).reshape(part_num, 4)
        out[f"part_vis{tag}"] = feats[f"part_vis{suffix}"].astype(np.int32)
    return out


def iter_records(shards: List[str], repeat: bool = False) -> Iterator[bytes]:
    while True:
        for shard in shards:
            yield from tfrecord.read_records(shard)
        if not repeat:
            return


def iter_examples(shards: List[str], img_h: int, img_w: int,
                  mask_keys: Dict[str, str], part_num: int = 37,
                  repeat: bool = False,
                  num_workers: int = 0, stride: int = 1,
                  offset: int = 0,
                  fields: str = "all",
                  worker_mode: str = "thread"
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Parsed-sample stream. num_workers > 0 parses/decodes on an executor
    with an ordered in-flight window, so the output ORDER is identical
    to the sequential path for any worker count (the reference pins test
    readers to 1 thread for order, trainer.py:108-110 — here order is
    deterministic even with workers). stride/offset select every
    `stride`-th record starting at `offset` (multi-host round-robin when
    there are fewer shards than hosts).

    worker_mode: 'thread' (default — PIL decode, the native ctypes parser,
    and numpy conversions all release the GIL, so threads scale on
    multi-core hosts with zero copy overhead) or 'process' (a
    ProcessPoolExecutor fallback for GIL-bound decode paths; each sample
    pays record-submit + ~300 KB result pickling, so prefer threads unless
    a profiler shows GIL serialization)."""
    if worker_mode not in ("thread", "process"):
        raise ValueError(f"unknown worker_mode {worker_mode!r}")
    records = iter_records(shards, repeat)
    if stride > 1:
        records = (r for i, r in enumerate(records)
                   if i % stride == offset)

    # module-level partial (not a closure) so the process pool can pickle it
    parse = functools.partial(parse_example, img_h=img_h, img_w=img_w,
                              part_num=part_num,
                              mask_a=mask_keys["mask_a"],
                              mask_b=mask_keys["mask_b"], fields=fields)

    if num_workers <= 0:
        for rec in records:
            yield parse(rec)
        return

    if worker_mode == "process":
        # forkserver: plain fork() from a thread-carrying parent (the
        # loader's own prefetch thread, the CUDA runtime's) can deadlock
        # the child on inherited lock state
        import multiprocessing
        pool = ProcessPoolExecutor(
            num_workers, mp_context=multiprocessing.get_context("forkserver"))
    else:
        pool = ThreadPoolExecutor(num_workers)
    with pool:
        pending: deque = deque()
        window = num_workers * 4
        for rec in records:
            pending.append(pool.submit(parse, rec))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


class _CountUnpickler(pickle.Unpickler):
    """Reads the pair-count pickle, which holds a number: a pickle from a
    dataset directory that names any class or function is refused
    rather than run."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"pn_pairs_num pickle names {module}.{name}; expected a number")


class TFRecordPairLoader:
    """Batched iterator over a DPIG pair dataset directory.

    dataset_dir layout mirrors the published bundles:
      <dir>/<name>_<split>_*.tfrecord  +  pn_pairs_num_<split>.p
    """

    def __init__(self, dataset_dir: str, split: str, batch_size: int,
                 img_h: int, img_w: int, dataset: str = "market",
                 shuffle: bool = True, seed: int = 0,
                 shuffle_buffer: int = 512,
                 host_id: int = 0, host_count: int = 1,
                 num_workers: int = 0, prefetch_batches: int = 2,
                 fields: str = "all", part_num: int = 37,
                 worker_mode: str = "thread"):
        self.dataset_dir = dataset_dir
        self.batch_size = batch_size
        self.img_h, self.img_w = img_h, img_w
        self.part_num = part_num
        self.mask_keys = MARKET_KEYS if "market" in dataset.lower() else DF_KEYS
        self.shuffle = shuffle
        self._fields = fields
        self._rng = random.Random(seed)
        self._buffer: List[Dict[str, np.ndarray]] = []
        self._buffer_size = shuffle_buffer if shuffle else 0

        shards = [os.path.join(dataset_dir, f) for f in
                  sorted(os.listdir(dataset_dir)) if ".tfrecord" in f
                  and split in f]
        if not shards:
            raise FileNotFoundError(
                f"no *{split}*.tfrecord shards in {dataset_dir}")
        # Multi-host: each host reads a disjoint shard subset (pass
        # host_id=the process rank, host_count=the number of processes).
        self._record_stride = 1
        self._record_offset = 0
        if host_count > 1:
            if len(shards) >= host_count:
                shards = shards[host_id::host_count]
            else:
                # Fewer shards than hosts: every host must still see a
                # DISJOINT record stream (a reseeded shuffle only
                # decorrelates orders; with shuffle=False it would feed
                # every host identical records and silently duplicate the
                # global batch). Round-robin records by host instead.
                self._record_stride = host_count
                self._record_offset = host_id
                self._rng = random.Random(seed * host_count + host_id)
        self.shards = shards
        self.num_samples = self._load_pair_count(split)
        # num_samples is PER-HOST in every multi-host configuration, so
        # callers sizing iteration from it never hit StopIteration early
        # with shuffle=False (single-host: == the global pair count).
        if host_count > 1:
            from .tfrecord import count_records
            if self._record_stride > 1:
                # Round-robin record striding over UN-split shards: this
                # host only sees records with index ≡ offset (mod stride)
                total = self.num_samples
                if total is None:
                    total = sum(count_records(s) for s in shards)
                self.num_samples = (
                    total - self._record_offset
                    + self._record_stride - 1) // self._record_stride
            else:
                # Shard-split path: shards may hold uneven record counts,
                # so count this host's records exactly (header-seek scan,
                # no payload reads — one-time init cost)
                self.num_samples = sum(count_records(s) for s in shards)
        self._it = iter_examples(shards, img_h, img_w, self.mask_keys,
                                 part_num=part_num,
                                 repeat=shuffle, num_workers=num_workers,
                                 stride=self._record_stride,
                                 offset=self._record_offset, fields=fields,
                                 worker_mode=worker_mode)
        # Batch prefetch: a daemon thread keeps `prefetch_batches` assembled
        # batches ahead so host decode overlaps device compute (the
        # reference's tf.train.batch queue runners, trainer.py:553-555).
        self._queue: Optional[queue.Queue] = None
        self._terminal = None  # sticky _END / producer exception
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        if num_workers > 0 and prefetch_batches > 0:
            self._queue = queue.Queue(maxsize=prefetch_batches)
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()

    _END = object()

    def _producer(self) -> None:
        try:
            while not self._stop:
                self._queue.put(self._assemble_batch())
        except StopIteration:
            self._queue.put(self._END)
        except Exception as e:  # surface loader crashes to the consumer
            self._queue.put(e)

    def _load_pair_count(self, split: str) -> Optional[int]:
        p = os.path.join(self.dataset_dir, f"pn_pairs_num_{split}.p")
        if os.path.exists(p):
            with open(p, "rb") as f:
                # py2 pickle (reference datasets/market1501.py:150-153)
                return int(_CountUnpickler(f, encoding="latin1").load())
        return None

    def _next_sample(self) -> Dict[str, np.ndarray]:
        if not self.shuffle:
            return next(self._it)
        while len(self._buffer) < self._buffer_size:
            try:
                self._buffer.append(next(self._it))
            except StopIteration:
                break
        if not self._buffer:
            raise StopIteration
        idx = self._rng.randrange(len(self._buffer))
        self._buffer[idx], self._buffer[-1] = self._buffer[-1], self._buffer[idx]
        return self._buffer.pop()

    def _assemble_batch(self) -> Dict[str, np.ndarray]:
        samples = [self._next_sample() for _ in range(self.batch_size)]
        if self._fields == "pose_only":
            # Stack only the live pose keys; the image-branch keys are
            # all-zero fillers — share one cached zero BATCH instead of
            # re-copying ~70 MB of zeros per batch (~9x assembly speedup).
            out = dict(self._pose_only_zero_batch(len(samples)))
            for k in ("pose_rcv", "pose_rcv_target"):
                out[k] = np.stack([s[k] for s in samples])
            return out
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _pose_only_zero_batch(self, b: int) -> Dict[str, np.ndarray]:
        zb = getattr(self, "_zb", None)
        if zb is None or zb["x"].shape[0] != b:
            h, w = self.img_h, self.img_w
            zi = np.zeros((b, h, w, 3), np.float32)
            zm = np.zeros((b, h, w, 1), np.float32)
            zbx = np.zeros((b, self.part_num, 4), np.int32)
            zv = np.zeros((b, self.part_num), np.int32)
            zb = {}
            for tag in ("", "_target"):
                zb[f"x{tag}"] = zi
                zb[f"mask_r6{tag}"] = zm
                zb[f"mask_r4{tag}"] = zm
                zb[f"part_bbox{tag}"] = zbx
                zb[f"part_vis{tag}"] = zv
            self._zb = zb
        return zb

    def close(self) -> None:
        """Stop the prefetch thread and shut the worker pool down (its
        processes too, in process mode). Idempotent."""
        self._stop = True
        if self._thread is not None:
            while self._thread.is_alive():  # free a producer blocked in put
                try:
                    self._queue.get(timeout=0.05)
                except queue.Empty:
                    pass
        self._it.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._queue is None:
            return self._assemble_batch()
        # The producer puts its _END/exception sentinel exactly once and
        # exits; remember it so every LATER call re-raises instead of
        # blocking forever on an empty queue.
        if self._terminal is not None:
            raise (StopIteration() if self._terminal is self._END
                   else self._terminal)
        item = self._queue.get()
        if item is self._END or isinstance(item, Exception):
            self._terminal = item
            if item is self._END:
                raise StopIteration
            raise item
        return item
