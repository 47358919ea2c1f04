"""Synthetic batch fixtures: the port's own copy of
`dpig_tpu/data/synthetic.py:14-68`.

Shape/dtype-faithful to the tfrecord schema (datasets/market1501.py:79-113).
The same seed gives the same numpy batches as the JAX package's loader;
batches stay numpy so callers pick the device. `write_synthetic_tfrecords`
(the port's own) writes such fixtures as a tfrecord pair dataset.
"""
from __future__ import annotations

import io
import os
import pickle
from typing import Dict, List

import numpy as np
from PIL import Image


def synthetic_batch(rng: np.random.Generator, batch_size: int, img_h: int,
                    img_w: int, keypoint_num: int = 18, part_num: int = 37
                    ) -> Dict[str, np.ndarray]:
    b = batch_size

    def image():
        return rng.uniform(-1.0, 1.0, (b, img_h, img_w, 3)).astype(np.float32)

    def pose_rcv():
        r = rng.uniform(0, img_h - 1, (b, keypoint_num, 1))
        c = rng.uniform(0, img_w - 1, (b, keypoint_num, 1))
        v = (rng.uniform(size=(b, keypoint_num, 1)) > 0.2).astype(np.float32)
        return np.concatenate([r, c, v], axis=-1).astype(np.float32)

    def mask():
        m = np.zeros((b, img_h, img_w, 1), np.float32)
        # central torso-ish blob
        m[:, img_h // 4: 3 * img_h // 4, img_w // 4: 3 * img_w // 4, :] = 1.0
        return m

    def bbox():
        y1 = rng.integers(0, img_h // 2, (b, part_num, 1))
        x1 = rng.integers(0, img_w // 2, (b, part_num, 1))
        h = rng.integers(4, img_h // 2, (b, part_num, 1))
        w = rng.integers(4, img_w // 2, (b, part_num, 1))
        y2 = np.minimum(y1 + h, img_h)
        x2 = np.minimum(x1 + w, img_w)
        return np.concatenate([y1, x1, y2, x2], axis=-1).astype(np.int32)

    def vis():
        return (rng.uniform(size=(b, part_num)) > 0.1).astype(np.int32)

    return {
        "x": image(), "x_target": image(),
        "pose_rcv": pose_rcv(), "pose_rcv_target": pose_rcv(),
        "mask_r4": mask(), "mask_r4_target": mask(),
        "mask_r6": mask(), "mask_r6_target": mask(),
        "part_bbox": bbox(), "part_bbox_target": bbox(),
        "part_vis": vis(), "part_vis_target": vis(),
    }


class SyntheticLoader:
    """Deterministic infinite batch iterator over synthetic fixtures."""

    def __init__(self, batch_size: int, img_h: int, img_w: int, seed: int = 0,
                 keypoint_num: int = 18, part_num: int = 37):
        self._rng = np.random.default_rng(seed)
        self._args = (batch_size, img_h, img_w, keypoint_num, part_num)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return synthetic_batch(self._rng, *self._args)

    def close(self) -> None:
        """Nothing to release (`TFRecordPairLoader.close`'s twin)."""


def write_synthetic_tfrecords(dataset_dir: str, split: str, n_pairs: int,
                              img_h: int, img_w: int, seed: int = 0,
                              n_shards: int = 1, name: str = "Market1501"
                              ) -> List[str]:
    """A pair dataset from `synthetic_batch` fixtures, for smoke runs and
    measurements without the published bundles: shards
    `<name>_<split>_XXXXX.tfrecord` of `build_pair_example` records (the
    images JPEG-encoded by PIL, the visible keypoints as OpenPose peaks,
    the synthetic masks, the part bboxes and visibility), records dealt
    round-robin over the shards, and the py2 pickle
    `pn_pairs_num_<split>.p` with the pair count. Returns the shard paths.

    The masks take the keys of the flavour the loader reads for `name`
    (`data/loader.py:MARKET_KEYS` / `DF_KEYS`): a Market name ("market" in
    it) stores 'pose_mask_r6' / 'pose_mask_r4', any other name the
    DeepFashion pair 'pose_mask_r4' / 'pose_mask_r8', each holding the
    fixture's mask of the batch slot that key fills ('mask_r6' /
    'mask_r4')."""
    from .example import build_pair_example
    from .loader import DF_KEYS, MARKET_KEYS
    from .tfrecord import TFRecordWriter

    keys = MARKET_KEYS if "market" in name.lower() else DF_KEYS

    rng = np.random.default_rng(seed)
    os.makedirs(dataset_dir, exist_ok=True)
    paths = [os.path.join(dataset_dir, f"{name}_{split}_{i:05d}.tfrecord")
             for i in range(n_shards)]
    writers = [TFRecordWriter(p) for p in paths]
    try:
        for i in range(n_pairs):
            b = synthetic_batch(rng, 1, img_h, img_w)
            kw = {}
            for s, tag in (("_0", ""), ("_1", "_target")):
                img = np.clip(np.rint((b[f"x{tag}"][0] + 1.0) * 127.5), 0,
                              255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="JPEG")
                kw[f"image_raw{s}"] = buf.getvalue()
                kw[f"peaks{s}"] = [[[float(c), float(r), 1.0, k]] if v > 0
                                   else [] for k, (r, c, v) in
                                   enumerate(b[f"pose_rcv{tag}"][0])]
                kw[f"masks{s}"] = {
                    keys["mask_a"]: b[f"mask_r6{tag}"][0, ..., 0],
                    keys["mask_b"]: b[f"mask_r4{tag}"][0, ..., 0]}
                kw[f"part_bbox{s}"] = b[f"part_bbox{tag}"][0]
                kw[f"part_vis{s}"] = b[f"part_vis{tag}"][0]
            writers[i % n_shards].write(build_pair_example(
                name_0=f"{i:05d}_0.jpg", name_1=f"{i:05d}_1.jpg",
                height=img_h, width=img_w, label=1, id_0=i, id_1=i,
                cam_0=0, cam_1=1, **kw))
    finally:
        for w in writers:
            w.close()
    with open(os.path.join(dataset_dir, f"pn_pairs_num_{split}.p"),
              "wb") as f:
        pickle.dump(n_pairs, f, protocol=2)
    return paths
