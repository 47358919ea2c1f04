"""Synthetic batch fixtures: the port's own copy of
`dpig_tpu/data/synthetic.py:14-68`.

Shape/dtype-faithful to the tfrecord schema (datasets/market1501.py:79-113).
The same seed gives the same numpy batches as the JAX package's loader;
batches stay numpy so callers pick the device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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
