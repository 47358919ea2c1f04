"""Synthetic person-image pairs in the form the program's loaders yield them
(numpy dicts of the pair-record schema: `x`, `x_target` in [-1, 1],
`pose_rcv` / `pose_rcv_target` pixel (row, col, visibility), the torso
masks `mask_r4` / `mask_r6` and their targets, 37 part boxes and their
visibility), drawn from a seed. A copy of the program's
`data/synthetic.py:synthetic_batch`, kept here so that the yardstick does
not change with the program; the traffic files name its sizes."""
from __future__ import annotations

from typing import Dict, List

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


def ring(seed: int, n: int, batch_size: int, img_h: int, img_w: int,
         keypoint_num: int, part_num: int) -> List[Dict[str, np.ndarray]]:
    """`n` distinct batches from one generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    return [synthetic_batch(rng, batch_size, img_h, img_w, keypoint_num,
                            part_num) for _ in range(n)]
