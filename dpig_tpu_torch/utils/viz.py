"""Preview helpers: the port's own copy of `dpig_tpu/utils/viz.py`
(reference utils.py:157-182 make_grid/save_image, trainer.py:331)."""
from __future__ import annotations

import math
import os

import numpy as np
from PIL import Image


def make_grid(tensor: np.ndarray, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """[N,H,W,3] uint8-range -> one grid image (torchvision-style)."""
    t = np.asarray(tensor)
    if t.ndim == 4 and t.shape[-1] == 1:
        t = np.tile(t, (1, 1, 1, 3))
    nmaps = t.shape[0]
    xmaps = min(nrow, nmaps)
    ymaps = int(math.ceil(nmaps / xmaps))
    h, w = int(t.shape[1] + padding), int(t.shape[2] + padding)
    grid = np.zeros([h * ymaps + 1 + padding // 2,
                     w * xmaps + 1 + padding // 2, 3], dtype=np.uint8)
    k = 0
    for y in range(ymaps):
        for x in range(xmaps):
            if k >= nmaps:
                break
            hs = y * h + 1 + padding // 2
            ws = x * w + 1 + padding // 2
            grid[hs:hs + h - padding, ws:ws + w - padding] = \
                np.clip(t[k], 0, 255).astype(np.uint8)
            k += 1
    return grid


def save_image(tensor: np.ndarray, filename: str, nrow: int = 8,
               padding: int = 2) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    Image.fromarray(make_grid(tensor, nrow, padding)).save(filename)


def pose_to_gray(pose_maps: np.ndarray) -> np.ndarray:
    """[N,H,W,K] in [-1,1] -> displayable [N,H,W,1] in [0,255]
    (reference trainer.py:331 preview convention)."""
    m = np.amax(pose_maps, axis=-1, keepdims=True)
    return (m + 1.0) * 127.5
