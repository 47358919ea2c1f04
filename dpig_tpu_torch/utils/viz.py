"""Pose preview helper: the port's own copy of
`dpig_tpu/utils/viz.py:40-44`."""
from __future__ import annotations

import numpy as np


def pose_to_gray(pose_maps: np.ndarray) -> np.ndarray:
    """[N,H,W,K] in [-1,1] -> displayable [N,H,W,1] in [0,255]
    (reference trainer.py:331 preview convention)."""
    m = np.amax(pose_maps, axis=-1, keepdims=True)
    return (m + 1.0) * 127.5
