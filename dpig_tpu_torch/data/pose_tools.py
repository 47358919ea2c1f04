"""OpenPose peaks -> pose masks and part bboxes (numpy and scipy): the
port's own copy of the parts of `dpig_tpu/data/pose_tools.py` that the
one-by-one demo (`apps/demo.py`) runs, unchanged:

  * get_valid_peaks — best-scored OpenPose subset selection
    (reference utils.py:459-490);
  * get_pose_mask — limb-segment interpolated discs over the 23-limb
    LIMB_SEQ + dilation(square(5)) + erosion(square(5))
    (datasets/convert_market.py:229-281);
  * get_part_bbox37 — 37 body-part region proposals
    (datasets/convert_market.py:640-728);
  * get_sparse_keypoint / sparse2dense, which get_pose_mask calls
    (utils.py:406-457).

Morphology uses scipy.ndimage grey_dilation/erosion (mode='reflect',
matching skimage.morphology's defaults).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
from scipy.ndimage import grey_dilation, grey_erosion
from scipy.stats import norm as _norm

# MSCOCO part order: [nose, neck, Rsho, Relb, Rwri, Lsho, Lelb, Lwri, Rhip,
#   Rkne, Rank, Lhip, Lkne, Lank, Leye, Reye, Lear, Rear]
LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
            [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
            [1, 16], [16, 18], [2, 17], [2, 18], [9, 12], [12, 6], [9, 3],
            [17, 18]]  # 1-based (convert_market.py:233-235)

_RATIO_0_4 = 1.0 / _norm(0, 4).pdf(0)
_GAUSS_0_4 = _norm(0, 4)

# 37 part definitions (convert_market.py:665-682)
PART_IDX_LIST_37: List[List[int]] = (
    [[0, 1, 2, 5, 14, 15, 16, 17],
     [2, 3, 4, 5, 6, 7, 8, 11],
     [8, 9, 10, 11, 12, 13],
     [5, 6, 7],
     [2, 3, 4],
     [11, 12, 13],
     [8, 9, 10],
     [2, 5, 8, 11],
     [5, 6], [6, 7], [2, 3], [3, 4], [11, 12], [12, 13], [8, 9], [9, 10],
     list(range(0, 18))]
    + [[i] for i in range(0, 18)]
    + [[2, 3, 4, 8, 9, 10], [5, 6, 7, 11, 12, 13]])


def get_sparse_keypoint(r, c, k, height, width, radius=4, var=4,
                        mode="Solid"):
    """Disc indices/values around one keypoint (utils.py:406-425)."""
    r, c, k = int(r), int(c), int(k)
    indices, values = [], []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            distance = math.sqrt(float(i ** 2 + j ** 2))
            if 0 <= r + i < height and 0 <= c + j < width \
                    and distance <= radius:
                indices.append([r + i, c + j, k])
                if mode == "Solid":
                    values.append(1)
                else:  # Gaussian, var==4 only (utils.py:419-424)
                    values.append(_GAUSS_0_4.pdf(distance) * _RATIO_0_4)
    return indices, values


def sparse2dense(indices, values, shape) -> np.ndarray:
    dense = np.zeros(shape)
    for ind, v in zip(indices, values):
        dense[ind[0], ind[1], ind[2]] = v
    return dense


def get_pose_mask(peaks, height, width, radius=4, var=4,
                  mode="Solid") -> np.ndarray:
    """Limb-rasterized body mask + 5x5 closing (convert_market.py:229-281)."""
    indices, values = [], []
    for limb in LIMB_SEQ:
        p0 = peaks[limb[0] - 1]
        p1 = peaks[limb[1] - 1]
        if len(p0) != 0 and len(p1) != 0:
            r0, c0 = p0[0][1], p0[0][0]
            r1, c1 = p1[0][1], p1[0][0]
            for (rr, cc) in ((r0, c0), (r1, c1)):
                ind, val = get_sparse_keypoint(rr, cc, 0, height, width,
                                               radius, var, mode)
                indices.extend(ind)
                values.extend(val)
            distance = np.sqrt((r0 - r1) ** 2 + (c0 - c1) ** 2)
            sample_n = int(distance / radius)
            if sample_n > 1:
                for i in range(1, sample_n):
                    rr = r0 + (r1 - r0) * i / sample_n
                    cc = c0 + (c1 - c0) * i / sample_n
                    ind, val = get_sparse_keypoint(rr, cc, 0, height, width,
                                                   radius, var, mode)
                    indices.extend(ind)
                    values.extend(val)
    dense = np.squeeze(sparse2dense(indices, values, [height, width, 1]))
    dense = grey_dilation(dense, size=(5, 5))
    dense = grey_erosion(dense, size=(5, 5))
    return dense


def get_part_bbox37(peaks, height=128, width=64, radius=6
                    ) -> Tuple[List[List[int]], List[int]]:
    """37 body-part bboxes [y1,x1,y2,x2] + visibility
    (convert_market.py:640-728; r=6 at the call site :490,:509,
    r_single=10 for single-keypoint parts)."""
    part_bbox_list, visibility_list = [], []
    r, r_single = radius, 10
    for part_idx in PART_IDX_LIST_37:
        xs, ys = [], []
        for i in part_idx:
            p = peaks[i]
            if len(p) != 0:
                xs.append(p[0][0])
                ys.append(p[0][1])
        if not xs:
            visibility_list.append(0)
            part_bbox_list.append([0, 0, 1, 1])
            continue
        visibility_list.append(1)
        y1, x1 = int(np.min(ys)), int(np.min(xs))
        y2, x2 = int(np.max(ys)), int(np.max(xs))
        rr = r if len(xs) > 1 else r_single
        part_bbox_list.append([max(0, y1 - rr), max(0, x1 - rr),
                               min(height - 1, y2 + rr),
                               min(width - 1, x2 + rr)])
    return part_bbox_list, visibility_list


def get_valid_peaks(all_peaks, subsets) -> Optional[list]:
    """Select the best-scored OpenPose subset (utils.py:459-490); None when
    there is none. Any error reading a malformed record also gives None,
    so the demo skips that image as the reference does."""
    try:
        subsets = subsets.tolist() if hasattr(subsets, "tolist") else subsets
        valid_idx, valid_score = -1, -1
        for i, subset in enumerate(subsets):
            score = subset[-2]
            if score > valid_score:
                valid_idx, valid_score = i, score
        if valid_idx < 0:
            return None
        peaks = []
        cand_id_list = subsets[valid_idx][:18]
        for ap in all_peaks:
            valid_p = []
            for p in ap:
                if p[-1] in cand_id_list:
                    valid_p = p
            peaks.append([valid_p] if len(valid_p) > 0 else [])
        return peaks
    except Exception:  # noqa: BLE001  (the reference's contract: skip it)
        return None
