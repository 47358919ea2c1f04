"""OpenPose peaks -> sparse poses, pose masks, part bboxes and region
masks (numpy and scipy): the port's own copy of
`dpig_tpu/data/pose_tools.py`, which the tfrecord converters
(`data/convert/`), the record builder (`data/example.py`) and the
one-by-one demo (`apps/demo.py`) run:

  * get_sparse_keypoint / get_sparse_pose / one_dim_sparse / sparse2dense
    (reference utils.py:406-457);
  * get_pose_mask — limb-segment interpolated discs over the 23-limb
    LIMB_SEQ + dilation(square(5)) + erosion(square(5))
    (datasets/convert_market.py:229-281);
  * get_part_bbox37 — 37 body-part region proposals
    (datasets/convert_market.py:640-728);
  * get_valid_peaks — best-scored OpenPose subset selection
    (utils.py:459-490);
  * peaks_from_rcv / maskrcnn_to_openpose_rcv — [18, 3] rcv arrays and
    MaskRCNN's 17 COCO joints as OpenPose peaks (mat2dic_maskrcnn.py);
  * get_roi_mask10 — DeepFashion's 10 body-region masks
    (convert_DF.py:658-764), its back-fill drawn from a caller's
    `np.random.RandomState` (the JAX package draws it from numpy's global
    generator);
  * load_py2_pickle — the reference's py2 pickles (OpenPose peaks and
    subsets, pair lists), read as latin1.

Morphology uses scipy.ndimage grey_dilation/erosion (mode='reflect',
matching skimage.morphology's defaults).
"""
from __future__ import annotations

import functools
import math
import pickle
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


@functools.lru_cache(maxsize=None)
def _disc_offsets(radius: int) -> np.ndarray:
    """[n, 2] (i, j) offsets of `get_sparse_keypoint`'s disc, in its loop
    order (i, then j)."""
    return np.array([(i, j) for i in range(-radius, radius + 1)
                     for j in range(-radius, radius + 1)
                     if math.sqrt(float(i ** 2 + j ** 2)) <= radius],
                    np.int64).reshape(-1, 2)


def _solid_discs(centers, height, width, radius
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """[m, 2] (row, col) of the 'Solid' discs around each (r, c) center,
    in `get_sparse_keypoint`'s order center by center, and the index of
    each one's center: its indices without the per-pixel Python loop (the
    converters make ~50 discs a mask)."""
    offsets = _disc_offsets(radius)
    rc = (np.array([(int(r), int(c)) for r, c in centers],
                   np.int64).reshape(-1, 1, 2) + offsets).reshape(-1, 2)
    center = np.repeat(np.arange(len(centers)), len(offsets))
    keep = ((rc[:, 0] >= 0) & (rc[:, 0] < height) & (rc[:, 1] >= 0)
            & (rc[:, 1] < width))
    return rc[keep], center[keep]


def get_sparse_pose(peaks, height, width, channel, radius=4, var=4,
                    mode="Solid"):
    """All-keypoint sparse pose (utils.py:427-439)."""
    indices, values = [], []
    if mode == "Solid":
        ks = [k for k, p in enumerate(peaks) if len(p) != 0]
        rc, center = _solid_discs([(peaks[k][0][1], peaks[k][0][0])
                                   for k in ks], height, width, radius)
        rck = np.concatenate([rc, np.asarray(ks, np.int64).reshape(-1)[
            center][:, None]], 1)
        return rck.tolist(), [1] * len(rck), [height, width, channel]
    for k in range(len(peaks)):
        p = peaks[k]
        if len(p) != 0:
            ind, val = get_sparse_keypoint(p[0][1], p[0][0], k, height,
                                           width, radius, var, mode)
            indices.extend(ind)
            values.extend(val)
    return indices, values, [height, width, channel]


def one_dim_sparse(indices, shape):
    """Row-major flattening of sparse indices (utils.py:441-448)."""
    out = [ind[0] * shape[2] * shape[1] + ind[1] * shape[2] + ind[2]
           for ind in indices]
    return out, int(np.prod(shape))


def sparse2dense(indices, values, shape) -> np.ndarray:
    dense = np.zeros(shape)
    for ind, v in zip(indices, values):
        dense[ind[0], ind[1], ind[2]] = v
    return dense


def _limb_centers(peaks, radius) -> list:
    """The disc centers of `get_pose_mask`, in its order: per limb with
    both ends, the two ends, then the points between them."""
    centers = []
    for limb in LIMB_SEQ:
        p0 = peaks[limb[0] - 1]
        p1 = peaks[limb[1] - 1]
        if len(p0) != 0 and len(p1) != 0:
            r0, c0 = p0[0][1], p0[0][0]
            r1, c1 = p1[0][1], p1[0][0]
            centers += [(r0, c0), (r1, c1)]
            distance = np.sqrt((r0 - r1) ** 2 + (c0 - c1) ** 2)
            sample_n = int(distance / radius)
            if sample_n > 1:
                centers += [(r0 + (r1 - r0) * i / sample_n,
                             c0 + (c1 - c0) * i / sample_n)
                            for i in range(1, sample_n)]
    return centers


def get_pose_mask(peaks, height, width, radius=4, var=4,
                  mode="Solid") -> np.ndarray:
    """Limb-rasterized body mask + 5x5 closing (convert_market.py:229-281).
    The 'Solid' discs are set in one numpy assignment (every value is 1,
    so the order of the writes does not matter)."""
    if mode == "Solid":
        dense = np.zeros([height, width])
        rc, _ = _solid_discs(_limb_centers(peaks, radius), height, width,
                             radius)
        dense[rc[:, 0], rc[:, 1]] = 1
        dense = grey_dilation(dense, size=(5, 5))
        return grey_erosion(dense, size=(5, 5))
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
        y1, x1 = int(min(ys)), int(min(xs))
        y2, x2 = int(max(ys)), int(max(xs))
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


def peaks_from_rcv(rcv: np.ndarray) -> list:
    """[K,3] (row,col,vis) -> the peaks structure ([(x, y, score, id)] per
    keypoint) that the mask and bbox tools take."""
    peaks = []
    for k in range(rcv.shape[0]):
        r, c, v = rcv[k]
        peaks.append([(float(c), float(r), 1.0, k)] if v > 0 else [])
    return peaks


# MaskRCNN(COCO-17) -> OpenPose(18) keypoint index map
# (datasets/mat2dic_maskrcnn.py:28). OpenPose's neck (idx 1) is synthesized
# as the shoulder midpoint.
OPENPOSE_FROM_MASKRCNN = {0: 0, 1: None, 2: 6, 3: 8, 4: 10, 5: 5, 6: 7,
                          7: 9, 8: 12, 9: 14, 10: 16, 11: 11, 12: 13,
                          13: 15, 14: 1, 15: 2, 16: 3, 17: 4}


def maskrcnn_to_openpose_rcv(crs: np.ndarray, keypoint_num: int = 18
                             ) -> np.ndarray:
    """[2, 17] MaskRCNN (col,row) joints -> [18, 3] OpenPose-order rcv,
    with the neck made up from the shoulder midpoint
    (datasets/mat2dic_maskrcnn.py:29-53)."""
    rcv = np.zeros([keypoint_num, 3], np.float32)
    for k in range(keypoint_num):
        k_idx = OPENPOSE_FROM_MASKRCNN[k]
        if k_idx is not None:
            c, r = crs[:, k_idx]
            if not (c == 0 and r == 0):
                rcv[k] = [r, c, 1]
    r0, c0, v0 = rcv[2]
    r1, c1, v1 = rcv[5]
    if v0 and v1:
        rcv[1] = [(r0 + r1) / 2, (c0 + c1) / 2, 1]
    return rcv


# DF 10-ROI body-region proposal masks (convert_DF.py:658-764). The five
# small + five big region index sets select entries of the 37-part bbox
# list; WholeBody (knee+ankle visible) switches the sets and the head/limb
# margins. Missing regions are back-filled by the reference's
# `np.random.choice(len)-1` index quirk (kept for bit parity).
ROI10_SMALL_WHOLE = [[0], [3], [4], [5], [6]]
ROI10_BIG_WHOLE = [[1], [2], [35], [36], [0, 1]]
ROI10_SMALL_PART = [[0], [3], [4], [3], [4]]
ROI10_BIG_PART = [[1], [35], [36], [35], [36]]


def get_roi_mask10(part_bbox_list, visibility_list, img_h: int,
                   img_w: int, rng: np.random.RandomState) -> np.ndarray:
    """[H, W, 10] 0/1 masks (1 = outside the region), convert_DF.py:658-764;
    stacked in small+big order like roi10_mask_* (convert_DF.py:417).
    A set of five with fewer visible regions is back-filled with copies
    drawn by `rng` (the JAX package's `np.random` when it is not given).
    Raises ValueError when a set has no visible region at all (the JAX
    package fails there inside `choice(0)`)."""
    whole = bool(visibility_list[13] and visibility_list[15])
    sets = ((ROI10_SMALL_WHOLE, ROI10_BIG_WHOLE) if whole else
            (ROI10_SMALL_PART, ROI10_BIG_PART))

    def region_masks(idx_sets):
        masks = []
        for bbox_idxs in idx_sets:
            y1, x1, y2, x2 = img_h - 1, img_w - 1, 0, 0
            valid = False
            for part_idx in bbox_idxs:
                if not visibility_list[part_idx]:
                    continue
                valid = True
                y1_t, x1_t, y2_t, x2_t = part_bbox_list[part_idx]
                if part_idx == 0:  # enlarge the head roi
                    y1_t = max(0, y1_t - (10 if whole else 20))
                elif part_idx in (3, 4, 5, 6, 2, 35, 36):  # wrist/ankle
                    y2_t = min(img_h - 1, y2_t + 20)
                if not whole:
                    y1_t = max(0, y1_t - 5)
                    x1_t = max(0, x1_t - 5)
                    y2_t = min(img_h - 1, y2_t + 5)
                    x2_t = min(img_w - 1, x2_t + 5)
                y1, x1 = min(y1, y1_t), min(x1, x1_t)
                y2, x2 = max(y2, y2_t), max(x2, x2_t)
            if valid:
                m = np.ones([img_h, img_w], np.float32)
                m[int(y1):int(y2), int(x1):int(x2)] = 0
                masks.append(m)
        if not masks:
            raise ValueError(f"get_roi_mask10: none of the regions "
                             f"{idx_sets} has a visible part, so there is "
                             f"nothing to back-fill the five masks from")
        while len(masks) < 5:
            masks.append(masks[int((rng.choice(len(masks), 1) - 1)[0])])
        return masks

    small, big = (region_masks(s) for s in sets)
    return np.stack(small + big, axis=-1)


def load_py2_pickle(path: str):
    """A pickle of the reference's py2 tools (OpenPose all_peaks / subsets
    dicts, pair lists, rcv dicts), its str bytes read as latin1. The
    pickles come from the user and are trusted, as in the JAX package."""
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")
