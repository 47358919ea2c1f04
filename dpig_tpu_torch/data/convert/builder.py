"""The converter's pair record builder (port of
`dpig_tpu/data/convert/builder.py`; reference
datasets/convert_market.py:394-576 `_format_data`, convert_DF.py:356-520):
the peaks-to-masks half. From each side's OpenPose peaks it computes the
pose masks, the part bboxes and, for DeepFashion, the 10 region masks;
`data/example.py:build_pair_example`, the one assembly of the schema,
adds the rcv coordinates, the 16x8 grid and the sparse r4 pose and
encodes the record without protobuf.

Schema notes preserved from the reference:
  * 'pose_mask_r6_*' for Market actually stores the RADIUS-7 mask
    (convert_market.py:479-480 writes pose_mask_r7 into the r6 key).
  * sparse keypoints are stored row-major one-dim (utils.py:441-448).
  * attrs are zero-filled when no attribute .mat is supplied.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import example
from .. import pose_tools as pt


def build_pair_example(
    *,
    name_0: str, name_1: str,
    image_raw_0: bytes, image_raw_1: bytes,
    peaks_0: list, peaks_1: list,
    height: int, width: int,
    label: int, id_0: int, id_1: int, cam_0: int = 0, cam_1: int = 0,
    attrs_0: Optional[Sequence[int]] = None,
    attrs_1: Optional[Sequence[int]] = None,
    attrs_w2v_0: Optional[dict] = None,    # dim -> floats (attrs.py)
    attrs_w2v_1: Optional[dict] = None,
    mask_radii: Sequence[int] = (4, 7),    # Market: r4 + r7-as-'r6'
    mask_keys: Sequence[str] = ("pose_mask_r4", "pose_mask_r6"),
    part_bbox_fn=None,
    roi10_rng: Optional[np.random.RandomState] = None,
    keypoint_num: int = 18,
    image_format: str = "jpg",
) -> Optional[bytes]:
    """A serialized Example, or None if a pose is missing. `roi10_rng`
    (DeepFashion, convert_DF.py:416-435) adds the `roi10_mask_*` features,
    their back-fill drawn from it; where the JAX package takes
    `roi10_masks=True` and numpy's global generator."""
    if peaks_0 is None or peaks_1 is None:
        return None
    part_bbox_fn = part_bbox_fn or (
        lambda peaks: pt.get_part_bbox37(peaks, height, width, radius=6))
    sides = {}
    for suffix, peaks in (("_0", peaks_0), ("_1", peaks_1)):
        masks = {key: pt.get_pose_mask(peaks, height, width, radius=radius,
                                       mode="Solid")
                 for radius, key in zip(mask_radii, mask_keys)}
        bboxes, vis = part_bbox_fn(peaks)
        roi10 = None
        if roi10_rng is not None:
            roi10 = pt.get_roi_mask10(bboxes, vis, height, width, roi10_rng)
        sides.update({f"masks{suffix}": masks, f"part_bbox{suffix}": bboxes,
                      f"part_vis{suffix}": vis, f"roi10{suffix}": roi10})
    return example.build_pair_example(
        name_0=name_0, name_1=name_1, image_raw_0=image_raw_0,
        image_raw_1=image_raw_1, peaks_0=peaks_0, peaks_1=peaks_1,
        height=height, width=width, label=label, id_0=id_0, id_1=id_1,
        cam_0=cam_0, cam_1=cam_1, attrs_0=attrs_0, attrs_1=attrs_1,
        attrs_w2v_0=attrs_w2v_0, attrs_w2v_1=attrs_w2v_1,
        keypoint_num=keypoint_num, image_format=image_format, **sides)
