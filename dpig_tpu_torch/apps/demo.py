"""One-off demo inference from raw images + OpenPose pickles (port of
`dpig_tpu/apps/demo.py:24-108`; reference trainer.py:429-512
`test_one_by_one`).

Computes pose discs, pose masks and part bboxes on the fly with the
port's copy of the converter toolbox (`data/pose_tools.py`) and runs the
model-12 pose transfer (`ConditionalTransferTester.transfer_step`) on one
pair at a time, in the tester's compute dtype (no int8 calibration, as in
JAX). As in the JAX package, the bboxes come from the demo image's own
OpenPose peaks (the reference took them from the training queue).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image

from ..config import Config
from ..data import pose_tools as pt
from ..ops.pose import render_pose_maps
from .common import batch_to_device
from .testers import ConditionalTransferTester, _save_dir_tree

DIRS = ("x", "x_target", "G", "pose", "pose_target", "mask", "mask_target")


def _rcv_from_peaks(peaks, keypoint_num=18) -> np.ndarray:
    rcv = np.zeros((keypoint_num, 3), np.float32)
    for k, p in enumerate(peaks):
        if len(p) != 0:
            rcv[k] = [p[0][1], p[0][0], 1.0]
    return rcv


def pair_batch(img_a: np.ndarray, peaks_a, peaks_b, h: int, w: int
               ) -> Dict[str, np.ndarray]:
    """One demo pair as a batch of 1 (numpy): the source image [0,255]
    float32 -> x in [-1,1], both poses' rcv, the source's radius-7 pose
    mask and its radius-6 part bboxes (demo.py:72-86), and the target's
    mask (`mask_target`, written as a PNG only)."""
    rcv_a = _rcv_from_peaks(peaks_a)
    rcv_b = _rcv_from_peaks(peaks_b)
    mask_a = pt.get_pose_mask(peaks_a, h, w, radius=7)[..., None]
    mask_b = pt.get_pose_mask(peaks_b, h, w, radius=7)[..., None]
    bbox_a, vis_a = pt.get_part_bbox37(peaks_a, h, w, radius=6)
    return {"x": img_a[None] / 127.5 - 1.0,
            "pose_rcv": rcv_a[None],
            "pose_rcv_target": rcv_b[None],
            "mask_r6": mask_a[None].astype(np.float32),
            "mask_target": mask_b[None].astype(np.float32),
            "part_bbox": np.asarray(bbox_a, np.int32)[None],
            "part_vis": np.asarray(vis_a, np.int32)[None]}


def run_one_by_one(cfg: Config, img_dir: str, pair_path: str,
                   all_peaks_path: str, subsets_path: str,
                   pair_num: int = 500, shuffle: bool = True,
                   result_dir_name: str = "test_demo",
                   tester: Optional[ConditionalTransferTester] = None
                   ) -> str:
    """Write the seven PNG trees of `pair_num` pairs (names
    `pair{cnt:05d}-{a}[-{b}].png`) under `<model_dir>/<result_dir_name>`
    and return that directory. Pairs whose names have no peaks are
    passed over; a pair whose peaks have no valid subset still uses up
    its number (demo.py:57-64). `tester` (default: a
    ConditionalTransferTester built from `cfg`) gives the weights and the
    device. The pickles come from the user and are trusted, as in JAX."""
    pairs = pt.load_py2_pickle(pair_path)
    all_peaks_dic = pt.load_py2_pickle(all_peaks_path)
    subsets_dic = pt.load_py2_pickle(subsets_path)
    if shuffle:
        idx_all = np.random.RandomState(0).permutation(len(pairs))
    else:
        idx_all = np.arange(len(pairs))

    tester = tester or ConditionalTransferTester(cfg)
    out_root = os.path.join(cfg.model_dir, result_dir_name)
    dirs = _save_dir_tree(out_root, DIRS)
    h, w = cfg.img_H, cfg.img_W
    cnt = -1
    for i in idx_all:
        if cnt >= pair_num - 1:
            break
        a, b = pairs[i][0], pairs[i][1]
        if a not in all_peaks_dic or b not in all_peaks_dic:
            continue
        cnt += 1
        peaks_a = pt.get_valid_peaks(all_peaks_dic[a], subsets_dic[a])
        peaks_b = pt.get_valid_peaks(all_peaks_dic[b], subsets_dic[b])
        if peaks_a is None or peaks_b is None:
            continue
        img_a, img_b = (np.asarray(Image.open(os.path.join(img_dir, n))
                                   .convert("RGB"), np.float32)
                        for n in (a, b))
        batch = pair_batch(img_a, peaks_a, peaks_b, h, w)
        jb = batch_to_device(batch, tester.device)
        g, pose_t, _score = tester.transfer_step(jb)
        with torch.inference_mode():
            pose_a = render_pose_maps(jb["pose_rcv"], h, w, cfg.keypoint_num)
        pngs = (
            ("x", a, img_a),
            ("x_target", b, img_b),
            ("G", f"{a}-{b}", np.clip(g[0].cpu().numpy(), 0, 255)),
            ("pose", a, (pose_a[0].cpu().numpy().max(-1) + 1) * 127.5),
            ("pose_target", b, (pose_t[0].cpu().numpy().max(-1) + 1) * 127.5),
            ("mask", a, batch["mask_r6"][0, ..., 0] * 255),
            ("mask_target", b, batch["mask_target"][0, ..., 0] * 255))
        for d, name, arr in pngs:
            Image.fromarray(arr.astype(np.uint8)).save(
                os.path.join(dirs[d], f"pair{cnt:05d}-{name}.png"))
    return out_root
