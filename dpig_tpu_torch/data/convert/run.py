"""Dataset converters, the port of `dpig_tpu/data/convert/run.py` — CLI:

  python -m dpig_tpu_torch.data.convert.run market <img_dir> <pose_pkl_dir> <out>
  python -m dpig_tpu_torch.data.convert.run df     <img_dir> <pose_pkl_dir> <out>
  python -m dpig_tpu_torch.data.convert.run rcv    <img_dir> <rcv_pkl> <out> --H --W

Mirrors the reference offline converters (datasets/convert_market.py /
convert_DF.py / convert_RCV.py):
  * pair mining per dataset (pairs.py)
  * OpenPose pickle peaks (all_peaks_dic / subsets_dic, py2 latin1 pickles)
  * flip augmentation for train (FLIP writes train_flip shards)
  * Market test capped at 12,800 pairs (convert_market.py:966)
  * writes pn_pairs_num_<split>.p for the readers

DF's 37-part bboxes use the WholeBody-adaptive radii
(convert_DF.py:585-595: r=10/r_single=20 when knee+ankle parts visible,
else r=20/r_single=40, with the head box raised by 10/25 px).

Host code only (numpy, PIL, scipy; no card, no protobuf): the records are
the JAX package's, feature for feature. One difference: DeepFashion's
region masks back-fill from `np.random.RandomState(seed)` (`--seed`,
default 0), one generator over the run's shards in write order, where the
JAX package draws from numpy's global generator, which it never seeds.
"""
from __future__ import annotations

import argparse
import io
import os
import pickle
from typing import Dict, Optional

import numpy as np
from PIL import Image

from .. import pose_tools as pt
from ..tfrecord import TFRecordWriter
from . import pairs as pair_mining
from .builder import build_pair_example

MARKET_TEST_CAP = 12800  # convert_market.py:966


def df_part_bbox37(peaks, img_h=256, img_w=256):
    """DF variant of the 37-part bboxes (convert_DF.py:522-656)."""
    vis = []
    for part_idx in pt.PART_IDX_LIST_37:
        vis.append(1 if any(len(peaks[i]) != 0 for i in part_idx) else 0)
    whole_body = bool(vis[13] and vis[15])
    r, r_single = (10, 20) if whole_body else (20, 40)
    bboxes = []
    for part_idx in pt.PART_IDX_LIST_37:
        xs, ys = [], []
        for part_id in part_idx:
            p = peaks[part_id]
            if len(p) != 0:
                x, y = p[0][0], p[0][1]
                if part_id == 0:  # enlarge head roi upward
                    y = max(0, y - (10 if whole_body else 25))
                xs.append(x)
                ys.append(y)
        if not xs:
            bboxes.append([0, 0, 1, 1])
            continue
        y1, x1 = int(min(ys)), int(min(xs))
        y2, x2 = int(max(ys)), int(max(xs))
        rr = r if len(xs) > 1 else r_single
        bboxes.append([max(0, y1 - rr), max(0, x1 - rr),
                       min(img_h - 1, y2 + rr), min(img_w - 1, x2 + rr)])
    return bboxes, vis


def _flip_peaks(peaks, width: int):
    out = []
    for p in peaks:
        if len(p) == 0:
            out.append([])
        else:
            x, y = p[0][0], p[0][1]
            out.append([(width - 1 - x, y) + tuple(p[0][2:])])
    return out


def _peaks_for(name: str, all_peaks: Dict, subsets: Optional[Dict]):
    if name not in all_peaks:
        return None
    if subsets is None:  # rcv input: peaks already selected
        return all_peaks[name]
    return pt.get_valid_peaks(all_peaks[name], subsets[name])


def _flipped_jpeg(raw: bytes) -> bytes:
    """The image mirrored left to right and encoded again by PIL's JPEG
    encoder at its defaults, as the JAX package does."""
    img = Image.open(io.BytesIO(raw)).transpose(Image.FLIP_LEFT_RIGHT)
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return buf.getvalue()


def convert_pairs(img_dir: str, pairs, labels, all_peaks: Dict, subsets: Dict,
                  out_path: str, height: int, width: int,
                  mask_radii=(4, 7), mask_keys=("pose_mask_r4", "pose_mask_r6"),
                  part_bbox_fn=None, flip: bool = False,
                  id_fn=None, attributes=None,
                  roi10_rng: Optional[np.random.RandomState] = None) -> int:
    """Write one tfrecord shard; returns number of examples written.
    `roi10_rng` adds DeepFashion's region masks (`builder.py`)."""
    id_fn = id_fn or (lambda nm: (pair_mining.market_id_cam(nm)[0],
                                  int(pair_mining.market_id_cam(nm)[1])))
    id_map: Dict[str, int] = {}
    count = 0
    with TFRecordWriter(out_path) as w:
        for (a, b), label in zip(pairs, labels):
            pk_a = _peaks_for(a, all_peaks, subsets)
            pk_b = _peaks_for(b, all_peaks, subsets)
            if pk_a is None or pk_b is None:
                continue
            with open(os.path.join(img_dir, a), "rb") as f:
                raw_a = f.read()
            with open(os.path.join(img_dir, b), "rb") as f:
                raw_b = f.read()
            if flip:
                raw_a, raw_b = _flipped_jpeg(raw_a), _flipped_jpeg(raw_b)
                pk_a = _flip_peaks(pk_a, width)
                pk_b = _flip_peaks(pk_b, width)
            ids = []
            cams = []
            for nm in (a, b):
                i, c = id_fn(nm)
                ids.append(id_map.setdefault(i, len(id_map)))
                cams.append(c)
            attr_kw = {}
            if attributes is not None:
                attr_kw = dict(
                    attrs_0=attributes.onehot_for(a[0:4]),
                    attrs_1=attributes.onehot_for(b[0:4]),
                    attrs_w2v_0=attributes.w2v_for(a[0:4]),
                    attrs_w2v_1=attributes.w2v_for(b[0:4]))
            rec = build_pair_example(
                name_0=a, name_1=b, image_raw_0=raw_a, image_raw_1=raw_b,
                peaks_0=pk_a, peaks_1=pk_b, height=height, width=width,
                label=label, id_0=ids[0], id_1=ids[1],
                cam_0=cams[0], cam_1=cams[1],
                mask_radii=mask_radii, mask_keys=mask_keys,
                part_bbox_fn=part_bbox_fn, roi10_rng=roi10_rng,
                **attr_kw)
            if rec is not None:
                w.write(rec)
                count += 1
    return count


def run(dataset: str, img_dir: str, pose_dir: str, out_dir: str,
        split: str = "train", height: Optional[int] = None,
        width: Optional[int] = None, flip_augment: bool = True,
        test_cap: Optional[int] = None,
        max_pairs: Optional[int] = None,
        attr_onehot_mat: Optional[str] = None,
        attr_w2v_dir: Optional[str] = None,
        roi10_masks: Optional[bool] = None, seed: int = 0) -> int:
    """dataset: 'market' | 'df' | 'rcv'.

    'rcv' is the generic converter (reference convert_RCV.py): pose_dir is
    a single pickle of {image_name: [18,3] (row,col,vis)} arrays (e.g.
    produced by pose_tools.maskrcnn_to_openpose_rcv); pair mining and the
    Market mask radii are reused; test_seq gives all-ordered-pairs
    cross-dataset generation (convert_RCV.py:1083-1100). `seed` seeds the
    region masks' back-fill (DeepFashion, or `roi10_masks=True`).
    """
    os.makedirs(out_dir, exist_ok=True)
    is_rcv = dataset == "rcv"
    is_market = dataset == "market" or is_rcv
    height = height or (128 if is_market else 256)
    width = width or (64 if is_market else 256)

    filelist = sorted(f for f in os.listdir(img_dir)
                      if f.lower().endswith((".jpg", ".png", ".jpeg")))
    if is_market:
        p_pairs, n_pairs = pair_mining.mine_pairs_market(filelist)
        mask_radii, mask_keys = (4, 7), ("pose_mask_r4", "pose_mask_r6")
        if is_rcv:
            # COCO/RCV bbox variant: WholeBody-adaptive radii + head-margin
            # logic (convert_RCV.py:326-451 _get_part_bbox_COCO) instead of
            # Market's fixed radius-6 boxes. The COCO pose-mask variant
            # (_getPoseMask_COCO, convert_RCV.py:281-324) shares Market's
            # limb table, so get_pose_mask is already exact.
            def part_fn(pk):
                return df_part_bbox37(pk, height, width)
        else:
            def part_fn(pk):
                return pt.get_part_bbox37(pk, height, width, radius=6)

        def id_fn(nm):
            return (pair_mining.market_id_cam(nm)[0],
                    int(pair_mining.market_id_cam(nm)[1]))
        name = "Market1501"
    else:
        p_pairs, n_pairs = pair_mining.mine_pairs_df(
            filelist, test_seq=(split == "test_seq"))
        mask_radii, mask_keys = (4, 8), ("pose_mask_r4", "pose_mask_r8")

        def part_fn(pk):
            return df_part_bbox37(pk, height, width)

        def id_fn(nm):
            return (pair_mining.df_id(nm), 0)
        name = "DF"

    pairs = list(p_pairs) + list(n_pairs)
    labels = [1] * len(p_pairs) + [0] * len(n_pairs)
    if max_pairs is not None and len(pairs) > max_pairs:
        # deterministic subsample (keeps pos/neg mix via stride)
        stride = max(1, len(pairs) // max_pairs)
        pairs = pairs[::stride][:max_pairs]
        labels = labels[::stride][:max_pairs]
    if split.startswith("test"):
        cap = test_cap if test_cap is not None else (
            MARKET_TEST_CAP if is_market else None)
        if cap:
            pairs, labels = pairs[:cap], labels[:cap]

    if is_rcv:
        # pose_dir is a pickle file: {name: [K,3] rcv}; adapt to peaks.
        rcv_dic = pt.load_py2_pickle(pose_dir)
        all_peaks = {n: pt.peaks_from_rcv(np.asarray(v))
                     for n, v in rcv_dic.items()}
        subsets = None
    else:
        def pickle_path(stem):
            df_name = os.path.join(pose_dir, f"{stem}_DeepFashion.p")
            if not is_market and os.path.exists(df_name):
                return df_name
            return os.path.join(pose_dir, f"{stem}.p")
        all_peaks = pt.load_py2_pickle(pickle_path("all_peaks_dic"))
        subsets = pt.load_py2_pickle(pickle_path("subsets_dic"))

    attributes = None
    if attr_onehot_mat or attr_w2v_dir:
        from .attrs import MarketAttributes
        attributes = MarketAttributes(attr_onehot_mat, attr_w2v_dir,
                                      split=split, filenames=filelist)
    if roi10_masks is None:
        roi10_masks = dataset == "df"  # convert_DF.py:416-435
    roi10_rng = np.random.RandomState(seed) if roi10_masks else None

    common = dict(mask_radii=mask_radii, mask_keys=mask_keys,
                  part_bbox_fn=part_fn, id_fn=id_fn, attributes=attributes,
                  roi10_rng=roi10_rng)
    shard = os.path.join(out_dir, f"{name}_{split}_00000-of-00001.tfrecord")
    total = convert_pairs(img_dir, pairs, labels, all_peaks, subsets, shard,
                          height, width, flip=False, **common)
    if split == "train" and flip_augment:
        shard_f = os.path.join(
            out_dir, f"{name}_train_flip_00000-of-00001.tfrecord")
        total += convert_pairs(img_dir, pairs, labels, all_peaks, subsets,
                               shard_f, height, width, flip=True, **common)
    with open(os.path.join(out_dir, f"pn_pairs_num_{split}.p"), "wb") as f:
        pickle.dump(total, f)
    print(f"wrote {total} examples -> {out_dir}")
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=["market", "df", "rcv"])
    ap.add_argument("img_dir")
    ap.add_argument("pose_dir", help="dir with all_peaks_dic.p/subsets_dic.p")
    ap.add_argument("out_dir")
    ap.add_argument("--split", default="train")
    ap.add_argument("--H", type=int, default=None)
    ap.add_argument("--W", type=int, default=None)
    ap.add_argument("--no_flip", action="store_true")
    ap.add_argument("--attr_onehot_mat", default=None,
                    help="market_attribute.mat path (convert_market.py:774)")
    ap.add_argument("--attr_w2v_dir", default=None,
                    help="dir with *_att_wordvec_dim{25,50,100,150}.mat")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of DeepFashion's region-mask back-fill")
    a = ap.parse_args(argv)
    run(a.dataset, a.img_dir, a.pose_dir, a.out_dir, split=a.split,
        height=a.H, width=a.W, flip_augment=not a.no_flip,
        attr_onehot_mat=a.attr_onehot_mat, attr_w2v_dir=a.attr_w2v_dir,
        seed=a.seed)


if __name__ == "__main__":
    main()
