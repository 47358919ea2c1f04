"""The dataset converters of the port (`dpig_tpu_torch.data.convert`,
the new `data/pose_tools.py` functions) against the JAX package's
(`dpig_tpu.data.convert`, `dpig_tpu/data/pose_tools.py`), on the CPU at
small sizes: the pose tools bit-equal on seeded peaks with missing
keypoints (DeepFashion's region masks with back-fill, JAX's global numpy
generator seeded as the port's RandomState is), pair mining in every mode,
the attribute .mats, and `run()` for market (train with the flip shard,
test under its cap), df and rcv on seeded images and OpenPose pickles:
the shards' records, parsed by protobuf here, equal to JAX's record by
record in order, the pair counts equal, and the port's loader on the
port's shards giving JAX's loader's batches on JAX's shards. The CLI too.
"""
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from dpig_tpu.data import pose_tools as jpt
from dpig_tpu.data.convert import attrs as jattrs
from dpig_tpu.data.convert import pairs as jpairs
from dpig_tpu.data.convert import run as jrun
from dpig_tpu.data.loader import TFRecordPairLoader as JaxLoader
from dpig_tpu.data.proto import example_pb2 as pb
from dpig_tpu.data.tfrecord import read_records as jax_read_records
from dpig_tpu_torch.data import pose_tools as pt
from dpig_tpu_torch.data.convert import attrs, pairs, run as prun
from dpig_tpu_torch.data.loader import TFRecordPairLoader

torch.set_num_threads(1)


def _peaks(rng, h, w, missing=(), n_cand=1):
    """OpenPose all_peaks: per keypoint `n_cand` (x, y, score, id)
    candidates with ids unique over the image; keypoints in `missing`
    empty."""
    out, nid = [], 0
    for k in range(18):
        cands = []
        if k not in missing:
            for _ in range(n_cand):
                cands.append((float(rng.integers(2, w - 2)),
                              float(rng.integers(2, h - 2)), 0.9, nid))
                nid += 1
        out.append(cands)
    return out


def _selected(peaks):
    """The peaks structure get_valid_peaks returns (one candidate each)."""
    return [[p[0]] if p else [] for p in peaks]


# ------------------------------------------------------------ pose tools
MISSING = [(), (9, 10), (13, 15), (5, 6, 7, 11, 12), (0, 14, 15, 16, 17),
           (2, 3, 4, 5, 6, 7, 8, 9, 10)]


@pytest.mark.parametrize("missing", MISSING)
def test_new_pose_tools_bit_equal_to_jax(missing):
    rng = np.random.default_rng(len(missing))
    for h, w in ((32, 16), (128, 64), (64, 64)):
        peaks = _selected(_peaks(rng, h, w, missing))
        for radius in (4, 7):
            got = pt.get_sparse_pose(peaks, h, w, 18, radius=radius)
            assert got == jpt.get_sparse_pose(peaks, h, w, 18, radius=radius)
            assert pt.one_dim_sparse(got[0], got[2]) == \
                jpt.one_dim_sparse(got[0], got[2])
        rcv = np.zeros((18, 3), np.float32)
        for k, p in enumerate(peaks):
            if p:
                rcv[k] = [p[0][1], p[0][0], 1]
        assert pt.peaks_from_rcv(rcv) == jpt.peaks_from_rcv(rcv)
        crs = rng.integers(0, 40, (2, 17)).astype(np.float64)
        crs[:, [m % 17 for m in missing]] = 0  # absent MaskRCNN joints
        np.testing.assert_array_equal(pt.maskrcnn_to_openpose_rcv(crs),
                                      jpt.maskrcnn_to_openpose_rcv(crs))
        for bbox_fn in (lambda pk: jpt.get_part_bbox37(pk, h, w, radius=6),
                        lambda pk: jrun.df_part_bbox37(pk, h, w)):
            bboxes, vis = bbox_fn(peaks)
            for seed in (0, 3):
                np.random.seed(seed)  # JAX draws from the global generator
                want = jpt.get_roi_mask10(bboxes, vis, h, w)
                got = pt.get_roi_mask10(bboxes, vis, h, w,
                                        np.random.RandomState(seed))
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype


def test_roi_mask10_back_fills_and_raises_where_jax_does():
    """A set of five with missing regions is back-filled (the draw
    matters: two seeds give two fills); with no visible part at all JAX
    fails inside `choice(0)` and the port raises a ValueError that says
    why."""
    rng = np.random.default_rng(5)
    peaks = _selected(_peaks(rng, 64, 64, (5, 6, 7, 13, 15)))
    bboxes, vis = jrun.df_part_bbox37(peaks, 64, 64)
    fills = {pt.get_roi_mask10(bboxes, vis, 64, 64,
                               np.random.RandomState(s)).tobytes()
             for s in range(6)}
    assert len(fills) > 1
    empty = [[]] * 18
    bboxes, vis = jrun.df_part_bbox37(empty, 64, 64)
    with pytest.raises(ValueError):
        jpt.get_roi_mask10(bboxes, vis, 64, 64)
    with pytest.raises(ValueError, match="no|none of the regions"):
        pt.get_roi_mask10(bboxes, vis, 64, 64, np.random.RandomState(0))


def test_load_py2_pickle_reads_latin1_bytes(tmp_path):
    """A py2 str pickle (protocol 2 STRING opcodes) loads as latin1 text,
    the helper the converter and the one-by-one demo share."""
    path = tmp_path / "p.p"
    path.write_bytes(b"\x80\x02]q\x00U\x03a\xe9bq\x01a.")
    assert pt.load_py2_pickle(str(path)) == ["a\xe9b"]
    from dpig_tpu_torch.apps import demo
    assert demo.pt.load_py2_pickle is pt.load_py2_pickle


# ----------------------------------------------------------- pair mining
def _market_names(n_ids, n_cams, per_cam):
    names, i = [], 0
    for pid in range(1, n_ids + 1):
        for cam in range(1, n_cams + 1):
            for _ in range(per_cam):
                i += 1
                names.append(f"{pid:04d}_c{cam}s1_{i:06d}_00.jpg")
    return names


@pytest.mark.parametrize("mode,kw", [
    ("diff_cam", {}), ("same_cam", {}), ("same_diff_cam", {}),
    ("same_diff_cam", dict(add_switch_pair=False, augment_ratio=2)),
    ("same_diff_cam", dict(seed=7)), ("diff_cam", dict(augment_ratio=3))])
def test_mine_pairs_market_matches_jax(mode, kw):
    """The same lists in the same order; for same_diff_cam 2010 names, so
    its negatives (every 2000th j) exist."""
    names = _market_names(67, 5, 6) if mode == "same_diff_cam" else \
        _market_names(7, 3, 5)
    want = jpairs.mine_pairs_market(names, mode, **kw)
    assert pairs.mine_pairs_market(names, mode, **kw) == want
    assert want[0] and want[1]


def test_mine_pairs_df_and_ids_match_jax():
    names = [f"id{i % 97:05d}_{i:05d}_1front.jpg" for i in range(2005)]
    for test_seq in (False, True):
        got = pairs.mine_pairs_df(names[:60] if test_seq else names,
                                  test_seq=test_seq, seed=3)
        assert got == jpairs.mine_pairs_df(names[:60] if test_seq else names,
                                           test_seq=test_seq, seed=3)
    assert pairs.df_id(names[5]) == jpairs.df_id(names[5])
    assert pairs.market_id_cam("0012_c3s1_000001_00.jpg") == \
        jpairs.market_id_cam("0012_c3s1_000001_00.jpg")
    with pytest.raises(ValueError):
        jpairs.mine_pairs_market(names[:3], "bogus")
    with pytest.raises(ValueError):
        pairs.mine_pairs_market(names[:3], "bogus")


# ------------------------------------------------------------ attributes
def test_market_attributes_match_jax(tmp_path):
    import scipy.io
    files = ["0002_c1s1_000001_00.jpg", "0001_c1s1_000002_00.jpg",
             "0003_c2s1_000003_00.jpg", "0001_c2s1_000004_00.jpg"]
    assert attrs.build_id_map(files) == jattrs.build_id_map(files)
    n_ids = 3
    mat = str(tmp_path / "market_attribute.mat")
    split_attrs = {"age": np.array([[1, 3, 2]]), "up": np.array([[2, 4, 1]]),
                   "hat": np.array([[1, 1, 2]])}
    scipy.io.savemat(mat, {"market_attribute": {"train": split_attrs,
                                                "test": split_attrs}})
    for key in ("train_att", "test_att"):
        for dim in (25, 50):
            w2v = np.empty((1, 3), dtype=object)
            for a in range(3):
                w2v[0, a] = (np.arange(n_ids * dim).reshape(n_ids, dim)
                             .astype(np.float32) + 100 * a + dim)
            scipy.io.savemat(str(tmp_path / f"{key}_wordvec_dim{dim}.mat"),
                             {key: w2v})
    for split in ("train", "test", "test_seq"):
        ours = attrs.MarketAttributes(mat, str(tmp_path), split, files)
        ref = jattrs.MarketAttributes(mat, str(tmp_path), split, files)
        for pid in ("0001", "0002", "0003", "9999"):
            if pid != "9999":
                assert ours.onehot_for(pid) == ref.onehot_for(pid)
            assert ours.w2v_for(pid) == ref.w2v_for(pid)
    bare = attrs.MarketAttributes(None, None, "train", files)
    assert bare.onehot_for("0001") is None and bare.w2v_for("0001") == {}


# --------------------------------------------------------------- run()
H, W = 32, 16


def _write_market(root, rng, h=H, w=W, n_ids=3, n_cams=2, per_cam=3):
    """Seeded Market-named JPEGs and OpenPose pickles (py2 protocol):
    several candidates and two subsets per image, missing keypoints, one
    image without peaks and one whose subsets are empty."""
    img_dir, pose_dir = root / "imgs", root / "pose"
    os.makedirs(img_dir)
    os.makedirs(pose_dir)
    all_peaks, subsets = {}, {}
    names = _market_names(n_ids, n_cams, per_cam)
    for i, n in enumerate(names):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(img_dir / n, quality=90)
        if i == 1:
            continue  # no peaks for this image
        missing = tuple(rng.choice(18, int(rng.integers(0, 4)),
                                   replace=False))
        peaks = _peaks(rng, h, w, missing, n_cand=2)
        all_peaks[n] = peaks
        s = np.zeros((2, 20))
        for j in range(2):
            s[j, :18] = [p[j][3] if len(p) > j else -1 for p in peaks]
            s[j, -2] = rng.uniform()
        subsets[n] = s if i != 4 else np.zeros((0, 20))
    for fname, obj in (("all_peaks_dic.p", all_peaks),
                       ("subsets_dic.p", subsets)):
        with open(pose_dir / fname, "wb") as f:
            pickle.dump(obj, f, protocol=2)
    return str(img_dir), str(pose_dir)


def _write_df(root, rng, h=64, w=64):
    img_dir, pose_dir = root / "imgs", root / "pose"
    os.makedirs(img_dir)
    os.makedirs(pose_dir)
    all_peaks, subsets = {}, {}
    for pid in range(3):
        for j in range(3):
            n = f"id{pid:08d}_{j:02d}_{j}_front.jpg"
            Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                            ).save(img_dir / n)
            # whole body (knee + ankle) on some, a half body on others
            missing = () if j == 0 else (9, 10, 12, 13) if j == 1 else (5, 6)
            peaks = _peaks(rng, h, w, missing)
            all_peaks[n] = peaks
            s = np.zeros((1, 20))
            s[0, :18] = [p[0][3] if p else -1 for p in peaks]
            s[0, -2] = 1.0
            subsets[n] = s
    for fname, obj in (("all_peaks_dic_DeepFashion.p", all_peaks),
                       ("subsets_dic_DeepFashion.p", subsets)):
        with open(pose_dir / fname, "wb") as f:
            pickle.dump(obj, f, protocol=2)
    return str(img_dir), str(pose_dir)


def _write_rcv(root, rng, h=H, w=W):
    img_dir = root / "imgs"
    os.makedirs(img_dir)
    rcv_dic = {}
    for n in _market_names(2, 2, 2):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(img_dir / n)
        crs = np.stack([rng.integers(2, w - 2, 17), rng.integers(2, h - 2,
                                                                  17)])
        crs[:, rng.choice(17, 3, replace=False)] = 0
        rcv_dic[n] = pt.maskrcnn_to_openpose_rcv(crs.astype(np.float64))
    pkl = root / "rcv.p"
    with open(pkl, "wb") as f:
        pickle.dump(rcv_dic, f, protocol=2)
    return str(img_dir), str(pkl)


def _assert_same_shards(ours, theirs):
    """The same files; pn_pairs_num equal; every shard's records equal,
    parsed by protobuf, record by record in order."""
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    n_records = 0
    for f in sorted(os.listdir(ours)):
        if f.endswith(".p"):
            with open(os.path.join(ours, f), "rb") as a, \
                    open(os.path.join(theirs, f), "rb") as b:
                assert pickle.load(a) == pickle.load(b)
            continue
        got = list(jax_read_records(os.path.join(ours, f)))
        want = list(jax_read_records(os.path.join(theirs, f)))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert pb.Example.FromString(g) == pb.Example.FromString(w)
        n_records += len(got)
    return n_records


def _assert_same_batches(ours, theirs, split, dataset, h, w, batch=2):
    a = TFRecordPairLoader(ours, split, batch, h, w, dataset=dataset,
                           shuffle=False)
    b = JaxLoader(theirs, split, batch, h, w, dataset=dataset, shuffle=False)
    n = 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            assert x[k].dtype == y[k].dtype, k
        n += 1
    assert n > 0 and a.num_samples == b.num_samples
    a.close()


def test_run_market_train_with_flip_and_test_under_its_cap(tmp_path):
    img_dir, pose_dir = _write_market(tmp_path, np.random.default_rng(1))
    for split, kw in (("train", {}), ("test", dict(test_cap=7)),
                      ("train", dict(max_pairs=9, flip_augment=False))):
        ours, theirs = (str(tmp_path / f"{s}_{split}_{len(kw)}")
                        for s in ("port", "jax"))
        n = prun.run("market", img_dir, pose_dir, ours, split=split,
                     height=H, width=W, **kw)
        assert n == jrun.run("market", img_dir, pose_dir, theirs,
                             split=split, height=H, width=W, **kw)
        assert _assert_same_shards(ours, theirs) == n
        if split == "test":
            assert n <= 7
        if split == "train" and not kw:
            assert any("flip" in f for f in os.listdir(ours))
        _assert_same_batches(ours, theirs, split, "market", H, W)


def test_run_df_with_region_masks(tmp_path):
    img_dir, pose_dir = _write_df(tmp_path, np.random.default_rng(2))
    for seed, flip in ((0, True), (4, False)):
        ours, theirs = (str(tmp_path / f"{s}_{seed}")
                        for s in ("port", "jax"))
        n = prun.run("df", img_dir, pose_dir, ours, split="train",
                     height=64, width=64, flip_augment=flip, seed=seed)
        np.random.seed(seed)
        assert n == jrun.run("df", img_dir, pose_dir, theirs, split="train",
                             height=64, width=64, flip_augment=flip)
        assert _assert_same_shards(ours, theirs) == n
        rec = pb.Example.FromString(next(jax_read_records(
            os.path.join(ours, "DF_train_00000-of-00001.tfrecord"))))
        assert len(rec.features.feature["roi10_mask_0"].int64_list.value) \
            == 64 * 64 * 10
        _assert_same_batches(ours, theirs, "train", "df", 64, 64)


def test_run_rcv(tmp_path):
    img_dir, pkl = _write_rcv(tmp_path, np.random.default_rng(3))
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    n = prun.run("rcv", img_dir, pkl, ours, split="train", height=H,
                 width=W, flip_augment=False)
    assert n == jrun.run("rcv", img_dir, pkl, theirs, split="train",
                         height=H, width=W, flip_augment=False) > 0
    assert _assert_same_shards(ours, theirs) == n
    _assert_same_batches(ours, theirs, "train", "market", H, W)


def test_cli_writes_what_run_writes(tmp_path, capsys):
    img_dir, pose_dir = _write_market(tmp_path, np.random.default_rng(6))
    prun.main(["market", img_dir, pose_dir, str(tmp_path / "cli"),
               "--split=test", f"--H={H}", f"--W={W}"])
    assert "examples ->" in capsys.readouterr().out
    jrun.run("market", img_dir, pose_dir, str(tmp_path / "jax"),
             split="test", height=H, width=W)
    _assert_same_shards(str(tmp_path / "cli"), str(tmp_path / "jax"))
