"""The one-by-one demo (`--test_one_by_one`) of the port against the JAX
package's `dpig_tpu.apps.demo.run_one_by_one`, on the CPU at 32x16: the
port's copy of `pose_tools` bit-equal to `dpig_tpu/data/pose_tools.py` on
seeded OpenPose peaks, then both demos on the inputs JAX's own test
writes (tests/test_testers.py:129-157) grown to a few pairs (a name with
no peaks, a pair with no valid subset, the RandomState(0) shuffle): the
same file names in all seven trees, x / x_target / pose / pose_target /
mask / mask_target PNGs bit-equal, G within one level (both sides float32
on the same weights, rounded to uint8), and the CLI.
"""
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dpig_tpu.apps import demo as jdemo
from dpig_tpu.apps.demo import run_one_by_one as jax_run_one_by_one
from dpig_tpu.apps.testers import ConditionalTransferTester as JaxTester
from dpig_tpu.config import Config as JaxConfig
from dpig_tpu.data import pose_tools as jpt
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.apps.demo import DIRS, run_one_by_one
from dpig_tpu_torch.apps.testers import ConditionalTransferTester
from dpig_tpu_torch.bridge import params_from_flax
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.data import pose_tools as pt

torch.set_num_threads(1)

H, W = 32, 16
SMALL = dict(img_H=H, img_W=W, batch_size=1, conv_hidden_num=16, z_num=16)


def _peaks(rng, h, w, n_cand=1, missing=()):
    """OpenPose all_peaks: per keypoint a list of (x, y, score, id)
    candidates, ids unique over the image; keypoints in `missing` empty."""
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


def test_pose_tools_bit_equal_to_jax():
    """Every copied function on seeded inputs: peaks with several
    candidates, missing keypoints and two subsets, the masks at radius 4
    and 7 (Solid and Gaussian discs), the 37 bboxes at radius 6, and the
    records get_valid_peaks rejects."""
    rng = np.random.default_rng(11)
    for trial in range(6):
        h, w = (128, 64) if trial % 2 else (H, W)
        missing = set(rng.choice(18, trial, replace=False).tolist())
        all_peaks = _peaks(rng, h, w, n_cand=2, missing=missing)
        ids = [c[3] for p in all_peaks for c in p]
        subsets = np.zeros((2, 20))
        subsets[:, :18] = -1
        for s in range(2):
            for k, p in enumerate(all_peaks):
                if p:
                    subsets[s, k] = p[s % len(p)][3]
        subsets[:, -2] = rng.uniform(0, 5, 2)
        assert len(set(ids)) == len(ids)
        peaks = pt.get_valid_peaks(all_peaks, subsets)
        assert peaks == jpt.get_valid_peaks(all_peaks, subsets)
        for radius in (4, 7):
            for mode in ("Solid", "Gaussian"):
                got = pt.get_pose_mask(peaks, h, w, radius=radius, mode=mode)
                want = jpt.get_pose_mask(peaks, h, w, radius=radius,
                                         mode=mode)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        assert pt.get_part_bbox37(peaks, h, w, radius=6) == \
            jpt.get_part_bbox37(peaks, h, w, radius=6)
        r, c = rng.uniform(-3, h + 3), rng.uniform(-3, w + 3)
        for mode in ("Solid", "Gaussian"):
            assert pt.get_sparse_keypoint(r, c, 2, h, w, 4, 4, mode) == \
                jpt.get_sparse_keypoint(r, c, 2, h, w, 4, 4, mode)
    for bad in (np.zeros((0, 20)), None, [[1.0]]):
        assert pt.get_valid_peaks(all_peaks, bad) is None
        assert jpt.get_valid_peaks(all_peaks, bad) is None


@pytest.fixture(scope="module")
def demo_inputs(tmp_path_factory):
    """JAX's test inputs (random 32x16 JPEG images, one full-score subset
    per image) for five images, and pairs that exercise the loop: a name
    without peaks (passed over), an image whose subsets are empty (its
    pair uses up a number and writes nothing), and the shuffle."""
    root = tmp_path_factory.mktemp("demo")
    rng = np.random.default_rng(0)
    img_dir = root / "imgs"
    os.makedirs(img_dir)
    names = ["a.jpg", "b.jpg", "c.jpg", "d.jpg", "e.jpg"]
    all_peaks, subsets = {}, {}
    for n in names:
        Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
                        ).save(img_dir / n)
        all_peaks[n] = [[(float(rng.integers(2, W - 2)),
                          float(rng.integers(2, H - 2)), 0.9, k)]
                        for k in range(18)]
        s = np.zeros((1, 20))
        s[0, :18] = np.arange(18)
        s[0, -2] = 1.0
        subsets[n] = s
    subsets["e.jpg"] = np.zeros((0, 20))
    pairs = [("a.jpg", "b.jpg"), ("b.jpg", "x.jpg"), ("c.jpg", "a.jpg"),
             ("e.jpg", "d.jpg"), ("d.jpg", "c.jpg"), ("b.jpg", "d.jpg")]
    paths = []
    for obj, fn in ((pairs, "pairs.p"), (all_peaks, "peaks.p"),
                    (subsets, "subsets.p")):
        with open(root / fn, "wb") as f:
            pickle.dump(obj, f, protocol=2)
        paths.append(str(root / fn))
    return root, str(img_dir), paths


def _tree(out):
    return {d: sorted(os.listdir(os.path.join(out, d))) for d in DIRS}


@pytest.fixture(scope="module")
def testers(demo_inputs):
    """JAX's cold-start model-12 tester, and the port's on its bridged
    params."""
    jt = JaxTester(JaxConfig(model_dir=str(demo_inputs[0]), **SMALL))
    params = params_from_flax(jax.tree_util.tree_map(np.array, jt.params),
                              ConditionalTransferTester.SUBTREES)
    return jt, ConditionalTransferTester(
        Config(platform="cpu", model_dir=str(demo_inputs[0]), **SMALL),
        params=params)


@pytest.mark.parametrize("shuffle,pair_num", [(False, 500), (True, 3)])
def test_run_one_by_one_matches_jax(demo_inputs, testers, monkeypatch,
                                    shuffle, pair_num):
    """Both demos on the same weights (JAX's demo given its tester, which
    it would otherwise build as it is, from the same seed): the same file
    names, the images, poses and masks bit-equal, G within one level of
    255."""
    root, img_dir, paths = demo_inputs
    jt, tester = testers
    monkeypatch.setattr(jdemo, "ConditionalTransferTester", lambda cfg: jt)
    tag = f"{shuffle}-{pair_num}"
    want = jax_run_one_by_one(
        JaxConfig(model_dir=str(root / f"jax{tag}"), **SMALL), img_dir,
        *paths, pair_num=pair_num, shuffle=shuffle)
    cfg = Config(platform="cpu", model_dir=str(root / f"port{tag}"), **SMALL)
    got = run_one_by_one(cfg, img_dir, *paths, pair_num=pair_num,
                         shuffle=shuffle, tester=tester)
    assert os.path.basename(got) == os.path.basename(want) == "test_demo"
    tree = _tree(got)
    assert tree == _tree(want)
    if not shuffle:  # "x.jpg" has no peaks; e.jpg's pair takes number 2
        assert tree["G"] == ["pair00000-a.jpg-b.jpg.png",
                             "pair00001-c.jpg-a.jpg.png",
                             "pair00003-d.jpg-c.jpg.png",
                             "pair00004-b.jpg-d.jpg.png"]
    else:
        assert len(tree["G"]) <= pair_num
    for d, files in tree.items():
        for f in files:
            a, b = (np.asarray(Image.open(os.path.join(o, d, f)), np.int16)
                    for o in (got, want))
            if d == "G":
                assert np.abs(a - b).max() <= 1, f
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{d}/{f}")


def test_cli_test_one_by_one(demo_inputs, tmp_path):
    """`--test_one_by_one` through the CLI on the demo flags (the pairs
    shuffled, pair_num 500): the test_demo tree under model_dir, one G per
    pair with peaks and a valid subset."""
    _, img_dir, (pairs, peaks, subsets) = demo_inputs
    port_main.main(["--model=12", "--is_train=false", "--platform=cpu",
                    "--test_one_by_one=true", f"--demo_img_dir={img_dir}",
                    f"--demo_pair_path={pairs}",
                    f"--demo_all_peaks_path={peaks}",
                    f"--demo_subsets_path={subsets}",
                    f"--model_dir={tmp_path}", f"--img_H={H}",
                    f"--img_W={W}", "--conv_hidden_num=16", "--z_num=16"])
    tree = _tree(tmp_path / "test_demo")
    assert len(tree["G"]) == 4
    assert all(len(tree[d]) == 4 for d in DIRS)
