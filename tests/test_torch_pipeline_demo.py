"""The end-to-end pipeline demo of the port
(`dpig_tpu_torch.apps.pipeline_demo`) against the JAX package's
(`scripts/pipeline_demo.py`), on the CPU: the stick-people dataset the
same (file names, JPEG bytes, and the OpenPose pickles once loaded), then
the port's whole pipeline through its CLI at a steps_scale giving 1-3
steps a stage (convert, models 1 -> 2 -> 3 -> 4 on the port's
checkpoints, testers 12 / 11 / 13 on the test split, scoring): its
`results.json` has the JAX script's keys, finite values, and the score
of the JAX package's `score_stage1` on the port's transfer tree.
"""
import json
import math
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from dpig_tpu.eval.score import score_stage1 as jax_score_stage1
from dpig_tpu_torch.apps import pipeline_demo as pd

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import pipeline_demo as jpd  # noqa: E402

torch.set_num_threads(1)

SCALE = 0.0025  # 3, 2, 1 and 1 steps: int(1200 / 800 / 400 * SCALE)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline"))
    results = pd.main([root, str(SCALE), "--platform=cpu"])
    return root, results


def test_generate_dataset_matches_jax(port_run, tmp_path):
    root, _ = port_run
    jimg, jpose = jpd.generate_dataset(str(tmp_path))
    names = sorted(os.listdir(jimg))
    assert names == sorted(os.listdir(os.path.join(root, "imgs")))
    assert len(names) == jpd.N_IDS * jpd.N_CAMS * jpd.N_POSES
    for n in names:
        with open(os.path.join(jimg, n), "rb") as a, \
                open(os.path.join(root, "imgs", n), "rb") as b:
            assert a.read() == b.read(), n
    for f in ("all_peaks_dic.p", "subsets_dic.p"):
        with open(os.path.join(jpose, f), "rb") as a, \
                open(os.path.join(root, "pose", f), "rb") as b:
            want, got = pickle.load(a), pickle.load(b)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k], object)
                                          if f.startswith("all") else got[k],
                                          np.asarray(want[k], object)
                                          if f.startswith("all") else want[k])
    assert pd.LIMBS == jpd.LIMBS and (pd.H, pd.W) == (jpd.H, jpd.W)


def test_pipeline_writes_jax_keys_and_its_trees(port_run):
    root, results = port_run
    with open(os.path.join(root, "results.json")) as f:
        assert json.load(f) == results
    tree = [d for d in os.listdir(os.path.join(root, "test12"))
            if d.startswith("test_result")]
    assert len(tree) == 1
    want = jax_score_stage1(os.path.join(root, "test12"), tree[0])
    assert set(results) == {"pose_ae_final_mse", "stage1_first_L1",
                            "stage1_final_L1", *want}
    for k, v in want.items():
        assert abs(results[k] - v) <= 1e-9 * max(1.0, abs(v)), k
    assert all(math.isfinite(v) for v in results.values())
    for name, steps in (("stage1", 3), ("poseae", 2), ("appsample", 1),
                        ("posesample", 1)):
        assert os.path.isdir(os.path.join(
            root, name, "ckpt", f"step_{steps:08d}")), name
    for name in ("test11", "test13"):
        assert any(d.startswith("test_result")
                   for d in os.listdir(os.path.join(root, name))), name
    with open(os.path.join(root, "Market_demo", "pn_pairs_num_test.p"),
              "rb") as f:
        assert pickle.load(f) == 192


def test_default_workdir_is_new_under_the_temporary_directory(
        tmp_path, monkeypatch):
    """Without a workdir each run makes its own under `TMPDIR`, so two runs
    never train on each other's records."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    roots = []

    def stop(root):
        roots.append(root)
        raise RuntimeError("stop after the workdir")
    monkeypatch.setattr(pd, "generate_dataset", stop)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="stop after the workdir"):
            pd.main(["--platform=cpu"])
    assert len(set(roots)) == 2
    for root in roots:
        assert os.path.dirname(root) == str(tmp_path)
        assert os.path.basename(root).startswith("pipeline_demo_")
