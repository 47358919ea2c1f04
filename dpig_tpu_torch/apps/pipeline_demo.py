"""End-to-end pipeline demo on a procedurally generated mini-dataset: the
port's twin of `scripts/pipeline_demo.py`.

Draws "stick people" (per-identity colors, pose-consistent skeletons,
per-camera backgrounds), converts them with the port's tfrecord converter
(`data/convert/run.py`), trains all four stages through the port's
`Trainer` (Stage-I appearance, pose AE, Stage-II app + pose samplers,
each on the port checkpoints of the stages before it), runs the three
testers on the test split, and scores the transfer output: every
subsystem on data with structure, so the Stage-I L1 falls and the SSIM
rises above the random-init baseline.

  python -m dpig_tpu_torch.apps.pipeline_demo [workdir] [steps_scale] \
      [--platform=cpu]

It runs on the card unless `--platform=cpu` is given. Without a workdir
it makes a new one under the temporary directory (`TMPDIR`); a workdir
that already holds the converted records is trained on as it is.
`results.json` in the workdir holds the JAX script's keys:
`pose_ae_final_mse`, the `score_stage1` numbers, `stage1_first_L1` and
`stage1_final_L1`.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
from typing import Dict

import numpy as np
from PIL import Image, ImageDraw

H, W = 64, 32
N_IDS, N_CAMS, N_POSES = 8, 2, 12

LIMBS = [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
         (9, 10), (1, 11), (11, 12), (12, 13), (1, 0)]

# (model, steps at scale 1, batch size) of each training stage
STAGES = {"stage1": (1, 1200, 16), "poseae": (2, 800, 64),
          "appsample": (3, 400, 16), "posesample": (4, 400, 32)}


def make_pose(rng):
    """Plausible 18-kp stick pose in pixel coords (row, col)."""
    cx = W / 2 + rng.uniform(-4, 4)
    top = 8 + rng.uniform(-2, 2)
    kp = np.zeros((18, 2))
    kp[0] = [top, cx]                      # nose
    kp[1] = [top + 6, cx]                  # neck
    sw = 5 + rng.uniform(-1, 1)
    kp[2] = [top + 7, cx - sw]             # Rsho
    kp[5] = [top + 7, cx + sw]             # Lsho
    for base, sign in ((2, -1), (5, 1)):
        ang = rng.uniform(-0.5, 0.5)
        kp[base + 1] = kp[base] + [9, sign * 2 + ang * 4]   # elbow
        kp[base + 2] = kp[base + 1] + [9, sign * 1 + ang * 4]  # wrist
    hw = 4
    kp[8] = [top + 24, cx - hw]            # Rhip
    kp[11] = [top + 24, cx + hw]           # Lhip
    for base, sign in ((8, -1), (11, 1)):
        ang = rng.uniform(-0.3, 0.3)
        kp[base + 1] = kp[base] + [11, ang * 5]
        kp[base + 2] = kp[base + 1] + [11, ang * 5]
    kp[14] = kp[0] + [-1, 2]               # eyes/ears
    kp[15] = kp[0] + [-1, -2]
    kp[16] = kp[0] + [0, 3]
    kp[17] = kp[0] + [0, -3]
    return np.clip(kp, 2, [H - 3, W - 3])


def draw_person(kp, pid, cam, rng):
    bg = [(40 + 20 * cam) % 255, (80 + 60 * cam) % 255, 120]
    img = Image.new("RGB", (W, H), tuple(bg))
    d = ImageDraw.Draw(img)
    col = tuple(int(c) for c in np.array(
        [50 + pid * 25 % 200, 200 - pid * 20 % 180, 60 + pid * 35 % 190]))
    for a, b in LIMBS:
        d.line([(kp[a][1], kp[a][0]), (kp[b][1], kp[b][0])], fill=col,
               width=3)
    d.ellipse([kp[0][1] - 3, kp[0][0] - 3, kp[0][1] + 3, kp[0][0] + 3],
              fill=col)
    return img


def generate_dataset(root, seed=0):
    """N_IDS x N_CAMS x N_POSES Market-named JPEGs under <root>/imgs and
    their OpenPose pickles (all_peaks_dic.p, subsets_dic.p) under
    <root>/pose -> (img_dir, pose_dir)."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imgs")
    pose_dir = os.path.join(root, "pose")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pose_dir, exist_ok=True)
    all_peaks, subsets = {}, {}
    i = 0
    for pid in range(1, N_IDS + 1):
        for cam in range(1, N_CAMS + 1):
            for _ in range(N_POSES):
                i += 1
                name = f"{pid:04d}_c{cam}s1_{i:06d}_00.jpg"
                kp = make_pose(rng)
                draw_person(kp, pid, cam, rng).save(
                    os.path.join(img_dir, name), quality=95)
                peaks = [[(float(kp[k][1]), float(kp[k][0]), 0.9, k)]
                         for k in range(18)]
                all_peaks[name] = peaks
                s = np.zeros((1, 20))
                s[0, :18] = np.arange(18)
                s[0, -2] = 1.0
                subsets[name] = s
    with open(os.path.join(pose_dir, "all_peaks_dic.p"), "wb") as f:
        pickle.dump(all_peaks, f)
    with open(os.path.join(pose_dir, "subsets_dic.p"), "wb") as f:
        pickle.dump(subsets, f)
    return img_dir, pose_dir


def _metrics_lines(model_dir: str) -> list:
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default=None,
                    help="a new directory under the temporary directory "
                         "by default")
    ap.add_argument("steps_scale", nargs="?", type=float, default=1.0)
    ap.add_argument("--platform", default="",
                    help="'cpu' to run on the CPU; the card by default")
    a = ap.parse_args(argv)
    scale = a.steps_scale
    root = a.workdir or tempfile.mkdtemp(prefix="pipeline_demo_")
    os.makedirs(root, exist_ok=True)
    print(f"workdir {root}", flush=True)

    data_dir = os.path.join(root, "Market_demo")
    if not os.path.exists(os.path.join(data_dir, "pn_pairs_num_train.p")):
        print("== generating dataset ==", flush=True)
        img_dir, pose_dir = generate_dataset(root)
        from ..data.convert.run import run as convert
        n_train = convert("market", img_dir, pose_dir, data_dir,
                          split="train", height=H, width=W,
                          flip_augment=False, max_pairs=800)
        n_test = convert("market", img_dir, pose_dir, data_dir, split="test",
                         height=H, width=W, flip_augment=False, test_cap=192,
                         max_pairs=192)
        print(f"train={n_train} test={n_test}", flush=True)

    from ..apps import testers
    from ..apps.common import select_device
    from ..apps.stage1_app import Stage1App
    from ..apps.stage1_pose import Stage1PoseApp
    from ..apps.stage2_app import Stage2AppApp
    from ..apps.stage2_pose import Stage2PoseApp
    from ..config import Config
    from ..data.loader import TFRecordPairLoader
    from ..eval.score import score_stage1
    from ..train import checkpoint as ckpt
    from ..train.harness import Trainer

    device = select_device(a.platform)

    def cfg_for(name, model, steps, bs, **kw):
        return Config(model=model, img_H=H, img_W=W, batch_size=bs,
                      conv_hidden_num=32, z_num=32,
                      g_lr=2e-4, d_lr=2e-4, lr_update_step=100000,
                      max_step=int(steps * scale), log_step=50,
                      model_dir=os.path.join(root, name),
                      dataset="Market_demo", data_dir=root,
                      platform=a.platform, **kw)

    def loader_for(cfg, split="train"):
        return TFRecordPairLoader(data_dir, split, cfg.batch_size, H, W,
                                  dataset="market", shuffle=split == "train",
                                  seed=0)

    def train(name, make_app, **kw):
        model, steps, bs = STAGES[name]
        cfg = cfg_for(name, model, steps, bs, **kw)
        loader = loader_for(cfg)
        try:
            Trainer(cfg, make_app(cfg), loader).train()
        finally:
            loader.close()
        return cfg, ckpt.latest_checkpoint(cfg.model_dir)

    results = {}

    print("== stage 1: appearance ==", flush=True)
    cfg1, stage1_ckpt = train("stage1", lambda c: Stage1App(c, device))

    print("== stage 1: pose AE ==", flush=True)
    cfg2, poseae_ckpt = train("poseae", lambda c: Stage1PoseApp(c, device))
    results["pose_ae_final_mse"] = float(
        _metrics_lines(cfg2.model_dir)[-1]["reconstruct_loss"])

    print("== stage 2: appearance samplers ==", flush=True)
    frozen3 = ckpt.restore_subtrees(stage1_ckpt, ["Encoder", "ID_AE"])
    _, appsample_ckpt = train(
        "appsample", lambda c: Stage2AppApp(c, device, frozen3),
        pretrained_path=stage1_ckpt)

    print("== stage 2: pose sampler ==", flush=True)
    frozen4 = dict(ckpt.restore_subtrees(poseae_ckpt, ["PoseAE"]))
    frozen4.update(frozen3)
    _, posesample_ckpt = train(
        "posesample", lambda c: Stage2PoseApp(c, device, frozen4))

    print("== testers ==", flush=True)
    common = dict(pretrained_path=stage1_ckpt,
                  pretrained_poseAE_path=poseae_ckpt,
                  pretrained_appSample_path=appsample_ckpt,
                  pretrained_poseSample_path=posesample_ckpt,
                  is_train=False)
    runs = (("test12", 12, testers.ConditionalTransferTester, 8, {}),
            ("test11", 11, testers.FullSamplingTester, 4,
             dict(sample_app=True, one_app_per_batch=True)),
            ("test13", 13, testers.FactorSamplingTester, 4,
             dict(sample_fg=True)))
    out12 = cfg12 = None
    for name, model, tester_cls, n, kw in runs:
        cfg = cfg_for(name, model, 0, 16, **kw, **common)
        loader = loader_for(cfg, "test")
        try:
            out = tester_cls(cfg).run(loader, test_batch_num=n)
        finally:
            loader.close()
        if model == 12:
            out12, cfg12 = out, cfg

    print("== scoring ==", flush=True)
    results.update(score_stage1(cfg12.model_dir, os.path.basename(out12),
                                platform=a.platform))

    stage1_metrics = _metrics_lines(cfg1.model_dir)
    results["stage1_first_L1"] = stage1_metrics[0]["L1Loss"]
    results["stage1_final_L1"] = stage1_metrics[-1]["L1Loss"]
    with open(os.path.join(root, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
