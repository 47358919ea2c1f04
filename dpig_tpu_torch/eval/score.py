"""Scoring CLI: the port's twin of `dpig_tpu/eval/score.py` (score.py /
score_mask.py).

  python -m dpig_tpu_torch.eval.score <stage> <model_dir> <test_dir>
         [--mask] [--no_is] [--platform=cpu]

stage 1: <test_dir>/G against <test_dir>/x_target (score.py:33-105);
         --mask multiplies both by <test_dir>/mask first (score_mask.py).
stage 2: <test_dir>/G1 and G2 against x_target in one call.
Writes score.txt (score_mask.txt with --mask) in the test dir and prints
every metric. The PNGs are read with PIL, as in JAX, and scored in
batches of `SCORE_BATCH` on the card (`--platform=cpu`: the CPU) in
float64 (`eval/metrics.py`). The Inception Score is skipped: the port has
no classifier (`eval/inception.py`), so `--inception_pb` raises.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from ..apps.common import select_device
from . import metrics

SCORE_BATCH = 64
KEYS = ("ssim", "psnr", "l1", "l2")
IS_SKIPPED = ("[*] Inception Score skipped: dpig_tpu_torch has no "
              "classifier for it (the protocol's frozen Inception graph "
              "needs TensorFlow)")


def _refuse_inception(inception_pb: Optional[str]) -> None:
    if inception_pb:
        raise ValueError(
            f"--inception_pb={inception_pb}: the Inception Score's "
            "classifier is the frozen 2015 Inception graph, which needs "
            "TensorFlow, and dpig_tpu_torch has no classifier of its own "
            "(ROADMAP.md, Later: the IS classifier). Score with --no_is, "
            "or compute IS with the JAX package's dpig_tpu.eval.score")


def _index_key(path: str) -> str:
    """Leading digit run of the basename: the sample index the tester
    wrote (x_target/ files are bare `00012.png`, G/ files carry suffixes
    `00012_score1.234.png`)."""
    m = re.match(r"(\d+)", os.path.basename(path))
    return m.group(1) if m else os.path.basename(path)


def _load_dir(d: str):
    files = sorted(sum((glob.glob(os.path.join(d, pat))
                        for pat in ("*.jpg", "*.png")), []))
    keys = [_index_key(f) for f in files]
    dupes = {k for k in keys if keys.count(k) > 1}
    if dupes:
        raise AssertionError(
            f"{d}: duplicate sample indices {sorted(dupes)[:5]} — "
            "sorted-name pairing would silently mispair; clean the "
            "directory")
    return [np.asarray(Image.open(f)) for f in files], keys


def _assert_paired(dirs_keys: Sequence[tuple]) -> None:
    """Every dir must cover the SAME index set in the same sorted order —
    pairing by sorted filename is only protocol-valid then."""
    (ref_name, ref_keys) = dirs_keys[0]
    for name, keys in dirs_keys[1:]:
        if keys != ref_keys:
            diff = sorted(set(keys) ^ set(ref_keys))
            raise AssertionError(
                f"{name}/ and {ref_name}/ index prefixes disagree "
                f"(first diffs: {diff[:5]}) — refusing to pair by sort "
                "order")


def _runs(lists: Sequence[List[np.ndarray]], size: int):
    """(start, end) of consecutive runs of at most `size` samples whose
    images have one shape in each list, so each run stacks."""
    n, start = len(lists[0]), 0
    while start < n:
        shapes = [lst[start].shape for lst in lists]
        end = start + 1
        while (end < n and end - start < size
               and [lst[end].shape for lst in lists] == shapes):
            end += 1
        yield start, end
        start = end


def per_image(g_list, x_list, masks, device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """The protocol's four values of every pair (masked when `masks` is
    given) -> {key: float64 [N] on `device`}."""
    lists = [g_list, x_list] + ([masks] if masks is not None else [])
    parts = {k: [] for k in KEYS}
    for lo, hi in _runs(lists, SCORE_BATCH):
        g, x, *m = (torch.from_numpy(np.stack(lst[lo:hi])).to(device)
                    for lst in lists)
        r = (metrics.score_pair_masked(g, x, m[0]) if m
             else metrics.score_pair_gray(g, x))
        for k in KEYS:
            parts[k].append(r[k])
    return {k: torch.cat(v) for k, v in parts.items()}


def _mean_std(v: torch.Tensor):
    """np.mean / np.std (the population std) of the values."""
    return float(v.mean()), float(v.std(correction=0))


def score_stage1(model_dir: str, test_dir: str, masked: bool = False,
                 inception_pb: Optional[str] = None,
                 platform: str = "") -> dict:
    _refuse_inception(inception_pb)
    device = select_device(platform)
    root = os.path.join(model_dir, test_dir)
    g_list, g_keys = _load_dir(os.path.join(root, "G"))
    x_list, x_keys = _load_dir(os.path.join(root, "x_target"))
    if not (len(g_list) == len(x_list) and g_list):
        raise AssertionError(
            f"need matching G/ and x_target/ PNG dirs under {root}")
    pairing = [("G", g_keys), ("x_target", x_keys)]
    masks = None
    if masked:
        masks, m_keys = _load_dir(os.path.join(root, "mask"))
        if len(masks) != len(g_list):
            raise AssertionError(f"mask/ has {len(masks)} images but G/ "
                                 f"has {len(g_list)}")
        pairing.append(("mask", m_keys))
    _assert_paired(pairing)

    per = per_image(g_list, x_list, masks, device)
    out = {}
    for k in KEYS:
        out[f"{k}_G_x_mean"], out[f"{k}_G_x_std"] = _mean_std(per[k])

    score_path = os.path.join(root, "score_mask.txt" if masked
                              else "score.txt")
    with open(score_path, "w") as f:
        f.write(f"Image number: {len(g_list)}\n")
        for k, v in out.items():
            f.write(f"{k}: {v:.5f}\n")
    for k, v in out.items():
        print(f"{k}: {v:.6f}")
    return out


def score_stage2(model_dir: str, test_dir: str, masked: bool = False,
                 inception_pb: Optional[str] = None,
                 platform: str = "") -> dict:
    """Two-stage (PG2-style G1/G2) scoring: both generated trees against
    x_target in one call (score.py:115-223); --mask applies the
    score_mask.py:176-282 protocol."""
    _refuse_inception(inception_pb)
    device = select_device(platform)
    root = os.path.join(model_dir, test_dir)
    x_list, x_keys = _load_dir(os.path.join(root, "x_target"))
    masks = None
    if masked:
        masks, m_keys = _load_dir(os.path.join(root, "mask"))
        if len(masks) != len(x_list):
            raise AssertionError(f"mask/ has {len(masks)} images but "
                                 f"x_target/ has {len(x_list)}")
        _assert_paired([("x_target", x_keys), ("mask", m_keys)])
    out = {}
    lines = [f"N: {len(x_list)}   "]
    for gen in ("G1", "G2"):
        g_list, g_keys = _load_dir(os.path.join(root, gen))
        if not (len(g_list) == len(x_list) and g_list):
            raise AssertionError(
                f"need matching {gen}/ and x_target/ PNG dirs under {root}")
        _assert_paired([(gen, g_keys), ("x_target", x_keys)])
        per = per_image(g_list, x_list, masks, device)
        for k in KEYS:
            mean, std = _mean_std(per[k])
            out[f"{k}_{gen}_x_mean"], out[f"{k}_{gen}_x_std"] = mean, std
            lines.append(f"{k}{gen}: {mean:.5f} +- {std:.5f}   ")
    score_name = "score_mask.txt" if masked else "score.txt"
    with open(os.path.join(root, score_name), "w") as f:
        f.write("".join(lines).rstrip() + "\n")
    for k, v in out.items():
        print(f"{k}: {v:.6f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", type=int)
    ap.add_argument("model_dir")
    ap.add_argument("test_dir")
    ap.add_argument("--mask", action="store_true")
    ap.add_argument("--inception_pb", default=None,
                    help="refused: the port has no Inception classifier")
    ap.add_argument("--no_is", action="store_true",
                    help="skip the Inception Score without a note")
    ap.add_argument("--platform", default="",
                    help="'' (default): the card; 'cpu': the CPU")
    a = ap.parse_args(argv)
    if a.no_is:
        a.inception_pb = None  # skip IS even when a graph was given
    elif a.inception_pb is None:
        print(IS_SKIPPED, flush=True)
    if a.stage == 2:
        score_stage2(a.model_dir, a.test_dir, masked=a.mask,
                     inception_pb=a.inception_pb, platform=a.platform)
    elif a.stage == 1:
        score_stage1(a.model_dir, a.test_dir, masked=a.mask,
                     inception_pb=a.inception_pb, platform=a.platform)
    else:
        raise SystemExit(f"unknown stage {a.stage} (expected 1 or 2, "
                         "matching the reference score.py CLI)")


if __name__ == "__main__":
    main()
