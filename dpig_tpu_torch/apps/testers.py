"""Inference testers (port of `dpig_tpu/apps/testers.py:68-177,277-284,
529-580`): the model-12 pose-transfer tester, on the float32 path.

Writes the PNG directory tree that score.py consumes. Weights come from a
`bridge.params_from_flax` state, or are fresh (loudly) on a cold start.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch
from PIL import Image

from ..config import Config
from ..eval.metrics import ssim_images
from ..utils.viz import pose_to_gray
from .common import (batch_to_device, pose_maps_from_batch,
                     select_device, select_parts)
from .stage1_app import Stage1App

_PRETRAINED_FLAGS = ("pretrained_path", "pretrained_appSample_path",
                     "pretrained_poseAE_path", "pretrained_poseSample_path")


def _save_dir_tree(root: str, names) -> Dict[str, str]:
    dirs = {}
    for n in names:
        d = os.path.join(root, n)
        os.makedirs(d, exist_ok=True)
        dirs[n] = d
    return dirs


def _save_batch_pngs(dirs: Dict[str, str], arrays: Dict[str, np.ndarray],
                     start_idx: int) -> None:
    for name, arr in arrays.items():
        for j in range(arr.shape[0]):
            img = np.clip(arr[j], 0, 255).astype(np.uint8)
            if img.ndim == 3 and img.shape[-1] == 1:
                img = img[..., 0]
            Image.fromarray(img).save(
                os.path.join(dirs[name], f"{start_idx + j:05d}.png"))


class _TesterBase:
    """Stage-I nets on the device `cfg.platform` names ('' = the card)."""

    REQUIRED = frozenset()

    def __init__(self, cfg: Config, params: Optional[Mapping] = None):
        for flag in _PRETRAINED_FLAGS:
            if getattr(cfg, flag):
                raise NotImplementedError(
                    f"--{flag}: orbax checkpoints are not readable by "
                    "dpig_tpu_torch yet (ROADMAP: the orbax->torch checkpoint "
                    "importer); bridge the flax params with "
                    "bridge.params_from_flax and pass them as `params`")
        if cfg.inference_dtype == "int8":
            raise NotImplementedError(
                "--inference_dtype=int8 needs models/quant.py and its s8 conv "
                "kernel, not ported to dpig_tpu_torch yet")
        self.cfg = cfg
        self.device = select_device(cfg.platform)
        if params is None:
            # Cold start (tests / smoke runs): loudly, so a production run
            # without weights is obvious.
            print(f"[!] {type(self).__name__}: no pretrained weights for "
                  f"{sorted(self.REQUIRED)} — using RANDOM init (pass "
                  "bridged params for real inference)", flush=True)
        self.stage1 = Stage1App(cfg, self.device, state=params)

    # shared forward pieces ------------------------------------------------
    def _encode_app(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        bbox, vis = select_parts(batch["part_bbox"], batch["part_vis"],
                                 cfg.roi_part_num)
        return self.stage1._encode(batch["x"], batch["mask_r6"], bbox, vis)

    def _generate(self, embs: torch.Tensor,
                  pose_maps: torch.Tensor) -> torch.Tensor:
        return self.stage1._generate(embs, pose_maps)

    def _disc_score(self, g_raw: torch.Tensor) -> torch.Tensor:
        """D logits of the generated batch, normalized by its own batch
        statistics (flax train=True with the updated stats discarded)."""
        return self.stage1._disc_apply(g_raw, train=True)


class ConditionalTransferTester(_TesterBase):
    """Model 12 (tester.py:616-767): PG2-style pose transfer — source
    appearance + target pose -> image; writes the directory tree score.py
    consumes (x, x_target, G, pose, pose_target, mask, mask_target)."""

    REQUIRED = frozenset({"Encoder", "ID_AE"})
    DEFAULT_BATCHES = 600  # tester.py:650

    @torch.inference_mode()
    def transfer_step(self, batch: Mapping[str, torch.Tensor]):
        """Batch of device tensors -> (images [B,H,W,3] in [0,255],
        target pose maps [B,H,W,K], D scores [B])."""
        cfg = self.cfg
        embs = self._encode_app(batch)
        pose_t = pose_maps_from_batch(batch, cfg, "pose_rcv_target")
        g_raw = self._generate(embs, pose_t)
        score = self._disc_score(g_raw)
        return torch.clamp((g_raw + 1) * 127.5, 0, 255), pose_t, score

    def run(self, loader: Iterator, test_batch_num: Optional[int] = None) -> str:
        cfg = self.cfg
        n = test_batch_num or cfg.test_batch_num or self.DEFAULT_BATCHES
        out_root = os.path.join(cfg.model_dir, "test_result")
        dirs = _save_dir_tree(out_root, ["x", "x_target", "G", "pose",
                                         "pose_target", "mask", "mask_target"])
        ssims = []
        for i, batch in enumerate(itertools.islice(loader, n)):
            jb = batch_to_device(batch, self.device)
            g, pose_t, _score = self.transfer_step(jb)
            with torch.inference_mode():
                pose_s = pose_maps_from_batch(jb, cfg)
            g = g.cpu().numpy()
            x_target = (batch["x_target"] + 1) * 127.5
            _save_batch_pngs(dirs, {
                "x": (batch["x"] + 1) * 127.5,
                "x_target": x_target,
                "G": g,
                "pose": pose_to_gray(pose_s.cpu().numpy()),
                "pose_target": pose_to_gray(pose_t.cpu().numpy()),
                "mask": batch["mask_r4"] * 255.0,
                "mask_target": batch["mask_r4_target"] * 255.0,
            }, i * cfg.batch_size)
            ssims.extend(ssim_images(g, x_target))
        print(f"[*] transfer SSIM vs x_target: {np.mean(ssims):.4f} "
              f"over {len(ssims)} images")
        return out_root
