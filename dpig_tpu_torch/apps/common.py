"""Shared glue for the model apps (port of `dpig_tpu/apps/common.py:13-57`)
plus the port's device rule."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config
from ..losses import gan
from ..ops.pose import render_pose_maps
from ..parallel import dist
from ..utils import spans


def critic_batches_per_step(cfg: Config) -> int:
    """Loader batches a Stage-II WGAN step consumes: 1+CRITIC_ITERS under
    the reference's fresh-batch-per-critic-iteration queue semantics
    (`--critic_batch_mode=fresh`, the default), 1 for the step that reuses
    one batch (`reused`)."""
    if cfg.critic_batch_mode not in ("fresh", "reused"):
        raise ValueError(
            f"--critic_batch_mode must be 'fresh' or 'reused', "
            f"got {cfg.critic_batch_mode!r}")
    return 1 + gan.CRITIC_ITERS if cfg.critic_batch_mode == "fresh" else 1


def select_device(platform: str) -> torch.device:
    """`--platform` -> torch device: '' is the card and raises without
    one; 'cpu' is the CPU. Nothing falls back silently. In a process group
    the card is the rank's own (`parallel.dist.rank_device`)."""
    if platform == "":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: dpig_tpu_torch runs on the card by default; "
                "pass --platform=cpu (Config(platform='cpu')) to run on the "
                "CPU")
        return dist.rank_device()
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--platform must be '' (the card) or 'cpu', got "
                     f"{platform!r}")


def batch_to_device(batch: Mapping[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy loader batch -> tensors on `device` (the span `copy_in`,
    counting the bytes copied)."""
    with spans.span("copy_in") as s:
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in batch.items()}
        if s is not None:
            s.add(bytes=sum(t.nbytes for t in out.values()))
    return out


def select_parts(batch_bbox: torch.Tensor, batch_vis: torch.Tensor,
                 n: int = 7):
    """Take the first n of the 37 stored part bboxes (trainer.py:576-578)."""
    return batch_bbox[:, :n, :], batch_vis[:, :n].to(torch.float32)


def pose_maps_from_batch(batch: Mapping[str, torch.Tensor], cfg: Config,
                         key: str = "pose_rcv") -> torch.Tensor:
    """The 18-ch radius-4 pose map from raw rcv coords, rendered on the
    batch's device (the CUDA kernel on the card)."""
    return render_pose_maps(batch[key], cfg.img_H, cfg.img_W,
                            cfg.keypoint_num, radius=4, normalized=False)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def masked_l1_loss(a: torch.Tensor, b: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """PoseMaskLoss (trainer.py:606): mean(|a-b| * mask)."""
    return torch.mean(torch.abs(a - b) * mask)
