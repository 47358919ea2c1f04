"""Stage-I pose autoencoder, the inference half (port of
`dpig_tpu/apps/stage1_pose.py:21-54,73-82`; reference model 2 / 102,
trainer.py:629-711 DPIG_PoseRCV_AE_BodyROI).

18x(row,col,vis) normalized to [-1,1] -> FC-res AE; the visibility is
decoded through the straight-through binary round. Its training (model 2)
is not ported yet (ROADMAP queue item 3).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..models.layers import init_weights
from ..models.pose_ae import PoseDecoderFC, PoseEncoderFC, assemble_pose_rcv
from ..ops.pose import render_pose_maps
from .stage1_app import full_float32

POSE_Z = 32  # dpig_tpu/apps/stage2_pose.py:33


class Stage1PoseApp:
    """The pose AE's encoder and decoder on `device`, frozen, as the
    sub-tree `PoseAE` (`G_Pose_Encoder` / `G_Pose_Decoder`) of a
    `bridge.params_from_flax` state, or fresh (Xavier, from `gen`, a CPU
    torch.Generator; one seeded with `cfg.random_seed` if not given). Its
    forwards run under `full_float32`."""

    def __init__(self, cfg: Config, device: torch.device,
                 state: Optional[Mapping] = None,
                 gen: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.device = device
        k = cfg.keypoint_num
        self.encoder = PoseEncoderFC(k, POSE_Z, repeat_num=4, hidden_num=512)
        self.decoder = PoseDecoderFC(k, POSE_Z, repeat_num=4, hidden_num=512)
        self.nets = nn.ModuleDict({"G_Pose_Encoder": self.encoder,
                                   "G_Pose_Decoder": self.decoder})
        if state is None:
            init_weights(self.nets, gen if gen is not None else
                         torch.Generator().manual_seed(cfg.random_seed))
        else:
            self.nets.load_state_dict(state["PoseAE"], strict=True)
        self.nets.to(device).eval().requires_grad_(False)

    @full_float32()
    def encode(self, pose_rcv_norm_flat: torch.Tensor) -> torch.Tensor:
        """[B, K*3] normalized rcv -> z [B, POSE_Z]."""
        return self.encoder(pose_rcv_norm_flat)

    @full_float32()
    def decode_rcv(self, z: torch.Tensor) -> torch.Tensor:
        """z -> rcv [B, K, 3] (normalized coords, vis in {0, 1})."""
        coords, vis = self.decoder(z)
        return assemble_pose_rcv(coords, vis, self.cfg.keypoint_num)

    def autoencode(self, pose_rcv_norm_flat: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encode(pose_rcv_norm_flat)
        return self.decode_rcv(z), z

    def decode_pose(self, z: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z -> rcv + its radius-0 point map preview. The sampling testers
        use `decode_rcv`: they never read the preview."""
        cfg = self.cfg
        rcv = self.decode_rcv(z)
        return rcv, render_pose_maps(rcv, cfg.img_H, cfg.img_W,
                                     cfg.keypoint_num, radius=0,
                                     normalized=True)

    def train_step(self, *args, **kwargs):
        raise NotImplementedError(
            "the pose AE's train step (model 2) is not ported to "
            "dpig_tpu_torch yet (ROADMAP queue item 3)")
