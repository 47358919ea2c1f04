"""Stage-I pose autoencoder (port of `dpig_tpu/apps/stage1_pose.py`;
reference model 2 / 102, trainer.py:629-711 DPIG_PoseRCV_AE_BodyROI).

18x(row,col,vis) normalized to [-1,1] -> FC-res AE; loss = 20 * MSE;
Adam(b1=0.5); the visibility is decoded through the straight-through binary
round, whose gradient is the identity.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..models.layers import init_weights
from ..models.pose_ae import PoseDecoderFC, PoseEncoderFC, assemble_pose_rcv
from ..ops.pose import pose_rcv_normalize, render_pose_maps
from ..parallel import dist
from ..train.state import GanState
from .stage1_app import full_float32

POSE_Z = 32  # dpig_tpu/apps/stage2_pose.py:33


class Stage1PoseApp:
    """The pose AE's encoder and decoder on `device`, frozen until
    `init_state` makes them trainable: the sub-tree `PoseAE`
    (`G_Pose_Encoder` / `G_Pose_Decoder`) of `state` (a
    `bridge.params_from_flax` state or `checkpoint.restore_subtrees`
    result) if it holds one, else fresh (Xavier, from `gen`, a CPU
    torch.Generator; one seeded with `cfg.random_seed` if not given). Its
    forwards, and its train step with the backward pass and the update,
    run under `full_float32`."""

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
        if state and "PoseAE" in state:
            self.nets.load_state_dict(state["PoseAE"], strict=True)
        else:
            init_weights(self.nets, gen if gen is not None else
                         torch.Generator().manual_seed(cfg.random_seed))
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

    # --------------------------------------------------------------- train
    def init_state(self) -> GanState:
        """Make the AE trainable and wrap it with Adam(0.5, 0.999), no D
        (stage1_pose.py:30-46)."""
        cfg = self.cfg
        self.nets.requires_grad_(True)
        return GanState.create(g_nets={"PoseAE": self.nets}, mode="ae",
                               g_lr=cfg.g_lr,
                               lr_update_step=cfg.lr_update_step,
                               step=cfg.start_step)

    @full_float32()
    def train_step(self, state: GanState, batch: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One Adam update of the AE on 20 * MSE of the normalized rcv
        (stage1_pose.py:56-71), in place on `state` (from this app's
        `init_state`); state.step += 1. Across ranks the gradients are
        averaged and the losses are the global batch's."""
        cfg = self.cfg
        rcv_norm = pose_rcv_normalize(batch["pose_rcv"], cfg.img_H, cfg.img_W)
        recon, _ = self.autoencode(rcv_norm.reshape(rcv_norm.shape[0], -1))
        mse = torch.mean((rcv_norm - recon) ** 2)
        loss = mse * 20.0  # trainer.py:670
        state.g_opt.step(torch.autograd.grad(loss, state.g_params))
        state.step += 1
        return dist.global_metrics({"reconstruct_loss": mse.detach(),
                                    "loss": loss.detach()})
