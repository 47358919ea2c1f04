"""FC-residual pose autoencoder (port of `dpig_tpu/models/pose_ae.py:18-56`;
reference models.py:488-515).

Encoder: 54-dim normalized (r,c,v)*18 -> hidden 512, 4 res blocks -> z 32.
Decoder: z -> hidden (NO first activation, models.py:504), 4 res blocks ->
  coords head (K*2, linear) + visibility head (K, sigmoid -> STE round).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from ..ops.ste import binary_round
from .layers import Dense, FCResTrunk, leaky_relu


class PoseEncoderFC(nn.Module):
    def __init__(self, keypoint_num: int = 18, z_num: int = 32,
                 repeat_num: int = 4, hidden_num: int = 512,
                 activation: Callable = leaky_relu):
        super().__init__()
        self.FCResTrunk_0 = FCResTrunk(keypoint_num * 3, repeat_num,
                                       hidden_num, activation,
                                       first_activation=activation)
        self.Dense_0 = Dense(hidden_num, z_num)

    def forward(self, pose_rcv_flat: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(self.FCResTrunk_0(pose_rcv_flat))


class PoseDecoderFC(nn.Module):
    def __init__(self, keypoint_num: int = 18, z_num: int = 32,
                 repeat_num: int = 4, hidden_num: int = 512,
                 activation: Callable = leaky_relu):
        super().__init__()
        self.FCResTrunk_0 = FCResTrunk(z_num, repeat_num, hidden_num,
                                       activation, first_activation=None)
        self.coords = Dense(hidden_num, keypoint_num * 2)
        self.visible = Dense(hidden_num, keypoint_num)

    def forward(self, z: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """z [B, z_num] -> (coords [B, K*2], vis [B, K] in {0, 1})."""
        x = self.FCResTrunk_0(z)
        vis = binary_round(torch.sigmoid(self.visible(x)))
        return self.coords(x), vis


def assemble_pose_rcv(coords: torch.Tensor, vis: torch.Tensor,
                      keypoint_num: int = 18) -> torch.Tensor:
    """[B,K*2] coords + [B,K] vis -> [B,K,3] rcv (trainer.py:657)."""
    b = coords.shape[0]
    return torch.cat([coords.reshape(b, keypoint_num, 2), vis[..., None]],
                     dim=-1)
