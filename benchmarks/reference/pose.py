"""Plain reference of the pose map: channel k is +1 on the disc of radius
r around keypoint k and -1 elsewhere. A keypoint is drawn when its
visibility is > 0 and its pixel coordinates, truncated toward zero as
`tf.to_int32` does, lie in the image; a pixel (i, j) is on the disc when
(i - row)^2 + (j - col)^2 <= r^2 (the closed form of the published
scatter-and-inflate)."""
from __future__ import annotations

import torch


def render_pose_maps(rcv: torch.Tensor, img_h: int, img_w: int,
                     keypoints: int = 18, radius: int = 4) -> torch.Tensor:
    """rcv [B, K, 3] or [B, 3K] pixel (row, col, visibility) -> maps
    [B, H, W, K] float32 in {-1, +1}."""
    b = rcv.shape[0]
    rcv = rcv.reshape(b, keypoints, 3).to(torch.float32)
    row = torch.trunc(rcv[..., 0]).long()
    col = torch.trunc(rcv[..., 1]).long()
    drawn = ((rcv[..., 2] > 0) & (row >= 0) & (row < img_h)
             & (col >= 0) & (col < img_w))                      # [B, K]
    i = torch.arange(img_h, device=rcv.device)[None, :, None, None]
    j = torch.arange(img_w, device=rcv.device)[None, None, :, None]
    d2 = (i - row[:, None, None, :]) ** 2 + (j - col[:, None, None, :]) ** 2
    on = (d2 <= radius * radius) & drawn[:, None, None, :]
    return torch.where(on, 1.0, -1.0).to(torch.float32)
