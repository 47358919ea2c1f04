"""Pose-keypoint rendering ops (port of `dpig_tpu/ops/pose.py:22-121`).

Channel k of a pose map is +1 on the radius-r Euclidean disc around
keypoint k (if visible and in bounds) and -1 elsewhere, the closed form of
the reference's scatter + 29-term inflate (utils.py:237-346).

`render_pose_maps` is the one entry point: a tensor on the card goes to
the CUDA kernel (`kernels/pose_raster.py`), a tensor on the CPU to
`render_pose_maps_plain`, which repeats the JAX float32 operation order
so that both agree bit for bit.
"""
from __future__ import annotations

import torch


def pose_rcv_denormalize(rcv: torch.Tensor, img_h: int,
                         img_w: int) -> torch.Tensor:
    """[-1,1]-normalized (row,col) -> clipped pixel coords
    (pose.py:22-32; reference utils.py:249-254). rcv: [..., K, 3]."""
    r = (rcv[..., 0] + 1.0) / 2.0 * img_h
    c = (rcv[..., 1] + 1.0) / 2.0 * img_w
    r = torch.clamp(r, 0.0, img_h - 1.0)
    c = torch.clamp(c, 0.0, img_w - 1.0)
    return torch.stack([r, c, rcv[..., 2]], dim=-1)


def pose_rcv_normalize(rcv: torch.Tensor, img_h: int,
                       img_w: int) -> torch.Tensor:
    """Pixel (row,col,vis) -> ([-1,1] row, [-1,1] col, vis)
    (pose.py:35-44; reference trainer.py:642-646)."""
    rcv = rcv.to(torch.float32)
    r = rcv[..., 0] / float(img_h) * 2.0 - 1.0
    c = rcv[..., 1] / float(img_w) * 2.0 - 1.0
    return torch.stack([r, c, rcv[..., 2]], dim=-1)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: NaN -> 0, out-of-range values
    saturate (torch's own cast is undefined there; on the CPU it gives
    INT_MIN for NaN). The upper clamp is the largest float32 below 2^31."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, -2.0 ** 31, 2.0 ** 31 - 128.0).to(torch.int32)


def render_pose_maps_plain(rcv: torch.Tensor, img_h: int, img_w: int,
                           keypoint_num: int = 18, radius: int = 4,
                           normalized: bool = False) -> torch.Tensor:
    """Plain PyTorch rasterizer (pose.py:47-93), any device.

    rcv: [B, K*3] or [B, K, 3] (row, col, visibility). Returns
    [B, img_h, img_w, K] float32 in {-1, +1}.
    """
    b = rcv.shape[0]
    rcv = rcv.reshape(b, keypoint_num, 3).to(torch.float32)
    if normalized:
        rcv = pose_rcv_denormalize(rcv, img_h, img_w)
        r = _to_int32(torch.floor(rcv[..., 0]))
        c = _to_int32(torch.floor(rcv[..., 1]))
        in_bounds = torch.ones_like(r, dtype=torch.bool)
    else:
        # Raw pixel coords truncate toward zero (tf.to_int32) and the
        # reference scatter drops out-of-range keypoints.
        r = _to_int32(torch.trunc(rcv[..., 0]))
        c = _to_int32(torch.trunc(rcv[..., 1]))
        in_bounds = (r >= 0) & (r < img_h) & (c >= 0) & (c < img_w)
    vis = (rcv[..., 2] > 0.0) & in_bounds                      # [B, K]

    rows = torch.arange(img_h, dtype=torch.int32, device=rcv.device)
    cols = torch.arange(img_w, dtype=torch.int32, device=rcv.device)
    dr = rows[None, :, None, None] - r[:, None, None, :]       # [B,H,1,K]
    dc = cols[None, None, :, None] - c[:, None, None, :]       # [B,1,W,K]
    on = (dr * dr + dc * dc <= radius * radius) & vis[:, None, None, :]
    return on.to(torch.float32) * 2.0 - 1.0


def render_pose_maps(rcv: torch.Tensor, img_h: int, img_w: int,
                     keypoint_num: int = 18, radius: int = 4,
                     normalized: bool = False) -> torch.Tensor:
    """Fused keypoint -> inflated disc maps, [B, img_h, img_w, K] in {-1,+1}.

    A CUDA tensor launches the hand kernel (or raises); a CPU tensor takes
    the plain version. `normalized`: coords in [-1,1] (decoded poses) vs
    raw pixels (data).
    """
    if rcv.is_cuda:
        from ..kernels.pose_raster import render_pose_maps_cuda
        return render_pose_maps_cuda(rcv.contiguous(), img_h, img_w,
                                     keypoint_num, radius, normalized)
    return render_pose_maps_plain(rcv, img_h, img_w, keypoint_num, radius,
                                  normalized)


def floor_margin(rcv: torch.Tensor, img_h: int, img_w: int) -> float:
    """Smallest distance, in pixels, from a visible normalized keypoint's
    denormalized row or column to a value where its floor changes.
    `render_pose_maps(..., normalized=True)` clips to [0, size-1] and
    floors, so that happens at the integers 1 .. size-1, and a whole disc
    moves there; two devices whose decoded rcv differ by ~1e-6 give the
    same maps where this margin is wider than that."""
    rcv = rcv.reshape(rcv.shape[0], -1, 3).to(torch.float32)
    margins = []
    for axis, size in ((0, img_h), (1, img_w)):
        p = (rcv[..., axis] + 1.0) / 2.0 * size  # pose_rcv_denormalize
        d = (p - torch.clamp(torch.round(p), 1.0, size - 1.0)).abs()
        margins.append(torch.where(rcv[..., 2] > 0.0, d,
                                   torch.full_like(d, float("inf"))))
    return float(torch.stack(margins).min())


def render_pose_points(rcv: torch.Tensor, img_h: int, img_w: int,
                       keypoint_num: int = 18,
                       normalized: bool = True) -> torch.Tensor:
    """Single-pixel channel maps (pose.py:96-110): radius 0."""
    return render_pose_maps(rcv, img_h, img_w, keypoint_num, radius=0,
                            normalized=normalized)


def pose_maps_to_image(pose_maps: torch.Tensor) -> torch.Tensor:
    """K channels -> displayable 3-channel [0,255] image (pose.py:113-121;
    reference trainer.py:659)."""
    m = pose_maps.amax(dim=-1, keepdim=True).expand(*pose_maps.shape[:-1], 3)
    return torch.clamp((m + 1.0) * 127.5, 0.0, 255.0)
