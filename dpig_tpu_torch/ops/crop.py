"""Bilinear ROI crop with tf.image.crop_and_resize semantics (port of the
gather form, `dpig_tpu/ops/crop.py:28-117`).

The reference encoder crops 7 body-part ROIs per image, normalizing the
integer pixel bboxes by H/W (not H-1/W-1, models.py:292-296). For a crop
size > 1 the sample rows are
    in_y(i) = y1*(H-1) + i * (y2-y1)*(H-1)/(crop_h-1),
samples whose box coordinate falls outside the image read 0, and the ROIs
of all parts are stacked part-major into the batch axis (models.py:420).
Plain PyTorch gathers: the JAX package's matmul form exists to avoid TPU
gather stalls and computes the same values. As there, the interpolation
runs in float32 whatever the feature map's dtype, and the crops come back
in that dtype (`dpig_tpu/ops/crop.py:168,199`: a bfloat16 map is promoted
by the float32 weights and the result cast back); a float64 map (the
float64 check of `train/parity.py`) stays float64.
"""
from __future__ import annotations

import torch


def _axis_coords(lo: torch.Tensor, hi: torch.Tensor, size: int,
                 crop_size: int) -> torch.Tensor:
    """[N] normalized box edges -> [N, crop_size] sample coordinates."""
    if crop_size > 1:
        i = torch.arange(crop_size, dtype=torch.float32, device=lo.device)
        return lo[:, None] * (size - 1) + i[None, :] * (
            (hi - lo)[:, None] * (size - 1) / (crop_size - 1))
    return 0.5 * (lo + hi)[:, None] * (size - 1)


def _interp_dtype(feat: torch.Tensor) -> torch.dtype:
    return torch.promote_types(feat.dtype, torch.float32)


def _crop(feat: torch.Tensor, batch_idx: torch.Tensor, boxes: torch.Tensor,
          crop_h: int, crop_w: int) -> torch.Tensor:
    """Crop box n of `boxes` [N,4] from image batch_idx[n] of feat [B,H,W,C]."""
    _, h, w, _ = feat.shape
    boxes = boxes.to(torch.float32)
    ys = _axis_coords(boxes[:, 0], boxes[:, 2], h, crop_h)     # [N, ch]
    xs = _axis_coords(boxes[:, 1], boxes[:, 3], w, crop_w)     # [N, cw]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    n = boxes.shape[0]
    bi = batch_idx[:, None]

    def gather_rows(yi):                                        # [N,ch,W,C]
        valid = ((yi >= 0) & (yi < h)).to(feat.dtype)
        rows = feat[bi, yi.clamp(0, h - 1)]
        return rows * valid[:, :, None, None]

    rows = gather_rows(y0i) * (1.0 - wy) + gather_rows(y0i + 1) * wy
    ni = torch.arange(n, device=feat.device)[:, None, None]
    yy = torch.arange(crop_h, device=feat.device)[None, :, None]

    def gather_cols(xi):                                        # [N,ch,cw,C]
        valid = ((xi >= 0) & (xi < w)).to(feat.dtype)
        cols = rows[ni, yy, xi.clamp(0, w - 1)[:, None, :]]
        return cols * valid[:, None, :, None]

    out = gather_cols(x0i) * (1.0 - wx) + gather_cols(x0i + 1) * wx
    # TF zeroes samples whose *box coordinate* is outside the image.
    y_in = ((ys >= 0) & (ys <= h - 1)).to(feat.dtype)
    x_in = ((xs >= 0) & (xs <= w - 1)).to(feat.dtype)
    return out * y_in[:, :, None, None] * x_in[:, None, :, None]


def crop_and_resize(feat: torch.Tensor, boxes: torch.Tensor, crop_h: int,
                    crop_w: int) -> torch.Tensor:
    """feat [B,H,W,C], boxes [B,4] normalized (y1,x1,y2,x2), box i crops
    image i -> [B, crop_h, crop_w, C]."""
    idx = torch.arange(feat.shape[0], device=feat.device)
    return _crop(feat.to(_interp_dtype(feat)), idx, boxes, crop_h,
                 crop_w).to(feat.dtype)


def crop_body_rois(feat: torch.Tensor, part_bbox: torch.Tensor,
                   roi_size: int) -> torch.Tensor:
    """feat [B,H,W,C], part_bbox [B,P,4] integer pixel (y1,x1,y2,x2) ->
    [P*B, roi, roi, C], part-major (reference models.py:405-420). The
    feature map is indexed per box, never tiled P times."""
    b, h, w, _ = feat.shape
    p = part_bbox.shape[1]
    norm = torch.tensor([h, w, h, w], dtype=torch.float32, device=feat.device)
    boxes = part_bbox.to(torch.float32) / norm                  # [B,P,4]
    boxes = boxes.transpose(0, 1).reshape(p * b, 4)
    idx = torch.arange(b, device=feat.device).repeat(p)
    return _crop(feat.to(_interp_dtype(feat)), idx, boxes, roi_size,
                 roi_size).to(feat.dtype)
