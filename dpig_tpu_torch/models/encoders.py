"""Appearance encoders (port of `dpig_tpu/models/encoders.py`): the FG/BG
two-branch ROI encoder of the Market Stage I (reference models.py:
390-471), the single-branch ROI encoder of the DeepFashion 256x256
family (models.py:275-325), and the plain conv encoder and
`tile_embedding` that no app reaches (models.py:224-250,
trainer.py:588-590).

The P per-part crops are folded into the batch axis ([P*B, C, roi, roi])
so the weight-shared ROI tower runs as one conv stack. `dtype` is the
compute dtype of every conv and Dense (flax's `dtype=`); the output is in
it too.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.crop import crop_body_rois
from ..ops.ste import bernoulli_sample
from .layers import Conv, ConvBlockTower, Dense, flatten_nhwc


class _Stem(nn.Module):
    """Stem conv + one res block (encoders.py:27-43; models.py:396-400)."""

    def __init__(self, in_ch: int, hidden_num: int,
                 activation: Callable = F.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.Conv_0 = Conv(in_ch, hidden_num, 3, dtype=dtype)
        self.Conv_1 = Conv(hidden_num, hidden_num, 3, dtype=dtype)
        self.Conv_2 = Conv(hidden_num, hidden_num, 3, dtype=dtype)

    def forward(self, x):
        act = self.activation
        x = act(self.Conv_0(x))
        res = x
        x = act(self.Conv_1(x))
        x = act(self.Conv_2(x))
        return x + res


def tower_out_features(h: int, w: int, repeat_num: int,
                       hidden_num: int) -> int:
    """Flattened size after a ConvBlockTower: repeat-1 SAME stride-2 convs."""
    for _ in range(repeat_num - 1):
        h, w = -(-h // 2), -(-w // 2)
    return h * w * hidden_num * repeat_num


class _RoiTower(nn.Module):
    """Weight-shared tower over stacked ROIs -> per-part z
    (encoders.py:46-59; models.py:420-431)."""

    def __init__(self, z_num: int, repeat_num: int, hidden_num: int,
                 roi_size: int, activation: Callable = F.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBlockTower_0 = ConvBlockTower(repeat_num, hidden_num,
                                               activation, dtype=dtype)
        self.Dense_0 = Dense(tower_out_features(roi_size, roi_size,
                                                repeat_num, hidden_num), z_num,
                             dtype=dtype)

    def forward(self, rois):  # [P*B, C, roi, roi]
        return self.Dense_0(flatten_nhwc(self.ConvBlockTower_0(rois)))


def _apply_vis(fea: torch.Tensor, part_vis: torch.Tensor, part_num: int,
               keep_part_prob: float = 1.0,
               part_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Visibility zeroing (encoders.py:62-80; models.py:433-442), then, if
    keep_part_prob < 1 and the uniforms `part_noise` [P, B, 1] are given,
    Bernoulli part dropout with a straight-through gradient
    (models.py:443-451): each part of each sample kept with probability
    keep_part_prob. The JAX package draws the uniforms from its rng
    (`rng=`), the port takes them as a tensor (`ops.ste.uniform_noise`);
    without them, as without JAX's rng, nothing is dropped (Stage I
    passes none, so models 1 and 101 never drop a part).
    fea [P*B, z] part-major; part_vis [B, P]. Returns [B, P*z]."""
    pb, z = fea.shape
    b = pb // part_num
    fea = fea.reshape(part_num, b, z)
    fea = fea * part_vis.to(fea.dtype).t()[:, :, None]
    if keep_part_prob < 1.0 and part_noise is not None:
        probs = torch.full((part_num, b, 1), keep_part_prob,
                           dtype=fea.dtype, device=fea.device)
        fea = fea * bernoulli_sample(probs, part_noise)
    return fea.transpose(0, 1).reshape(b, part_num * z)


class RoiEncoder(nn.Module):
    """Single-branch 7-part ROI encoder (encoders.py:83-104): the stem,
    the P crops of the unmasked feature map, the shared tower, visibility
    zeroing, part dropout (`_apply_vis`). Output: [B, part_num*z] (224
    dims for z=32, P=7). Its submodules carry flax's auto-names
    (`_Stem_0`, `_RoiTower_0`)."""

    def __init__(self, part_num: int = 7, z_num: int = 32,
                 repeat_num: int = 5, hidden_num: int = 128,
                 roi_size: int = 48, activation: Callable = F.relu,
                 in_ch: int = 3, dtype: torch.dtype = torch.float32,
                 keep_part_prob: float = 1.0):
        super().__init__()
        self.part_num = part_num
        self.roi_size = roi_size
        self.keep_part_prob = keep_part_prob
        self._Stem_0 = _Stem(in_ch, hidden_num, activation, dtype)
        self._RoiTower_0 = _RoiTower(z_num, repeat_num, hidden_num, roi_size,
                                     activation, dtype)

    def forward(self, x, part_bbox, part_vis, part_noise=None):
        """x [B,H,W,3] (NHWC), part_bbox [B,P,4] int, part_vis [B,P],
        part_noise [P,B,1] uniforms (part dropout) -> [B, P*z]."""
        x = self._Stem_0(x.permute(0, 3, 1, 2))
        rois = crop_body_rois(x.permute(0, 2, 3, 1), part_bbox,
                              self.roi_size)                  # [P*B,r,r,C]
        fea = self._RoiTower_0(rois.permute(0, 3, 1, 2))
        return _apply_vis(fea, part_vis, self.part_num, self.keep_part_prob,
                          part_noise)


class RoiEncoderFgBg(nn.Module):
    """FG/BG two-branch ROI encoder (encoders.py:107-142).

    FG: feature map masked by fg_mask, 7 ROI crops -> shared tower -> 7*z,
    visibility zeroing and part dropout (`_apply_vis`).
    BG: feature map masked by (1-fg_mask) -> own tower -> 4*z code.
    Output: [B, part_num*z + 4*z] (352 dims for z=32, P=7).
    """

    def __init__(self, img_h: int, img_w: int, part_num: int = 7,
                 z_num: int = 32, repeat_num: int = 5, hidden_num: int = 128,
                 roi_size: int = 48, activation: Callable = F.relu,
                 in_ch: int = 3, dtype: torch.dtype = torch.float32,
                 keep_part_prob: float = 1.0):
        super().__init__()
        self.part_num = part_num
        self.roi_size = roi_size
        self.keep_part_prob = keep_part_prob
        self._Stem_0 = _Stem(in_ch, hidden_num, activation, dtype)
        self.fg_tower = _RoiTower(z_num, repeat_num, hidden_num, roi_size,
                                  activation, dtype)
        self.bg_tower = ConvBlockTower(repeat_num, hidden_num, activation,
                                       dtype=dtype)
        self.bg_fc = Dense(tower_out_features(img_h, img_w, repeat_num,
                                              hidden_num), z_num * 4,
                           dtype=dtype)

    def forward(self, x, fg_mask, part_bbox, part_vis, part_noise=None):
        """x [B,H,W,3], fg_mask [B,H,W,1] (NHWC), part_bbox [B,P,4] int,
        part_vis [B,P], part_noise [P,B,1] uniforms (part dropout of the FG
        parts, `_apply_vis`) -> [B, P*z + 4*z]."""
        x = self._Stem_0(x.permute(0, 3, 1, 2))
        m = fg_mask.permute(0, 3, 1, 2).to(x.dtype)
        x_fg = x * m
        x_bg = x * (1.0 - m)

        rois = crop_body_rois(x_fg.permute(0, 2, 3, 1), part_bbox,
                              self.roi_size)                  # [P*B,r,r,C]
        fea = self.fg_tower(rois.permute(0, 3, 1, 2))
        fg = _apply_vis(fea, part_vis, self.part_num, self.keep_part_prob,
                        part_noise)

        bg = self.bg_fc(flatten_nhwc(self.bg_tower(x_bg)))
        return torch.cat([fg, bg], dim=-1)


class PlainEncoder(nn.Module):
    """Plain conv encoder (encoders.py:145-162; models.py:224-250
    GeneratorCNN_ID_Encoder): the image and, if given, the pose maps
    concatenated on the channels (`in_ch` counts both), a 3x3 `Conv_0`
    and `activation` (ELU), `ConvBlockTower_0`, the NHWC flatten and
    `Dense_0` -> [B, z_num]."""

    def __init__(self, img_h: int, img_w: int, in_ch: int = 3,
                 z_num: int = 64, repeat_num: int = 5, hidden_num: int = 128,
                 activation: Callable = F.elu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.Conv_0 = Conv(in_ch, hidden_num, 3, dtype=dtype)
        self.ConvBlockTower_0 = ConvBlockTower(repeat_num, hidden_num,
                                               activation, dtype=dtype)
        self.Dense_0 = Dense(tower_out_features(img_h, img_w, repeat_num,
                                                hidden_num), z_num,
                             dtype=dtype)

    def forward(self, x: torch.Tensor,
                pose: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, W, 3], pose [B, H, W, P] or None (NHWC) -> [B, z]."""
        if pose is not None:
            x = torch.cat([x, pose.to(x.dtype)], dim=-1)
        x = self.activation(self.Conv_0(x.permute(0, 3, 1, 2)))
        return self.Dense_0(flatten_nhwc(self.ConvBlockTower_0(x)))


def tile_embedding(embs: torch.Tensor, img_h: int,
                   img_w: int) -> torch.Tensor:
    """A [B, D] embedding broadcast to an NHWC [B, H, W, D] map
    (encoders.py:165-172; trainer.py:588-590), a view."""
    return embs[:, None, None, :].expand(embs.shape[0], img_h, img_w,
                                         embs.shape[-1])
