"""U-net generator with FC bottleneck (port of
`dpig_tpu/models/generator.py:16-168`, reference models.py:518-576
GeneratorCNN_ID_UAEAfterResidual), on its `embs_const` path; and the
plain conv decoder that no app reaches (`:171-198`, models.py:252-273).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .encoders import tower_out_features
from .layers import (Conv, ConvBlockTower, Dense, conv2d_same,
                     flatten_nhwc, upscale_nn_nchw)


def _border_classes(n: int, device) -> torch.Tensor:
    """Per-position SAME-padding class of a 3x3 kernel along one axis:
    0 at the first position, 2 at the last, 1 inside."""
    cls = torch.ones(n, dtype=torch.int64, device=device)
    cls[-1] = 2
    cls[0] = 0
    return cls


def stem_bias_map_nhwc(kernel: torch.Tensor, bias: torch.Tensor,
                       embs: torch.Tensor, h: int, w: int,
                       dtype: torch.dtype = torch.float32,
                       sum_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Contribution of the spatially constant embedding to the stem conv,
    plus the conv bias (generator.py:35-77): [B, H, W, hid] in `dtype`.

    kernel is OIHW [hid, D+P, 3, 3]. A 3x3 SAME conv of a constant map sees
    one of 9 tap subsets at each pixel (3 row x 3 col border classes), so
    the embedding contributes 9 per-sample vectors selected by position.
    They are summed in float32 (`sum_dtype`) and rounded to `dtype`, and
    the bias added in `dtype`, as in JAX. The int8 stem
    (`models/quant.py`) adds this map in float32 to its s8 pose conv.
    """
    d = embs.shape[-1]
    k_emb = kernel[:, :d].to(sum_dtype)                      # [hid,D,3,3]
    taps = {0: slice(1, 3), 1: slice(0, 3), 2: slice(0, 2)}
    t = torch.stack([
        torch.stack([k_emb[:, :, taps[r], taps[c]].sum((2, 3))
                     for c in range(3)]) for r in range(3)])  # [3,3,hid,D]
    biases = torch.einsum("bd,rchd->brch", embs.to(sum_dtype), t).to(dtype)
    rows = _border_classes(h, embs.device)
    cols = _border_classes(w, embs.device)
    return biases[:, rows][:, :, cols] + bias.to(dtype)       # [B,H,W,hid]


def _constant_input_stem(kernel: torch.Tensor, bias: torch.Tensor,
                         embs: torch.Tensor, pose: torch.Tensor,
                         dtype: torch.dtype = torch.float32,
                         sum_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Stem conv of concat(tile(embs), pose) without the tiled map
    (generator.py:16-32), in `dtype`. pose is NCHW [B,P,H,W]; returns
    NCHW."""
    d = embs.shape[-1]
    pose_part = conv2d_same(pose.to(dtype), kernel[:, d:].to(dtype), None)
    return pose_part + stem_bias_map_nhwc(
        kernel, bias, embs, pose.shape[2], pose.shape[3],
        dtype, sum_dtype).permute(0, 3, 1, 2)


class UAEGenerator(nn.Module):
    """Encoder(skips) -> FC z bottleneck -> decoder with skip concat
    (generator.py:80-168), for a per-sample constant embedding input.

    Encoder stages hidden*(idx+1) with residual blocks and stride-2
    downsamples; bottleneck FC to z_num; FC back to (h_min, w_min, hidden);
    decoder stage idx concats [x, skip(repeat-1-idx)], runs two full-width
    convs with residual, then NN-upscale + 1x1 conv to
    hidden*(repeat-idx-1); a final 3x3 conv `to_rgb`. Every conv, Dense
    and the stem compute in `dtype` (flax's `dtype=`); the outputs are in
    it too.
    """

    def __init__(self, img_h: int, img_w: int, emb_dim: int, pose_ch: int,
                 out_channels: int = 3, z_num: int = 64, repeat_num: int = 5,
                 hidden_num: int = 128, activation: Callable = F.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.repeat_num = repeat_num
        self.hidden_num = hidden_num
        self.activation = activation
        self.dtype = dtype
        self.stem_sum_dtype = torch.float32  # float64 in a float64 check
        self.stem_kernel = nn.Parameter(
            torch.empty(hidden_num, emb_dim + pose_ch, 3, 3))
        self.stem_bias = nn.Parameter(torch.empty(hidden_num))
        self.ConvBlockTower_0 = ConvBlockTower(repeat_num, hidden_num,
                                               activation, collect_skips=True,
                                               dtype=dtype)
        flat = tower_out_features(img_h, img_w, repeat_num, hidden_num)
        self.h_min, self.w_min = img_h, img_w
        for _ in range(repeat_num - 1):
            self.h_min, self.w_min = -(-self.h_min // 2), -(-self.w_min // 2)
        self.bottleneck = Dense(flat, z_num, dtype=dtype)
        self.unbottleneck = Dense(z_num, self.h_min * self.w_min * hidden_num,
                                  dtype=dtype)
        i = 0
        x_ch = hidden_num
        for idx in range(repeat_num):
            ch = x_ch + hidden_num * (repeat_num - idx)
            self.add_module(f"Conv_{i}", Conv(ch, ch, 3, dtype=dtype))
            self.add_module(f"Conv_{i + 1}", Conv(ch, ch, 3, dtype=dtype))
            i += 2
            if idx < repeat_num - 1:
                x_ch = hidden_num * (repeat_num - idx - 1)
                self.add_module(f"Conv_{i}", Conv(ch, x_ch, 1, dtype=dtype))
                i += 1
        self.to_rgb = Conv(ch, out_channels, 3, dtype=dtype)

    def forward(self, embs: torch.Tensor, pose: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """embs [B, D], pose [B, H, W, P] (NHWC) -> (out [B, H, W, 3], z)."""
        act = self.activation
        x = act(_constant_input_stem(self.stem_kernel, self.stem_bias, embs,
                                     pose.permute(0, 3, 1, 2), self.dtype,
                                     self.stem_sum_dtype))
        x, skips = self.ConvBlockTower_0(x)
        b = x.shape[0]
        z = self.bottleneck(flatten_nhwc(x))
        x = self.unbottleneck(z).reshape(b, self.h_min, self.w_min,
                                         self.hidden_num).permute(0, 3, 1, 2)
        convs = iter(getattr(self, f"Conv_{i}")
                     for i in range(3 * self.repeat_num - 1))
        for idx in range(self.repeat_num):
            x = torch.cat([x, skips[self.repeat_num - 1 - idx]], dim=1)
            res = x
            x = act(next(convs)(x))
            x = act(next(convs)(x))
            x = x + res
            if idx < self.repeat_num - 1:
                x = act(next(convs)(upscale_nn_nchw(x)))
        out = self.to_rgb(x)
        return out.permute(0, 2, 3, 1), z


class PlainDecoder(nn.Module):
    """Conv decoder (generator.py:171-198; models.py:252-273
    GeneratorCNN_ID_Decoder): `Dense_0` and `activation` (ReLU) to
    (H/2^(R-1), W/2^(R-1), hidden R), then for idx in [0, R): two 3x3
    convs at hidden (R - idx) with a residual add, and between stages an
    NN upscale and a 1x1 conv to hidden (R - idx - 1), each conv through
    `activation`; a last 3x3 conv to `out_channels` -> [B, H, W, C]. The
    convs are `Conv_0`.. in call order."""

    def __init__(self, z_dim: int, out_h: int = 128, out_w: int = 64,
                 out_channels: int = 3, repeat_num: int = 5,
                 hidden_num: int = 128, activation: Callable = F.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.repeat_num = repeat_num
        self.activation = activation
        self.in_h = out_h // (2 ** (repeat_num - 1))
        self.in_w = out_w // (2 ** (repeat_num - 1))
        self.in_ch = hidden_num * repeat_num
        self.Dense_0 = Dense(z_dim, self.in_h * self.in_w * self.in_ch,
                             dtype=dtype)
        i = 0
        for idx in range(repeat_num):
            ch = hidden_num * (repeat_num - idx)
            self.add_module(f"Conv_{i}", Conv(ch, ch, 3, dtype=dtype))
            self.add_module(f"Conv_{i + 1}", Conv(ch, ch, 3, dtype=dtype))
            i += 2
            if idx < repeat_num - 1:
                self.add_module(f"Conv_{i}", Conv(
                    ch, hidden_num * (repeat_num - idx - 1), 1, dtype=dtype))
                i += 1
        self.add_module(f"Conv_{i}", Conv(ch, out_channels, 3, dtype=dtype))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, z_dim] -> [B, H, W, out_channels] (NHWC)."""
        act = self.activation
        x = act(self.Dense_0(z)).reshape(-1, self.in_h, self.in_w,
                                         self.in_ch).permute(0, 3, 1, 2)
        convs = iter(getattr(self, f"Conv_{i}")
                     for i in range(3 * self.repeat_num))
        for idx in range(self.repeat_num):
            res = x
            x = act(next(convs)(x))
            x = res + act(next(convs)(x))
            if idx < self.repeat_num - 1:
                x = act(next(convs)(upscale_nn_nchw(x)))
        return next(convs)(x).permute(0, 2, 3, 1)
