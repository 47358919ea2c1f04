"""Auxiliary generator zoo and norm / residual blocks (port of
`dpig_tpu/models/zoo.py`): the reference pieces that no dispatched model
reaches, the igul222 WGAN demo generators (wgan_gp.py:119-343) and the
helper blocks of models.py:134-221.

The blocks (`InstanceNorm`, `ResBlock`, `ResBottleneckBlock`,
`ConvBnLeakyReLU`, `SubpixelConv`, `WGANResidualBlock`) take and return
NCHW tensors, as `layers.py`'s do; the generators take the noise [B, z]
and return NHWC images ([B, out_dim] for `FCGenerator`). Each module
takes the input channels its flax twin infers (`in_ch`), computes in
`dtype`, and carries flax's submodule names (`Conv_0`.., `BatchNorm_0`,
`Dense_0`, `fc0`.., `shortcut`, `conv1`, `conv1b`, `conv2`,
`WGANResidualBlock_0`..), so `bridge.params_from_flax` loads a JAX tree
strictly. `train` / `update_stats` are BatchNorm's (`layers.BatchNorm`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (D_INIT, BatchNorm, Conv, Dense, LayerNorm, leaky_relu,
                     upscale_nn_nchw)


def pixcnn_gated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gated multiplicative nonlinearity (wgan_gp.py:42-43)."""
    return torch.sigmoid(a) * torch.tanh(b)


class FCGenerator(nn.Module):
    """512-wide 4-layer ReLU MLP G (wgan_gp.py:144-156): `fc0`..`fc3`,
    `out`, tanh -> [B, out_dim]."""

    def __init__(self, z_dim: int = 128, out_dim: int = 128 * 64 * 3,
                 fc_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(f"fc{i}", Dense(z_dim if i == 0 else fc_dim,
                                            fc_dim, init=D_INIT,
                                            dtype=dtype))
        self.out = Dense(fc_dim, out_dim, init=D_INIT, dtype=dtype)

    def forward(self, noise: torch.Tensor) -> torch.Tensor:
        x = noise
        for i in range(4):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return torch.tanh(self.out(x))


class DCGANGenerator(nn.Module):
    """4x-upsampling DCGAN G (wgan_gp.py:158-200 shape recipe): `Dense_0`
    to (H/16, W/16, 8 dim), then 4 x [`BatchNorm_i`, ReLU, NN upscale,
    5x5 `Conv_i` to max(ch, dim/2) with ch halving from 8 dim], then a 5x5
    `Conv_4` to `out_channels` and tanh -> [B, H, W, C]."""

    def __init__(self, z_dim: int = 128, out_h: int = 64, out_w: int = 64,
                 out_channels: int = 3, dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.h0, self.w0, self.ch0 = out_h // 16, out_w // 16, 8 * dim
        self.Dense_0 = Dense(z_dim, self.h0 * self.w0 * self.ch0,
                             init=D_INIT, dtype=dtype)
        ch = ch_in = self.ch0
        for i in range(4):
            self.add_module(f"BatchNorm_{i}", BatchNorm(ch_in, dtype=dtype))
            ch //= 2
            self.add_module(f"Conv_{i}", Conv(ch_in, max(ch, dim // 2), 5,
                                              init=D_INIT, dtype=dtype))
            ch_in = max(ch, dim // 2)
        self.Conv_4 = Conv(ch_in, out_channels, 5, init=D_INIT, dtype=dtype)

    def forward(self, noise: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        x = self.Dense_0(noise).reshape(-1, self.h0, self.w0, self.ch0)
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = getattr(self, f"BatchNorm_{i}")(x, train, update_stats)
            x = getattr(self, f"Conv_{i}")(upscale_nn_nchw(F.relu(x)))
        return torch.tanh(self.Conv_4(x)).permute(0, 2, 3, 1)


class InstanceNorm(LayerNorm):
    """models.py:154-166 Instance_norm: per sample and channel over H and
    W, the population variance (two passes, as `jnp.var`), epsilon 1e-3,
    (x - mu) / sqrt(var + eps) * scale + shift. flax's `scale` / `shift`
    are `weight` / `bias` here (`bridge.py`); in x's dtype, at least
    float32, as JAX promotes it against its float32 parameters (its
    `dtype`, as the JAX twin's, is not read)."""

    def __init__(self, num_features: int, eps: float = 1e-3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mu = x.mean((2, 3), keepdim=True)
        var = ((x - mu) ** 2).mean((2, 3), keepdim=True)
        normalized = (x - mu) / torch.sqrt(var + self.eps)
        return (self.weight[:, None, None] * normalized
                + self.bias[:, None, None])


class ResBlock(nn.Module):
    """models.py:180-188: two 3x3 convs and a shortcut, 1x1-projected when
    the channels differ (flax's `Conv_0` is then the projection), the sum
    through `activation` (LeakyReLU 0.3)."""

    def __init__(self, in_ch: int, n2: int, n3: int,
                 activation: Callable = leaky_relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.activation = activation
        self.project = in_ch != n3
        sizes = self._branch(in_ch, n2, n3)
        if self.project:
            sizes.insert(0, (in_ch, n3, 1))
        for i, (ci, co, k) in enumerate(sizes):
            self.add_module(f"Conv_{i}", Conv(ci, co, k, dtype=dtype))

    @staticmethod
    def _branch(in_ch, n2, n3):
        return [(in_ch, n2, 3), (n2, n3, 3)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self.activation
        convs = list(self.children())
        shortcut = convs.pop(0)(x) if self.project else x
        for conv in convs[:-1]:
            x = act(conv(x))
        return act(shortcut + convs[-1](x))


class ResBottleneckBlock(ResBlock):
    """models.py:169-178: 1x1 -> 3x3 -> 1x1 bottleneck and a shortcut,
    1x1-projected when the channels differ (`Conv_0` then)."""

    @staticmethod
    def _branch(in_ch, n2, n3):
        return [(in_ch, n2, 1), (n2, n2, 3), (n2, n3, 1)]


class ConvBnLeakyReLU(nn.Module):
    """models.py:216-220: `Conv_0` (k x k, stride, XLA's SAME padding),
    `BatchNorm_0`, LeakyReLU(alpha)."""

    def __init__(self, in_ch: int, out_channel: int, kernel_size: int = 3,
                 stride: int = 1, alpha: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.alpha = alpha
        self.Conv_0 = Conv(in_ch, out_channel, kernel_size, stride=stride,
                           dtype=dtype)
        self.BatchNorm_0 = BatchNorm(out_channel, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x), train, update_stats)
        return leaky_relu(x, self.alpha)


class SubpixelConv(nn.Module):
    """`Conv_0` to 4 C channels, then a 2x pixel shuffle (wgan_gp.py:45-51
    SubpixelConv2D) in the JAX package's NHWC order: the 4 C channels are
    (row offset, column offset, C), channel (2 a + b) C + c going to pixel
    (2 h + a, 2 w + b). `F.pixel_shuffle` reads them as (C, a, b)."""

    def __init__(self, in_ch: int, out_channels: int, kernel: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, 4 * out_channels, kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        b, c4, h, w = x.shape
        c = c4 // 4
        x = x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c, 2 * h, 2 * w)


class WGANResidualBlock(nn.Module):
    """1-3-1 bottleneck residual block, the branch scaled by 0.3 after a
    BatchNorm, with up / down resampling (wgan_gp.py:53-93 ResidualBlock).
    `resample` None keeps the size, 'down' halves it (the 3x3 `conv1b` at
    stride 2 with XLA's asymmetric SAME padding, a 1x1 stride-2
    `shortcut`), 'up' doubles it (NN upscale before `conv1b`, a
    `SubpixelConv` shortcut, `shortcut.Conv_0`). The shortcut is the
    input itself when nothing changes. `conv2` (1x1) has no bias and
    feeds `BatchNorm_0` (momentum 0.9)."""

    def __init__(self, in_ch: int, out_channels: int, filter_size: int = 3,
                 resample: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if resample not in (None, "down", "up"):
            raise ValueError(f"resample must be None, 'down' or 'up', got "
                             f"{resample!r}")
        self.resample = resample
        mid_in, mid_out = in_ch // 2, out_channels // 2
        if resample == "up":
            self.shortcut = SubpixelConv(in_ch, out_channels, 1, dtype=dtype)
        elif resample == "down" or in_ch != out_channels:
            self.shortcut = Conv(in_ch, out_channels, 1,
                                 stride=2 if resample == "down" else 1,
                                 dtype=dtype)
        else:
            self.shortcut = None
        self.conv1 = Conv(in_ch, mid_in, 1, dtype=dtype)
        self.conv1b = Conv(mid_in, mid_out, filter_size,
                           stride=2 if resample == "down" else 1,
                           dtype=dtype)
        self.conv2 = Conv(mid_out, out_channels, 1, dtype=dtype, bias=False)
        self.BatchNorm_0 = BatchNorm(out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(F.relu(x)))
        if self.resample == "up":
            y = upscale_nn_nchw(y)
        y = self.conv2(F.relu(self.conv1b(y)))
        y = self.BatchNorm_0(y, train, update_stats)
        return shortcut + 0.3 * y


class ResnetGenerator(nn.Module):
    """Deep resnet G (wgan_gp.py:230-257): `Dense_0` to (H/16, W/16,
    8 dim), 4 scales of `blocks_per_scale` blocks and an up-sampling block
    halving the channels, `blocks_per_scale - 1` more blocks, a 1x1
    `Conv_0` and tanh(x / 5) -> [B, H, W, C]. The blocks are
    `WGANResidualBlock_0`.. in call order."""

    def __init__(self, z_dim: int = 128, out_h: int = 128, out_w: int = 64,
                 out_channels: int = 3, dim: int = 64,
                 blocks_per_scale: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.h0, self.w0, self.ch0 = out_h // 16, out_w // 16, 8 * dim
        ch = self.ch0
        self.Dense_0 = Dense(z_dim, self.h0 * self.w0 * ch, dtype=dtype)
        blocks = []
        for _ in range(4):
            blocks += [(ch, ch, None)] * blocks_per_scale
            blocks.append((ch, ch // 2, "up"))
            ch //= 2
        blocks += [(ch, ch, None)] * (blocks_per_scale - 1)
        self.n_blocks = len(blocks)
        for i, (ci, co, resample) in enumerate(blocks):
            self.add_module(f"WGANResidualBlock_{i}", WGANResidualBlock(
                ci, co, 3, resample, dtype=dtype))
        self.Conv_0 = Conv(ch, out_channels, 1, dtype=dtype)

    def forward(self, noise: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        x = self.Dense_0(noise).reshape(-1, self.h0, self.w0, self.ch0)
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"WGANResidualBlock_{i}")(x, train,
                                                        update_stats)
        return torch.tanh(self.Conv_0(x) / 5.0).permute(0, 2, 3, 1)
