"""Discriminators (port of `dpig_tpu/models/discriminators.py:23-147`),
in the 'dcgan' GAN mode, the one Stage I uses (BatchNorm where the JAX
package puts a norm; its 'wgan-gp' LayerNorm variant is built by no app).

  * DCGANDiscriminator (reference wgan_gp.py:407-440): 5x5/2 conv stack,
    BatchNorm from the second stage on, LeakyReLU 0.3, a linear logit over
    the NHWC-flattened features -> [B]. In float32 on the card its convs
    run PyTorch's own kernels, not cuDNN's (`Conv(cudnn=False)`): cuDNN's
    float32 backward of Conv_1 at batch 2 went wrong in some process
    states (ROADMAP §3).
  * FCDiscriminator (wgan_gp.py:399-405): the LeakyReLU MLP critic of the
    Stage-II samplers, in embedding space; as `--D_arch=FCDis` it scores
    every pixel of an image (a Dense acts on the last axis) -> [B*H*W].
  * RegionDiscriminator (wgan_gp.py:513-546, `--D_arch=DCGANRegion*`):
    three 5x5/2 convs, then a 5x5/1 conv to a 1-channel score map
    [B, H/8, W/8].
  * PatchDiscriminator (wgan_gp.py:549-576, `--D_arch=Patch*`): pix2pix
    4x4 VALID convs after a reflect pad of 1 -> a 1-channel logit map.

Every image D takes NHWC images and returns its logits in the compute
dtype; `train` / `update_stats` are BatchNorm's (see DCGANDiscriminator).
Submodules carry flax's names (`Conv_0`.., `BatchNorm_0`.., `logit`;
`input`, `h0`.., `out`), so `bridge.params_from_flax` maps a JAX
checkpoint of each one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import D_INIT, BatchNorm, Conv, Dense, flatten_nhwc, leaky_relu


class DCGANDiscriminator(nn.Module):

    def __init__(self, img_h: int, img_w: int, dim: int = 64,
                 n_stages: int = 4, in_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_stages = n_stages
        ch_in, ch, h, w = in_ch, dim, img_h, img_w
        for stage in range(n_stages):
            self.add_module(f"Conv_{stage}", Conv(ch_in, ch, 5, stride=2,
                                                  init=D_INIT, dtype=dtype,
                                                  cudnn=False))
            if stage > 0:
                self.add_module(f"BatchNorm_{stage - 1}",
                                BatchNorm(ch, dtype=dtype))
            h, w = -(-h // 2), -(-w // 2)
            ch_in = ch
            if stage < n_stages - 1:
                ch = min(ch * 2, dim * 8)
        self.logit = Dense(h * w * ch_in, 1, init=D_INIT, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        """x [B, H, W, 3] NHWC -> logits [B] in the compute dtype (flax's
        `dtype=`, bfloat16 with `--compute_dtype=bfloat16`). `train=True` (what the
        testers and the G step use) normalizes by batch statistics and
        updates nothing; `update_stats=True` (the D step) also moves each
        BatchNorm's running statistics, as flax's mutable apply does."""
        x = x.permute(0, 3, 1, 2)
        for stage in range(self.n_stages):
            x = getattr(self, f"Conv_{stage}")(x)
            if stage > 0:
                x = getattr(self, f"BatchNorm_{stage - 1}")(x, train,
                                                            update_stats)
            x = leaky_relu(x)
        return self.logit(flatten_nhwc(x)).reshape(-1)


class FCDiscriminator(nn.Module):
    """Dense `input` -> leaky, `h0`..`h{n-1}` -> leaky, `out` -> logits
    flattened (`reshape(-1)`); the flax names, normal(0.02) weights. It has
    no BatchNorm: `train` and `update_stats` are accepted and unused, so
    it can stand where an image D does."""

    def __init__(self, in_dim: int, fc_dim: int = 512, n_layers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.input = Dense(in_dim, fc_dim, init=D_INIT, dtype=dtype)
        for i in range(n_layers):
            self.add_module(f"h{i}", Dense(fc_dim, fc_dim, init=D_INIT,
                                           dtype=dtype))
        self.out = Dense(fc_dim, 1, init=D_INIT, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        x = leaky_relu(self.input(x))
        for i in range(self.n_layers):
            x = leaky_relu(getattr(self, f"h{i}")(x))
        return self.out(x).reshape(-1)


class RegionDiscriminator(nn.Module):
    """`Conv_0..2` 5x5/2 with `BatchNorm_0/1` after stages 1 and 2, each
    stage then LeakyReLU, channels dim, 2 dim, 4 dim; `Conv_3` 5x5/1 to
    one channel -> [B, ceil(H/8), ceil(W/8)]."""

    def __init__(self, dim: int = 64, in_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch_in, ch = in_ch, dim
        for stage in range(3):
            self.add_module(f"Conv_{stage}", Conv(ch_in, ch, 5, stride=2,
                                                  init=D_INIT, dtype=dtype))
            if stage > 0:
                self.add_module(f"BatchNorm_{stage - 1}",
                                BatchNorm(ch, dtype=dtype))
            ch_in, ch = ch, ch * 2
        self.Conv_3 = Conv(ch_in, 1, 5, init=D_INIT, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for stage in range(3):
            x = getattr(self, f"Conv_{stage}")(x)
            if stage > 0:
                x = getattr(self, f"BatchNorm_{stage - 1}")(x, train,
                                                            update_stats)
            x = leaky_relu(x)
        return self.Conv_3(x)[:, 0]


class PatchDiscriminator(nn.Module):
    """Each conv is 4x4 VALID after a reflect pad of 1 on H and W: `Conv_0`
    (dim, stride 2) -> leaky; `Conv_1..n` (dim * min(2^(i+1), 8), stride 2,
    the last stride 1), each with `BatchNorm_i`, then leaky; `Conv_{n+1}`
    (1 channel, stride 1) -> [B, H', W']."""

    def __init__(self, dim: int = 64, n_layers: int = 3, in_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        ch_in, layers = in_ch, [(dim, 2)]
        for i in range(n_layers):
            layers.append((dim * min(2 ** (i + 1), 8),
                           1 if i == n_layers - 1 else 2))
        layers.append((1, 1))
        for i, (ch, stride) in enumerate(layers):
            self.add_module(f"Conv_{i}", Conv(ch_in, ch, 4, stride=stride,
                                              init=D_INIT, dtype=dtype,
                                              padding="VALID"))
            if 0 < i <= n_layers:
                self.add_module(f"BatchNorm_{i - 1}",
                                BatchNorm(ch, dtype=dtype))
            ch_in = ch

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        side = 2 ** (self.n_layers + 1)
        if x.shape[1] < side or x.shape[2] < side:
            raise ValueError(
                f"PatchDiscriminator needs inputs >= {side}px per side (got "
                f"{tuple(x.shape)}); the stride chain would produce an empty "
                "logit map")
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_layers + 2):
            if min(x.shape[2:]) < 2:
                # JAX pads a 1-px side by repeating it and returns an
                # empty logit map, whose mean is NaN; torch's reflect pad
                # and a kernel wider than its input both raise
                raise ValueError(
                    f"PatchDiscriminator: a {x.shape[2]}x{x.shape[3]} input "
                    f"to Conv_{i} leaves an empty logit map")
            # NCHW: the pad's (1, 1, 1, 1) is W's then H's
            x = getattr(self, f"Conv_{i}")(F.pad(x, (1, 1, 1, 1),
                                                 mode="reflect"))
            if 0 < i <= self.n_layers:
                x = getattr(self, f"BatchNorm_{i - 1}")(x, train,
                                                        update_stats)
            if i <= self.n_layers:
                x = leaky_relu(x)
        return x[:, 0]


def get_discriminator(arch: str, img_h: int, img_w: int, n_stages: int = 4,
                      mode: str = "dcgan",
                      dtype: torch.dtype = torch.float32) -> nn.Module:
    """The `--D_arch` selector (discriminators.py:133-145; trainer.py:
    151-158): DCGAN (`n_stages` 4 at 128x64, 5 at 256x256; the only arch
    that reads it or the image size) | FCDis | DCGANRegion* | Patch*."""
    if mode != "dcgan":
        raise NotImplementedError(
            f"mode={mode!r}: the port's image discriminators have the "
            "'dcgan' mode only, the one Stage I uses (GAN_MODE); no app of "
            "the JAX package builds one in another mode")
    if arch == "DCGAN":
        return DCGANDiscriminator(img_h, img_w, n_stages=n_stages,
                                  dtype=dtype)
    if arch == "FCDis":
        return FCDiscriminator(3, dtype=dtype)
    if arch.startswith("DCGANRegion"):
        return RegionDiscriminator(dtype=dtype)
    if arch.startswith("Patch"):
        return PatchDiscriminator(dtype=dtype)
    raise ValueError(f"You must choose an architecture! (got {arch!r})")
