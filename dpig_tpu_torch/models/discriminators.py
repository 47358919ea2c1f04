"""Discriminators (port of `dpig_tpu/models/discriminators.py`), in both
GAN modes of the JAX package: a BatchNorm where it puts a norm, or, with
`mode="wgan-gp"`, a LayerNorm (`layers.LayerNorm`, flax's over the
channels), which keeps no running statistics and has a clean double
backward for the gradient penalty (`losses/gan.py:gradient_penalty`). The
apps build the 'dcgan' mode, the one Stage I uses (GAN_MODE).

  * DCGANDiscriminator (reference wgan_gp.py:407-440): 5x5/2 conv stack,
    a norm from the second stage on, LeakyReLU 0.3, a linear logit over
    the NHWC-flattened features -> [B]. In float32 on the card its convs
    run PyTorch's own kernels, not cuDNN's (`Conv(cudnn=False)`), in both
    modes and in the penalty's double backward: cuDNN's float32 backward
    of Conv_1 at batch 2 went wrong in some process states (ROADMAP §3).
  * FCDiscriminator (wgan_gp.py:399-405): the LeakyReLU MLP critic of the
    Stage-II samplers, in embedding space; as `--D_arch=FCDis` it scores
    every pixel of an image (a Dense acts on the last axis) -> [B*H*W].
  * RegionDiscriminator (wgan_gp.py:513-546, `--D_arch=DCGANRegion*`):
    three 5x5/2 convs, then a 5x5/1 conv to a 1-channel score map
    [B, H/8, W/8].
  * PatchDiscriminator (wgan_gp.py:549-576, `--D_arch=Patch*`): pix2pix
    4x4 VALID convs after a reflect pad of 1 -> a 1-channel logit map.
  * DCGANDiscriminatorAttr (wgan_gp.py:442-472), the attribute head on
    8x4 maps; MultiplicativeDCGANDiscriminator (wgan_gp.py:347-372), the
    gated DCGAN D; ResnetDiscriminator (wgan_gp.py:374-397), the deep
    residual critic on `models/zoo.py`'s blocks. `get_discriminator`
    returns none of these three, as in JAX, and no CLI flag reaches them.

Every image D takes NHWC images and returns its logits in the compute
dtype; `train` / `update_stats` are BatchNorm's (see DCGANDiscriminator).
Submodules carry flax's names (`Conv_0`.., `BatchNorm_0`.. or
`LayerNorm_0`.., `logit`; `input`, `h0`.., `out`; `stem`,
`WGANResidualBlock_0`..), so `bridge.params_from_flax` maps a JAX
checkpoint of each one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (D_INIT, XAVIER, BatchNorm, Conv, Dense, LayerNorm,
                     flatten_nhwc, leaky_relu)
from .zoo import WGANResidualBlock, pixcnn_gated


def _norm_kind(mode: str) -> str:
    """The norm a GAN mode puts in the image Ds (wgan_gp.py:34-40)."""
    return "LayerNorm" if mode == "wgan-gp" else "BatchNorm"


def _norm(kind: str, ch: int, dtype: torch.dtype) -> nn.Module:
    return (LayerNorm if kind == "LayerNorm" else BatchNorm)(ch, dtype=dtype)


class DCGANDiscriminator(nn.Module):

    def __init__(self, img_h: int, img_w: int, dim: int = 64,
                 n_stages: int = 4, in_ch: int = 3, mode: str = "dcgan",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_stages = n_stages
        self.norm = _norm_kind(mode)
        ch_in, ch, h, w = in_ch, dim, img_h, img_w
        for stage in range(n_stages):
            self.add_module(f"Conv_{stage}", Conv(ch_in, ch, 5, stride=2,
                                                  init=D_INIT, dtype=dtype,
                                                  cudnn=False))
            if stage > 0:
                self.add_module(f"{self.norm}_{stage - 1}",
                                _norm(self.norm, ch, dtype))
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
                x = getattr(self, f"{self.norm}_{stage - 1}")(x, train,
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
    """`Conv_0..2` 5x5/2 with `BatchNorm_0/1` (`LayerNorm_0/1` in
    'wgan-gp') after stages 1 and 2, each stage then LeakyReLU, channels
    dim, 2 dim, 4 dim; `Conv_3` 5x5/1 to one channel -> [B, ceil(H/8),
    ceil(W/8)]."""

    def __init__(self, dim: int = 64, in_ch: int = 3, mode: str = "dcgan",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = _norm_kind(mode)
        ch_in, ch = in_ch, dim
        for stage in range(3):
            self.add_module(f"Conv_{stage}", Conv(ch_in, ch, 5, stride=2,
                                                  init=D_INIT, dtype=dtype))
            if stage > 0:
                self.add_module(f"{self.norm}_{stage - 1}",
                                _norm(self.norm, ch, dtype))
            ch_in, ch = ch, ch * 2
        self.Conv_3 = Conv(ch_in, 1, 5, init=D_INIT, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for stage in range(3):
            x = getattr(self, f"Conv_{stage}")(x)
            if stage > 0:
                x = getattr(self, f"{self.norm}_{stage - 1}")(x, train,
                                                              update_stats)
            x = leaky_relu(x)
        return self.Conv_3(x)[:, 0]


class PatchDiscriminator(nn.Module):
    """Each conv is 4x4 VALID after a reflect pad of 1 on H and W: `Conv_0`
    (dim, stride 2) -> leaky; `Conv_1..n` (dim * min(2^(i+1), 8), stride 2,
    the last stride 1), each with `BatchNorm_i` (`LayerNorm_i` in
    'wgan-gp'), then leaky; `Conv_{n+1}` (1 channel, stride 1) ->
    [B, H', W']."""

    def __init__(self, dim: int = 64, n_layers: int = 3, in_ch: int = 3,
                 mode: str = "dcgan", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.norm = _norm_kind(mode)
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
                self.add_module(f"{self.norm}_{i - 1}",
                                _norm(self.norm, ch, dtype))
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
                x = getattr(self, f"{self.norm}_{i - 1}")(x, train,
                                                          update_stats)
            if i <= self.n_layers:
                x = leaky_relu(x)
        return x[:, 0]


def get_discriminator(arch: str, img_h: int, img_w: int, n_stages: int = 4,
                      mode: str = "dcgan",
                      dtype: torch.dtype = torch.float32) -> nn.Module:
    """The `--D_arch` selector (discriminators.py:133-145; trainer.py:
    151-158): DCGAN (`n_stages` 4 at 128x64, 5 at 256x256; the only arch
    that reads it or the image size) | FCDis | DCGANRegion* | Patch*.
    `mode` sets the image Ds' norm ('wgan-gp': LayerNorm, else
    BatchNorm); FCDis has none."""
    if arch == "DCGAN":
        return DCGANDiscriminator(img_h, img_w, n_stages=n_stages,
                                  mode=mode, dtype=dtype)
    if arch == "FCDis":
        return FCDiscriminator(3, dtype=dtype)
    if arch.startswith("DCGANRegion"):
        return RegionDiscriminator(mode=mode, dtype=dtype)
    if arch.startswith("Patch"):
        return PatchDiscriminator(mode=mode, dtype=dtype)
    raise ValueError(f"You must choose an architecture! (got {arch!r})")


class DCGANDiscriminatorAttr(nn.Module):
    """Attribute head D (wgan_gp.py:442-472), fed 8x4 maps by the
    reference: `Conv_0` (dim) and `Conv_1` (2 dim), 5x5/2, a norm
    (`BatchNorm_0`, or `LayerNorm_0` in 'wgan-gp') after the second, each
    then LeakyReLU and dropout; `Dense_0` (512) -> leaky -> dropout;
    `Dense_1` -> [B, attr_num] logits.

    Dropout keeps an element with probability `keep_prob` and scales it
    by 1 / keep_prob, in train mode when keep_prob < 1. flax draws its
    three masks from one `dropout_rng` (`jax.random.bernoulli`, one call
    per site); the port takes the masks as tensors, `keep_masks`, three
    booleans of the shapes `keep_mask_shapes` gives, in the JAX layout
    (NHWC for the conv sites). Without them, as JAX without its rng, a
    dropping call raises."""

    def __init__(self, img_h: int = 8, img_w: int = 4, in_ch: int = 3,
                 attr_num: int = 27, dim: int = 64, keep_prob: float = 1.0,
                 mode: str = "dcgan", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.keep_prob = keep_prob
        self.norm = _norm_kind(mode)
        self.h1, self.w1 = -(-img_h // 2), -(-img_w // 2)
        self.h2, self.w2 = -(-self.h1 // 2), -(-self.w1 // 2)
        self.Conv_0 = Conv(in_ch, dim, 5, stride=2, init=D_INIT, dtype=dtype)
        self.Conv_1 = Conv(dim, 2 * dim, 5, stride=2, init=D_INIT,
                           dtype=dtype)
        self.add_module(f"{self.norm}_0", _norm(self.norm, 2 * dim, dtype))
        self.Dense_0 = Dense(self.h2 * self.w2 * 2 * dim, 512, init=D_INIT,
                             dtype=dtype)
        self.Dense_1 = Dense(512, attr_num, init=D_INIT, dtype=dtype)

    def keep_mask_shapes(self, batch: int) -> Sequence[tuple]:
        """The three dropout sites' mask shapes, in flax's order."""
        return [(batch, self.h1, self.w1, self.dim),
                (batch, self.h2, self.w2, 2 * self.dim), (batch, 512)]

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False,
                keep_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """x [B, H, W, C] NHWC -> [B, attr_num]."""
        dropping = train and self.keep_prob < 1.0
        if dropping and keep_masks is None:
            raise ValueError("DCGANDiscriminatorAttr drops out in train mode "
                             f"(keep_prob {self.keep_prob}): pass keep_masks")
        # flax's Dropout keeps with probability 1 - rate
        keep = 1.0 - (1.0 - self.keep_prob)

        def drop(h, site):
            if not dropping:
                return h
            if keep == 0.0:  # flax's rate 1: zeros, and no NaN gradient
                return torch.zeros_like(h)
            mask = keep_masks[site]
            if h.dim() == 4:
                mask = mask.permute(0, 3, 1, 2)
            return torch.where(mask, h / keep, torch.zeros_like(h))

        x = drop(leaky_relu(self.Conv_0(x.permute(0, 3, 1, 2))), 0)
        x = getattr(self, f"{self.norm}_0")(self.Conv_1(x), train,
                                            update_stats)
        x = drop(leaky_relu(x), 1)
        x = drop(leaky_relu(self.Dense_0(flatten_nhwc(x))), 2)
        return self.Dense_1(x)


class MultiplicativeDCGANDiscriminator(nn.Module):
    """Gated DCGAN D (wgan_gp.py:347-372): each 5x5/2 `Conv_i` emits 2 ch
    channels, a norm from the second stage on (`BatchNorm_i`, or
    `LayerNorm_i` in 'wgan-gp'), then `pixcnn_gated` of the even and the
    odd channels (the NHWC `x[..., ::2]`, `x[..., 1::2]`, not two halves)
    -> ch; `logit` over the NHWC-flattened features -> [B]."""

    def __init__(self, img_h: int, img_w: int, dim: int = 64,
                 n_stages: int = 4, in_ch: int = 3, mode: str = "dcgan",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_stages = n_stages
        self.norm = _norm_kind(mode)
        ch_in, ch, h, w = in_ch, dim, img_h, img_w
        for stage in range(n_stages):
            self.add_module(f"Conv_{stage}", Conv(ch_in, 2 * ch, 5, stride=2,
                                                  init=D_INIT, dtype=dtype))
            if stage > 0:
                self.add_module(f"{self.norm}_{stage - 1}",
                                _norm(self.norm, 2 * ch, dtype))
            h, w = -(-h // 2), -(-w // 2)
            ch_in = ch
            if stage < n_stages - 1:
                ch = min(ch * 2, dim * 8)
        self.logit = Dense(h * w * ch_in, 1, init=D_INIT, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        """x [B, H, W, 3] NHWC -> logits [B]."""
        x = x.permute(0, 3, 1, 2)
        for stage in range(self.n_stages):
            x = getattr(self, f"Conv_{stage}")(x)
            if stage > 0:
                x = getattr(self, f"{self.norm}_{stage - 1}")(x, train,
                                                              update_stats)
            x = pixcnn_gated(x[:, ::2], x[:, 1::2])
        return self.logit(flatten_nhwc(x)).reshape(-1)


class ResnetDiscriminator(nn.Module):
    """Deep resnet critic (wgan_gp.py:374-397): a 1x1 `stem` to dim/2,
    `blocks_per_scale - 1` blocks, then 4 scales of a down-sampling block
    doubling the channels and `blocks_per_scale` blocks
    (`WGANResidualBlock_0`.. in call order, each with its BatchNorm: it
    has no 'wgan-gp' mode in JAX either), `logit` over the NHWC-flattened
    features, divided by 5 -> [B]."""

    def __init__(self, img_h: int, img_w: int, dim: int = 64,
                 blocks_per_scale: int = 6, in_ch: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = dim // 2
        self.stem = Conv(in_ch, ch, 1, init=XAVIER, dtype=dtype)
        blocks = [(ch, ch, None)] * (blocks_per_scale - 1)
        h, w = img_h, img_w
        for _ in range(4):
            blocks.append((ch, 2 * ch, "down"))
            ch *= 2
            blocks += [(ch, ch, None)] * blocks_per_scale
            h, w = -(-h // 2), -(-w // 2)
        self.n_blocks = len(blocks)
        for i, (ci, co, resample) in enumerate(blocks):
            self.add_module(f"WGANResidualBlock_{i}", WGANResidualBlock(
                ci, co, 3, resample, dtype=dtype))
        self.logit = Dense(h * w * ch, 1, init=D_INIT, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = True,
                update_stats: bool = False) -> torch.Tensor:
        """x [B, H, W, 3] NHWC -> logits [B]."""
        x = self.stem(x.permute(0, 3, 1, 2))
        for i in range(self.n_blocks):
            x = getattr(self, f"WGANResidualBlock_{i}")(x, train,
                                                        update_stats)
        return self.logit(flatten_nhwc(x)).reshape(-1) / 5.0
