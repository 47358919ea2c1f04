"""Discriminators (port of `dpig_tpu/models/discriminators.py:23-65`).

  * DCGANDiscriminator (reference wgan_gp.py:407-440): 5x5/2 conv stack,
    BatchNorm from the second stage on (the 'dcgan' GAN mode), LeakyReLU
    0.3, a linear logit over the NHWC-flattened features.
  * FCDiscriminator (wgan_gp.py:399-405): the LeakyReLU MLP critic of the
    Stage-II samplers, in embedding space.
"""
from __future__ import annotations

import torch
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
                                                  init=D_INIT, dtype=dtype))
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
    """Dense `input` -> leaky, `h0`..`h{n-1}` -> leaky, `out` -> [B]; the
    flax names, normal(0.02) weights."""

    def __init__(self, in_dim: int, fc_dim: int = 512, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.input = Dense(in_dim, fc_dim, init=D_INIT)
        for i in range(n_layers):
            self.add_module(f"h{i}", Dense(fc_dim, fc_dim, init=D_INIT))
        self.out = Dense(fc_dim, 1, init=D_INIT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.input(x))
        for i in range(self.n_layers):
            x = leaky_relu(getattr(self, f"h{i}")(x))
        return self.out(x).reshape(-1)


def get_discriminator(arch: str, img_h: int, img_w: int, n_stages: int = 4,
                      dtype: torch.dtype = torch.float32
                      ) -> DCGANDiscriminator:
    """The 'dcgan'-mode DCGAN D of discriminators.py:135 (`--D_arch`)."""
    if arch != "DCGAN":
        raise NotImplementedError(
            f"--D_arch={arch}: only DCGAN is ported to dpig_tpu_torch "
            '(ROADMAP §1, "The remaining CLI modes and options")')
    return DCGANDiscriminator(img_h, img_w, n_stages=n_stages, dtype=dtype)
