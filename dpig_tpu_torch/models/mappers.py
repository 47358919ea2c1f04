"""Gaussian -> embedding mapping networks (port of
`dpig_tpu/models/mappers.py:17-35`; reference models.py:474-486
GaussianFCRes).

Stage-II samplers: z ~ N(0, 0.2^2) -> FC-res trunk -> embedding. The noise
is drawn outside the module, from an explicit torch.Generator.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .layers import Dense, FCResTrunk, leaky_relu

GAUSSIAN_STDDEV = 0.2  # models.py:474 (mean=0.0, stddev=0.2)


def sample_mapper_noise(gen: torch.Generator, batch: int, dim: int,
                        device: torch.device,
                        stddev: float = GAUSSIAN_STDDEV) -> torch.Tensor:
    """[batch, dim] normal noise * stddev, drawn on the generator's device
    (the CPU for a CPU generator) and copied to `device`, so the card and
    the CPU get the same numbers from the same seed. The copy to the card
    is one asynchronous copy from pinned memory, so it does not wait for
    the work already queued on the stream."""
    noise = torch.randn((batch, dim), generator=gen) * stddev
    if device.type == "cuda":
        return noise.pin_memory().to(device, non_blocking=True)
    return noise.to(device)


class GaussianMapper(nn.Module):
    """`FCResTrunk_0` (leaky first activation) then `Dense_0`. Widths
    (trainer.py:754-758): out 7*32 for FG, 128 for BG, 32 for pose; hidden
    512 for FG and pose, 256 for BG; the input is the noise, of the
    output's width."""

    def __init__(self, in_dim: int, out_dim: int, hidden_num: int,
                 repeat_num: int = 4, activation: Callable = leaky_relu):
        super().__init__()
        self.FCResTrunk_0 = FCResTrunk(in_dim, repeat_num, hidden_num,
                                       activation,
                                       first_activation=activation)
        self.Dense_0 = Dense(hidden_num, out_dim)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(self.FCResTrunk_0(z))
