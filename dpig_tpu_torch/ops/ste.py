"""Straight-through estimators (port of `dpig_tpu/ops/ste.py`;
reference models.py:91-130).

The JAX package draws `bernoulli_sample`'s uniforms from its threefry
rng; the port cannot reproduce those numbers, so it takes them as a
tensor (`uniform_noise` draws them from an explicit torch.Generator), as
it does with the JAX package's other randomness.
"""
from __future__ import annotations

from typing import Sequence

import torch


def binary_round(x: torch.Tensor) -> torch.Tensor:
    """Round [0,1] -> {0,1} with identity (straight-through) gradient, in
    the JAX operation order. `torch.round` rounds half to even, as
    `jnp.round` does; on [0,1] the sum is exactly 0 or 1 in float32.

    Reference models.py:97-111 `binaryRound`.
    """
    return x + (torch.round(x) - x).detach()


def uniform_noise(gen: torch.Generator, shape: Sequence[int],
                  device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """U[0, 1) draws of `shape` from `gen` (a CPU generator: the card and
    the CPU get the same numbers), on `device`."""
    return torch.rand(tuple(shape), generator=gen, dtype=dtype).to(device)


def bernoulli_sample(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Sample {0,1} with P(1)=x given the uniforms `noise` (x's shape),
    with a straight-through gradient w.r.t. x, in the JAX operation order:
    ceil(x - U), then x + stop_gradient(hard - x).

    Reference models.py:113-130 `bernoulliSample`.
    """
    hard = torch.ceil(x - noise.to(x.dtype))
    return x + (hard - x).detach()
