"""Straight-through estimators (port of `dpig_tpu/ops/ste.py:12-17`;
reference models.py:91-111).

`bernoulli_sample` (part dropout) is not ported yet: nothing in the port
draws it (ROADMAP queue item 1).
"""
from __future__ import annotations

import torch


def binary_round(x: torch.Tensor) -> torch.Tensor:
    """Round [0,1] -> {0,1} with identity (straight-through) gradient, in
    the JAX operation order. `torch.round` rounds half to even, as
    `jnp.round` does; on [0,1] the sum is exactly 0 or 1 in float32.

    Reference models.py:97-111 `binaryRound`.
    """
    return x + (torch.round(x) - x).detach()
