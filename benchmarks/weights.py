"""The weights of a cell, drawn from the run's seed on the device, in a few
large calls: one uniform draw for every Glorot-uniform tensor, scaled per
tensor, one normal draw for the D's N(0, 0.02) tensors; zero biases,
unit norm scales, the running statistics at 0 and 1. The same seed gives
the same weights on one device; they are handed to the program and to the
reference alike."""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from .reference import nets

Weights = Dict[str, Dict[str, torch.Tensor]]


def draw(cfg: Mapping, seed: int, device) -> Weights:
    """{'Encoder': {...}, 'ID_AE': {...}, 'Discriminator': {... with the
    BatchNorms' running statistics}} on `device`, from `seed`."""
    specs = nets.param_specs(cfg)
    specs["Discriminator"] = (specs["Discriminator"]
                              + nets.discriminator_buffers(
                                  cfg["nets"]["discriminator"]))
    flat = [(net, name, shape, init) for net, leaves in specs.items()
            for name, shape, init in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Weights = {net: {} for net in specs}
    for init, fill in ((nets.XAVIER, "uniform"), (nets.NORMAL, "normal")):
        group = [s for s in flat if s[3] == init]
        sizes = [math.prod(s[2]) for s in group]
        if not group:
            continue
        if fill == "uniform":
            buf = torch.rand(sum(sizes), generator=gen, device=device)
            bounds = torch.tensor([nets.xavier_bound(s[2]) for s in group],
                                  device=device)
            scale = torch.repeat_interleave(
                bounds, torch.tensor(sizes, device=device))
            buf = (buf * 2.0 - 1.0) * scale
        else:
            buf = torch.randn(sum(sizes), generator=gen, device=device) * 0.02
        for (net, name, shape, _), part in zip(group, buf.split(sizes)):
            out[net][name] = part.view(shape)
    for net, name, shape, init in flat:
        if init in (nets.ZEROS, nets.ONES):
            out[net][name] = torch.full(shape, float(init == nets.ONES),
                                        device=device)
    return out


def cast(w: Weights, dtype: torch.dtype) -> Weights:
    """A copy of `w` in `dtype`."""
    return {net: {k: v.detach().to(dtype, copy=True) for k, v in
                  leaves.items()} for net, leaves in w.items()}
