"""The floating-point operations a Stage-I training step and a transfer
batch need, counted on the plain reference (`stage1.py`) by PyTorch's
`FlopCounterMode` (2 per multiply-add of every conv, its backward and every
matrix product) on the meta device, so nothing is computed and no memory
is taken. The count is of the reference, never of the program under test:
a program that fuses or removes a kernel leaves it unchanged. The
elementwise work (activations, norms, losses, Adam) is not counted; it is
a small share of these steps and bounded by bytes, not operations."""
from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import nets, stage1


def _meta_params(cfg: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    return {net: {name: torch.empty(shape, device="meta")
                  for name, shape, _ in specs}
            for net, specs in nets.param_specs(cfg).items()}


def _meta_batch(cfg: Mapping, b: int) -> Dict[str, torch.Tensor]:
    n = cfg["nets"]
    h, w, k, parts = n["img_H"], n["img_W"], n["keypoints"], n["part_num"]

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {"x": t(b, h, w, 3), "mask_r6": t(b, h, w, 1),
            "pose_rcv": t(b, k, 3), "pose_rcv_target": t(b, k, 3),
            "part_bbox": t(b, parts, 4, dtype=torch.int32),
            "part_vis": t(b, parts, dtype=torch.int32)}


def train_step_flops(cfg: Mapping, batch_size: int) -> float:
    """FLOPs of one reference training step (G forward and backward, the
    G's re-forward for the D step, the D's forwards and backward)."""
    step = stage1.TrainStep(cfg, _meta_params(cfg))
    with FlopCounterMode(display=False) as counter:
        step.step(_meta_batch(cfg, batch_size))
    return float(counter.get_total_flops())


def transfer_flops(cfg: Mapping, batch_size: int) -> float:
    """FLOPs of one reference transfer batch (encoder, generator, D)."""
    with FlopCounterMode(display=False) as counter:
        stage1.transfer(cfg, _meta_params(cfg), _meta_batch(cfg, batch_size))
    return float(counter.get_total_flops())
