"""The numbers that decide `correct`, and their comparison with limits.
Which numbers a cell compares, and their limits, are its traffic file's
`limits`; the reference runs in float64.

Training (the checked steps of set-up, through the timed path's own call):
  loss1_gap     worst |program - reference| / |reference| of the first
                step's G loss and its adversarial term (the D on the
                fakes): the forward of every net from the seed's weights;
  l1_gap        the same of the first step's L1 term and the L1 inside
                the mask: the encoder, the pose raster and the generator;
  g_change_gap, worst leaf of each net's change over the checked steps,
  d_change_gap  | ||d_prog|| - ||d_ref|| | / max(||d_ref||, median leaf's),
                leaving out the leaves whose reference first gradient is
                under a thousandth of the median leaf's (a conv bias ahead
                of a BatchNorm: Adam moves it by round-off alone); a state
                left unchanged reads 1.
Computed beside them (PERF.md gives the readings for which they are not
compared):
  loss_gap      the worst gap of every checked step's G and D loss;
  *_grad_gap    the worst leaf's gap of the first gradient's norms (the
                program's read back from its Adam state after one step);
  *_grad_err    the median leaf's ||g_prog - g_ref|| / ||g_ref||;
  *_grad_med,   the median leaf's gaps of first-gradient and change norms.
  *_change_med
Transfer (a sample of the window's batches, drawn from the seed):
  image_gap     worst |program - reference| pixel, on the 0..255 scale;
  pose_mismatch elements of the target pose maps that differ (exact);
  score_gap     worst |program - reference| D logit over the batch's
                largest reference logit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Mapping

import torch

TRAIN_NUMBERS = ("loss1_gap", "l1_gap", "loss_gap") + tuple(
    f"{net}_{what}" for net in "gd" for what in (
        "grad_err", "grad_gap", "grad_med", "change_gap", "change_med"))
TRANSFER_NUMBERS = ("image_gap", "pose_mismatch", "score_gap")
FIRST_STEP_ADV = ("g_loss", "g_loss_only")
FIRST_STEP_L1 = ("L1Loss", "PoseMaskLoss")
FIRST_STEP_LOSSES = FIRST_STEP_ADV + FIRST_STEP_L1
STEP_LOSSES = FIRST_STEP_LOSSES + ("d_loss",)
ZERO_GRAD_SHARE = 1e-3
REFERENCE_DTYPE = torch.float64


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tensors.items()}


def worst_norm_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                   keys: Iterable[str] = None) -> float:
    """max over `keys` (default all) of |prog - ref| / max(ref, median
    of every leaf's ref)."""
    med = statistics.median(ref.values())
    keys = list(ref) if keys is None else list(keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def moving_leaves(ref_grad: Mapping[str, float]) -> List[str]:
    """The leaves whose reference first gradient is not nought."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= ZERO_GRAD_SHARE * med]


def split(norms: Mapping[str, float], net_prefixes) -> Dict[str, float]:
    return {k: v for k, v in norms.items() if k.split("/")[0] in net_prefixes}


def median_norm_gap(prog: Mapping[str, float], ref: Mapping[str, float],
                    keys: Iterable[str] = None) -> float:
    """The median over `keys` of the same per-leaf gap."""
    med = statistics.median(ref.values())
    keys = list(ref) if keys is None else list(keys)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med)
                             for k in keys)


def relative_error(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref||, in float64 on `ref`'s device."""
    a = a.to(ref.device, torch.float64)
    ref = ref.to(torch.float64)
    return float(torch.linalg.vector_norm(a - ref)
                 / torch.linalg.vector_norm(ref))


def train_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """`prog` / `ref`: {'losses': [{STEP_LOSSES: value}, ...],
    'grad': {leaf: norm}, 'change': {leaf: norm}, 'first_grad': {leaf:
    tensor} or None} -> the numbers (`*_grad_err` only where both sides
    kept their first gradient)."""
    def gap(step, key):
        p, r = prog["losses"][step][key], ref["losses"][step][key]
        return abs(p - r) / abs(r)
    steps = range(len(ref["losses"]))
    losses = [gap(k, key) for k in steps for key in ("g_loss", "d_loss")]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    out = {"loss_gap": max(losses),
           "loss1_gap": max(gap(0, key) for key in FIRST_STEP_ADV),
           "l1_gap": max(gap(0, key) for key in FIRST_STEP_L1)}
    for tag, nets_ in (("g", ("Encoder", "ID_AE")), ("d", ("Discriminator",))):
        rg = split(ref["grad"], nets_)
        rc = split(ref["change"], nets_)
        moving = moving_leaves(rg)
        out[f"{tag}_grad_gap"] = worst_norm_gap(prog["grad"], rg)
        out[f"{tag}_grad_med"] = median_norm_gap(prog["grad"], rg)
        out[f"{tag}_change_gap"] = worst_norm_gap(prog["change"], rc, moving)
        out[f"{tag}_change_med"] = median_norm_gap(prog["change"], rc, moving)
        if prog.get("first_grad") and ref.get("first_grad"):
            out[f"{tag}_grad_err"] = statistics.median(
                relative_error(prog["first_grad"][k], ref["first_grad"][k])
                for k in moving)
    return out


def transfer_numbers(pairs) -> Dict[str, float]:
    """`pairs`: [((img, pose, score) program, (img, pose, score)
    reference)] as CPU tensors -> the three numbers."""
    img = pose = score = 0.0
    for (pi, pp, ps), (ri, rp, rs) in pairs:
        img = max(img, float((pi.double() - ri).abs().max()))
        pose += float((pp != rp).sum())
        score = max(score, float((ps.double() - rs).abs().max()
                                 / rs.abs().max().clamp_min(1e-30)))
    return {"image_gap": img, "pose_mismatch": pose, "score_gap": score}


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]):
    """-> (correct, [(name, value, limit)]) over the numbers that have a
    limit. One that is missing or not finite is not correct."""
    rows, ok = [], bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        ok = ok and math.isfinite(value) and value <= limit
        rows.append((name, value, limit))
    return ok, rows
