"""One recorded train step, and the errors between two of them.

How a train step on one side (the card, or the port) is held against the
same step on another (the CPU, or the JAX package): `recorded_train_step`
runs one step of a fresh state and keeps what each optimizer was given,
the G parameters just after the G update and the D's running statistics;
`step_errors` compares two such records.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..apps.common import batch_to_device
from .state import GanState

SUBNETS = ("Encoder", "ID_AE", "Discriminator")


@dataclasses.dataclass
class StepRecord:
    """One train step: its metrics, the gradient each optimizer was given
    ('Encoder/<param>' -> tensor), the G parameters after the G update and
    the D's running statistics after the step (all tensors on the CPU), and
    the state it left."""
    metrics: Dict[str, float]
    grads: Dict[str, torch.Tensor]
    g_updated: Dict[str, torch.Tensor]
    d_stats: Dict[str, torch.Tensor]
    state: GanState


def _to_cpu(named) -> Dict[str, torch.Tensor]:
    return {n: t.detach().to("cpu", copy=True) for n, t in named}


def recorded_train_step(app, batch: Mapping[str, np.ndarray],
                        step_fn: Optional[Callable] = None,
                        g_updated: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> StepRecord:
    """One step of `app.init_state()` on the host `batch`, by
    `step_fn(app, state, batch, mark)` (default `type(app).train_step`).

    With `g_updated` (another record's), the G parameters are set to those
    right after the G update, so that the D step starts from the same G as
    that record's: the first Adam step is sign-like (a gradient near 0
    moves its parameter by +-lr, by the sign each side computes), and the
    D step would otherwise see that noise in its fakes."""
    state = app.init_state()
    grads: Dict[str, torch.Tensor] = {}
    after: Dict[str, torch.Tensor] = {}
    for opt in (state.g_opt, state.d_opt):
        def recording(g, opt=opt, step=opt.step):
            grads.update(_to_cpu(zip(opt.params, g)))
            step(g)
        opt.step = recording

    def mark(phase: str) -> None:
        if phase != "g_update":
            return
        after.update(_to_cpu(state.g_opt.params.items()))
        if g_updated is not None:
            with torch.no_grad():
                for n, p in state.g_opt.params.items():
                    p.copy_(g_updated[n])

    metrics = (step_fn or type(app).train_step)(
        app, state, batch_to_device(batch, app.device), mark)
    if not after:
        raise RuntimeError("the step never marked the end of its G update")
    stats = _to_cpu(state.d_nets["Discriminator"].named_buffers())
    return StepRecord({k: float(v) for k, v in metrics.items()}, grads,
                      after, stats, state)


def step_errors(ref: StepRecord, got: StepRecord) -> Dict[str, float]:
    """Errors of `got` against `ref`: 'g_step_losses', the largest
    relative difference of the four metrics of the G step; 'd_loss',
    relative (each absolute where the reference is 0); for each sub-net,
    its gradients' ||diff||_2 / ||grad||_2 and, as '<sub-net> max',
    max|diff| / max|grad|; 'd_stats', the largest absolute difference of
    the D's running statistics."""
    def rel(k):
        a, b = got.metrics[k], ref.metrics[k]
        return abs(a - b) / abs(b) if b else abs(a - b)

    errs = {"g_step_losses": max(rel(k) for k in ref.metrics
                                 if k != "d_loss"),
            "d_loss": rel("d_loss")}
    for sub in SUBNETS:
        names = [n for n in ref.grads if n.startswith(sub + "/")]
        diff = [got.grads[n].double() - ref.grads[n].double() for n in names]
        errs[sub] = float(torch.sqrt(sum((d * d).sum() for d in diff)
                                     / sum((ref.grads[n].double() ** 2).sum()
                                           for n in names)))
        errs[f"{sub} max"] = max(float(d.abs().max()) for d in diff) / max(
            float(ref.grads[n].abs().max()) for n in names)
    errs["d_stats"] = max(float((got.d_stats[k] - v).abs().max())
                          for k, v in ref.d_stats.items())
    return errs
