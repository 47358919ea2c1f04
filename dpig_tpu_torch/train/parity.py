"""One recorded train step, and the errors between two of them.

How a train step on one side (the card, or the port) is held against the
same step on another (the CPU, or the JAX package): `recorded_train_step`
runs one step of a fresh state and keeps what each optimizer was given
last, the G parameters just after the G update, the D parameters after
each clip (the WGAN critic iterations) and the D's running statistics;
`step_errors` compares two such records.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from ..apps.common import batch_to_device
from .state import GanState

@dataclasses.dataclass
class StepRecord:
    """One train step: its scalar metrics, its array metrics (the `hist/`
    embeddings), the gradient each optimizer was given last
    ('Encoder/<param>' -> tensor), the G parameters after the G update, the
    D parameters after each clip, and the D's running statistics after the
    step (all tensors on the CPU), and the state it left."""
    metrics: Dict[str, float]
    arrays: Dict[str, torch.Tensor]
    grads: Dict[str, torch.Tensor]
    g_updated: Dict[str, torch.Tensor]
    d_clipped: List[Dict[str, torch.Tensor]]
    d_stats: Dict[str, torch.Tensor]
    state: GanState


def _to_cpu(named) -> Dict[str, torch.Tensor]:
    return {n: t.detach().to("cpu", copy=True) for n, t in named}


def _device_batch(batch, device):
    if isinstance(batch, (list, tuple)):
        return tuple(batch_to_device(b, device) for b in batch)
    return batch_to_device(batch, device)


def recorded_train_step(app, batch, step_fn: Optional[Callable] = None,
                        g_updated: Optional[Mapping[str, torch.Tensor]] = None,
                        noise: Optional[torch.Tensor] = None,
                        d_clipped: Optional[Sequence[Mapping]] = None
                        ) -> StepRecord:
    """One step of `app.init_state()` on the host `batch` (or sequence of
    batches), by `step_fn(app, state, batch[, noise], mark=mark)` (default
    `type(app).train_step`); `noise` (a Stage-II step's, any device) goes
    to the app's device.

    With `g_updated` (another record's), the G parameters are set to those
    right after the G update, so that the D step starts from the same G as
    that record's: the first Adam or RMSProp step is sign-like (a gradient
    near 0 moves its parameter by +-lr, or +-sqrt(10) lr, by the sign each
    side computes), and the D step would otherwise see that noise in its
    fakes. `d_clipped` does the same for the D parameters after each
    critic iteration's clip, so each iteration starts where the other
    record's did. Across ranks, the gradients recorded are the averaged
    ones each update applies (`_Optimizer.apply`)."""
    state = app.init_state()
    grads: Dict[str, torch.Tensor] = {}
    after: Dict[str, torch.Tensor] = {}
    clipped: List[Dict[str, torch.Tensor]] = []
    for opt in (state.g_opt, state.d_opt):
        def recording(g, opt=opt, apply=opt.apply):
            grads.update(_to_cpu(zip(opt.params, g)))
            apply(g)
        opt.apply = recording

    def sync(params: Dict[str, torch.Tensor], to) -> None:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(to[n])

    def mark(phase: str) -> None:
        if phase == "g_update":
            after.update(_to_cpu(state.g_opt.params.items()))
            if g_updated is not None:
                sync(state.g_opt.params, g_updated)
        elif phase == "clip":
            clipped.append(_to_cpu(state.d_opt.params.items()))
            if d_clipped is not None:
                sync(state.d_opt.params, d_clipped[len(clipped) - 1])

    args = () if noise is None else (noise.to(app.device),)
    try:
        out = (step_fn or type(app).train_step)(
            app, state, _device_batch(batch, app.device), *args, mark=mark)
    finally:  # later steps of the returned state are not recorded
        for opt in (state.g_opt, state.d_opt):
            del opt.apply
    if not after:
        raise RuntimeError("the step never marked the end of its G update")
    stats = {f"{k}/{n}": t.detach().to("cpu", copy=True)
             for k, m in state.d_nets.items() for n, t in m.named_buffers()}
    return StepRecord({k: float(v) for k, v in out.items() if v.dim() == 0},
                      {k: v.cpu() for k, v in out.items() if v.dim() > 0},
                      grads, after, clipped, stats, state)


def step_errors(ref: StepRecord, got: StepRecord) -> Dict[str, float]:
    """Errors of `got` against `ref`: 'g_step_losses', the largest
    relative difference of the metrics other than D losses; 'd_loss', that
    of the D losses (`d_loss*`; each absolute where the reference is 0);
    for each sub-net the optimizers were given gradients of, its
    gradients' ||diff||_2 / ||grad||_2 and, as '<sub-net> max', max|diff| /
    max|grad|; 'd_stats', the largest absolute difference of the D's
    running statistics, if it has any; and for each array metric, its
    largest absolute difference."""
    def rel(k):
        a, b = got.metrics[k], ref.metrics[k]
        return abs(a - b) / abs(b) if b else abs(a - b)

    d_keys = [k for k in ref.metrics if k.startswith("d_loss")]
    errs = {"g_step_losses": max(rel(k) for k in ref.metrics
                                 if k not in d_keys),
            "d_loss": max(rel(k) for k in d_keys)}
    for sub in dict.fromkeys(n.split("/")[0] for n in ref.grads):
        names = [n for n in ref.grads if n.startswith(sub + "/")]
        diff = [got.grads[n].double() - ref.grads[n].double() for n in names]
        errs[sub] = float(torch.sqrt(sum((d * d).sum() for d in diff)
                                     / sum((ref.grads[n].double() ** 2).sum()
                                           for n in names)))
        errs[f"{sub} max"] = max(float(d.abs().max()) for d in diff) / max(
            float(ref.grads[n].abs().max()) for n in names)
    if ref.d_stats:
        errs["d_stats"] = max(float((got.d_stats[k] - v).abs().max())
                              for k, v in ref.d_stats.items())
    for k, v in ref.arrays.items():
        errs[k] = float((got.arrays[k] - v).abs().max())
    return errs


def to_float64(app, stem: bool = False, outputs: bool = False):
    """A Stage1App's nets with their parameters and their layers' compute
    dtype (models/layers.py) in float64, the yardstick of what float32
    approximates. The generator's embedding-stem sum
    (models/generator.py) stays float32 unless `stem`, and the nets'
    outputs, the embeddings, g_raw and the D logits, with the losses
    computed from them, unless `outputs`."""
    if stem:
        app.generator.stem_sum_dtype = torch.float64
    if outputs:
        app.out_dtype = torch.float64
    for net in (app.encoder, app.generator, app.disc):
        net.to(torch.float64)
        for m in net.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
    return app
