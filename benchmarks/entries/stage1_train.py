"""Stage-I training through the program's own trainer: `Trainer.step`
(copy-in of the loader's batch) -> `Stage1App.train_step` (models 1 and
101), closed loop, one trainer. The loader is a ring of distinct seeded
host batches (the traffic file's `ring`), fed as a loader feeds them.

Set-up makes the weights on the device, builds the app and the trainer
once, and drives them through the traffic file's `checked_steps` steps
(distinct batches): they warm up every shape and are the steps the
reference follows. The window then runs steps on the same objects for
the run's seconds, reading the metrics on the host only where
`Trainer.train` does (step 0 and every `log_step`). The traced run adds
CUDA events at `train_step`'s public `mark` phases, a profiled stretch of
`profile_steps` steps, and the reference's FLOP count."""
from __future__ import annotations

import itertools
import time
from typing import Dict, Mapping, Optional

import torch

from dpig_tpu_torch.apps.stage1_app import Stage1App
from dpig_tpu_torch.config import Config
from dpig_tpu_torch.train.harness import Trainer

from .. import check, measure, weights
from ..harness import Device, Outcome, Seeds, SetupClock, model_dir, \
    remove
from ..reference import flops, stage1
from ..traffic import synthetic

NUMBERS = check.TRAIN_NUMBERS   # what `check` computes for this entry

STEP_START = "start"


def host_ring(cell, seeds: Seeds):
    n, t = cell.config["nets"], cell.traffic
    return synthetic.ring(seeds.data, t["ring"], t["batch_size"],
                          n["img_H"], n["img_W"], n["keypoints"],
                          n["part_num"])


def program_config(cell, platform: str, workdir: str) -> Config:
    t = cell.traffic
    return Config(**cell.config["config"], batch_size=t["batch_size"],
                  model=t["model"], platform=platform, model_dir=workdir)


def first_steps(cell, seeds: Seeds, dev: Device, workdir: str,
                clock: Optional[SetupClock] = None, keep_grads: bool = False):
    """Set-up: the program's trainer on the seed's weights, driven through
    the checked steps. -> (trainer, state, the program's numbers; with
    `keep_grads` also the first gradient itself, on the host)."""
    clock = clock or SetupClock(dev)
    ring = host_ring(cell, seeds)
    clock.lap("traffic")
    w0 = weights.draw(cell.config, seeds.weights, dev.torch)
    clock.lap("weights")
    cfg = program_config(cell, "cpu" if not dev.cuda else "", workdir)
    app = Stage1App(cfg, dev.torch, state=w0)
    trainer = Trainer(cfg, app, itertools.cycle(ring))
    state = trainer.init_state()
    clock.lap("build")
    losses, grad, first = [], {}, None
    b1 = cell.config["config"]["beta1"]
    for k in range(cell.traffic["checked_steps"]):
        m = trainer.step(state)
        losses.append({key: float(m[key]) for key in check.STEP_LOSSES})
        if k == 0:  # the first gradient: Adam's first moment is (1-b1) g
            first = {n: v / (1 - b1) for opt in (state.g_opt, state.d_opt)
                     for n, v in opt.moments["mu"].items()}
            grad = check.leaf_norms(first)
            first = {n: v.cpu() for n, v in first.items()} if keep_grads \
                else None
    clock.lap("checked_steps")
    params = {**state.g_opt.params, **state.d_opt.params}
    change = check.leaf_norms({
        name: p.detach() - w0[name.split("/")[0]][name.split("/", 1)[1]]
        for name, p in params.items()})
    return trainer, state, {"losses": losses, "grad": grad,
                            "change": change, "first_grad": first}


def reference_steps(cell, seeds: Seeds, dev: Device,
                    dtype: torch.dtype = check.REFERENCE_DTYPE,
                    tf32: bool = False, rows: slice = slice(None)) -> Dict:
    """The reference's checked steps from the same weights and batches, in
    `dtype` (float32 with `tf32`: the control; with `rows`, on those rows
    of each batch alone)."""
    ring = host_ring(cell, seeds)
    ref = stage1.TrainStep(cell.config, weights.cast(
        weights.draw(cell.config, seeds.weights, dev.torch), dtype))
    p0 = {k: v.detach().clone() for k, v in
          {**ref.g_leaves, **ref.d_leaves}.items()}
    losses, first = [], {}
    with stage1.precision(tf32):
        for k in range(cell.traffic["checked_steps"]):
            batch = {key: v[rows] for key, v in ring[k % len(ring)].items()}
            m = ref.step(stage1.to_device(batch, dev.torch, dtype))
            losses.append({key: float(m[key]) for key in check.STEP_LOSSES})
            if k == 0:
                first = ref.last_grads
    change = check.leaf_norms({k: v.detach() - p0[k] for k, v in
                               {**ref.g_leaves, **ref.d_leaves}.items()})
    return {"losses": losses, "grad": check.leaf_norms(first),
            "change": change, "first_grad": first}


def _marked(app, steps: list):
    """`app.train_step` with a CUDA event at its start and at each `mark`."""
    plain = app.train_step

    def train_step(state, batch):
        events = []

        def mark(phase):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((phase, ev))

        mark(STEP_START)
        out = plain(state, batch, mark=mark)
        steps.append(events)
        return out
    return plain, train_step


def phase_ms(steps) -> Dict[str, list]:
    out: Dict[str, list] = {}
    for events in steps:
        for (_, a), (phase, b) in zip(events, events[1:]):
            out.setdefault(phase, []).append(a.elapsed_time(b))
    return out


def run(cell, seeds: Seeds, seconds: float, trace: bool, dev: Device,
        t0: float) -> Outcome:
    t = cell.traffic
    b = t["batch_size"]
    workdir = model_dir()
    try:
        clock = SetupClock(dev)
        trainer, state, prog = first_steps(cell, seeds, dev, workdir, clock)
        app, log_step = trainer.app, trainer.cfg.log_step
        steps: list = []
        plain = None
        if trace:
            plain, app.train_step = _marked(app, steps)
        dev.sync()
        start = time.perf_counter()
        setup_s = start - t0
        clock.report(t0)
        n, step = 0, t["checked_steps"]
        while True:
            metrics = trainer.step(state)
            if step == 0 or step % log_step == log_step - 1:
                # the host reads the metrics where `Trainer.train` does
                _ = {k: float(v) for k, v in metrics.items()}
            n, step = n + 1, step + 1
            if time.perf_counter() - start >= seconds:
                break
        dev.sync()
        window_s = time.perf_counter() - start
        ctx: Dict = {"config": cell.config, "traffic": t}
        summary = None
        if trace:
            app.train_step = plain
            ctx.update(phases_ms=phase_ms(steps), steps=n,
                       window_s=window_s, dtype=cell.config["precision"][
                           "dtype"])
            summary = measure.profile(
                lambda: [trainer.step(state)
                         for _ in range(t["profile_steps"])], dev.sync)
            ctx["trace"] = summary
        peak = dev.peak_bytes()
        del trainer, state, app, metrics, steps, plain
        dev.free()
    finally:
        remove(workdir)
    ref = reference_steps(cell, seeds, dev)
    if trace:
        ctx["step_flops"] = flops.train_step_flops(cell.config, b)
    e2e = {"train_img_per_s": measure.rate(b * n, window_s),
           "setup_s": setup_s}
    return Outcome(e2e, ctx, check.train_numbers(prog, ref), attempted=n,
                   failed=0, memory_peak_bytes=peak, trace=summary)


def program_numbers(cell, seeds: Seeds, dev: Device) -> Mapping:
    """The program's checked steps alone, with the first gradient (for the
    limits' readings)."""
    workdir = model_dir()
    try:
        trainer, state, prog = first_steps(cell, seeds, dev, workdir,
                                           keep_grads=True)
        del trainer, state
        dev.free()
    finally:
        remove(workdir)
    return prog
