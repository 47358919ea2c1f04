"""Where a model-12 batch, a model-11 sampling batch, a model-1 train step
and the model-3 / model-4 Stage-II train steps spend their time on the
card (the port's counterpart of `dpig_tpu/utils/profiling.py`, for the
ported paths).

    python -m dpig_tpu_torch.utils.profiling

Runs `ConditionalTransferTester`, `FullSamplingTester` (sample_app,
pose_source 'sampled', as `chip_smoke.py` runs it) and
`Stage1App.train_step` on the card at full Market width (the `Config()`
defaults: 128x64, hidden 128, z 64, batch 16, Adam at 8e-5, the re-forward
D step), cold start, float32, and prints these breakdowns:

  spans (model 12)  REPS client batches (copy in, transfer_step, images
          copied out) after a warm-up, the span recorder (`utils/spans.py`)
          on: per batch, each span's device ms, its self ms (less its
          child spans: `transfer_step`'s is the clamp) and host ms, and
          the copy-in's bytes; a profiled stretch of REPS more: its busy
          share and the share of it in which the card is idle while the
          host is inside `copy_in`;
  stages  the median device ms of each layer of `transfer_step` in the
          same batches (its spans): ROI encoder (part selection, stem,
          crop, towers), pose raster, generator, D score;
  loop    host time of each part of `run()`'s loop (synchronized): copy
          in, transfer_step, source pose map, copy out, PNG writes, SSIM;
  trace   torch.profiler over one `run()` batch: the device's busy share of
          the batch's wall time and device time by kernel (top 12);
  sampling  device time of each stage of the model-11 step (CUDA events,
          median over REPS after a warm-up): encode (only when its output
          is live, not with sample_app), mappers (FG, BG and pose
          Gaussian mappers), pose_ae (the pose decoder), pose_raster,
          generate, disc_score;
  sampling loop  host ms per `run()` batch: the synchronized sample_step
          and the rest (copy in, noise, the `pose` / `pose_target`
          renders, copy out, PNG and rcv writes);
  sampling trace  torch.profiler over one model-11 `run()` batch: busy
          share and top kernels;
  train   device time of each phase of a train step (CUDA events at
          `train_step`'s phase marks, median over REPS after a warm-up):
          G forward, G backward, G update, G re-forward, D forward and
          backward (real and fake), D update; host ms per step;
  train trace  torch.profiler over one `train_step`: wall and busy share,
          the top kernels, and the device time of the ROI crop's backward
          (`aten::_index_put_impl_`, an accumulating index_put_);
  spans (model 1)  the same as for model 12 over REPS `Trainer.step`s:
          the copy-in, each net's forwards and backward
          (`encoder.backward`, `generator.backward`), and the step's self
          ms (the D's passes, the losses and both Adams);
  stage2  for model 3 (`Stage2AppApp`, the default `fresh` batches, cold
          start) and model 4 (`Stage2PoseApp`), batch 16: device ms of each
          phase of `train_step` (CUDA events at its marks, the critic
          phases summed over the CRITIC_ITERS iterations, median over REPS
          after a warm-up): real embeddings (the frozen encoder on 1+5
          batches), G forward and backward, G update, critic forward and
          backward, D update, clip; host ms per step as the Trainer runs
          it (`Trainer.step`: copy in, noise, step, synchronized); and
          torch.profiler over one such step: busy share, top kernels and
          the host-to-device copies it made;
  stage2 loader  the same model-3 Trainer step fed by `TFRecordPairLoader`
          (LOADER_PAIRS synthetic pairs written as Market tfrecords with
          JPEGs, shuffled, `num_worker` thread workers, prefetch 2) in
          place of the synthetic batches: host ms per step and a traced
          step's busy share and host-to-device copies.

The last line is one JSON object with every number printed. Needs a card.
"""
from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from collections import defaultdict

import torch

from ..apps.common import batch_to_device, pose_maps_from_batch
from ..apps.stage1_app import TRAIN_PHASES, Stage1App
from ..apps.stage2_app import STAGE2_PHASES, Stage2AppApp
from ..apps.stage2_pose import Stage2PoseApp
from ..apps.testers import (ConditionalTransferTester, FullSamplingTester,
                             _save_batch_pngs)
from ..config import Config
from ..data.loader import TFRecordPairLoader
from ..data.synthetic import SyntheticLoader, write_synthetic_tfrecords
from ..eval.metrics import ssim_images
from ..ops.pose import render_pose_maps
from ..train.harness import Trainer
from . import spans
from .viz import pose_to_gray

SAMPLING_STAGES = ("encode", "mappers", "pose_ae", "pose_raster", "generate",
                   "disc_score")
SAMPLING_SOURCE = "sampled"
LOOP = ("copy_in", "transfer_step", "source_pose", "copy_out", "png_write",
        "ssim")
STAGE_SPANS = {"encode": "encoder", "pose_raster": "pose_raster",
               "generate": "generator", "disc_score": "disc_score"}
COPY_IN = "copy_in"
CROP_BACKWARD_OP = "aten::_index_put_impl_"
LOADER_PAIRS = 192  # two epochs of fresh model-3 steps (96 samples each)
REPS = 5


def recorded(fn, reps: int) -> dict:
    """`spans.summary()` of `reps` calls of `fn()` after one warm-up call,
    the recorder on for them. The recorder is reset before and after, and
    left on only if it was."""
    was = spans.enabled()
    fn()
    spans.reset()
    spans.enable()
    try:
        for _ in range(reps):
            fn()
        return spans.summary()
    finally:
        spans.reset()
        if not was:
            spans.disable()


def stages_of(table: dict) -> dict:
    """Median device ms of each layer of transfer_step in a
    `spans.summary()` table (the spans of STAGE_SPANS)."""
    return {s: statistics.median(table[span]["device_ms"])
            for s, span in STAGE_SPANS.items()}


def stage_ms(tester, jb, reps: int) -> dict:
    """Median device ms of each layer of transfer_step on batch `jb`, over
    `reps` real calls after a warm-up."""
    return stages_of(recorded(lambda: tester.transfer_step(jb), reps))


@torch.inference_mode()
def sampling_stages(tester: FullSamplingTester, jb, noise, mark):
    """FullSamplingTester.sample_step (pose_source 'sampled') in stages,
    `mark(stage)` after each of SAMPLING_STAGES is enqueued -> (g_raw,
    score). The encoder runs only without sample_app, as in the step."""
    cfg, fg_dim = tester.cfg, tester.fg_dim
    if cfg.sample_app:
        embs = None
    else:
        embs = tester._encode_app(jb)
    mark("encode")
    if embs is None:
        fg = tester._map("Gaussian_FC_Fg", noise["fg"])
        bg = tester._map("Gaussian_FC_Bg", noise["bg"])
    else:
        fg, bg = embs[:, :fg_dim], embs[:, fg_dim:]
    if cfg.one_app_per_batch:
        fg = fg[:1].expand(fg.shape[0], -1)
    embs = torch.cat([fg, bg], -1)
    z = tester._pose_z(jb, noise["pose"], SAMPLING_SOURCE)
    mark("mappers")
    rcv = tester.pose_ae.decode_rcv(z)
    mark("pose_ae")
    pose = render_pose_maps(rcv, cfg.img_H, cfg.img_W, cfg.keypoint_num,
                            radius=4, normalized=True)
    mark("pose_raster")
    g_raw = tester._generate(embs, pose)
    mark("generate")
    score = tester._disc_score(g_raw)
    mark("disc_score")
    return g_raw, score


def sampling_stage_ms(tester: FullSamplingTester, jb, noise,
                      reps: int) -> dict:
    """Median device ms of each stage of the model-11 step (CUDA events)."""
    rows = []
    for _ in range(reps + 1):  # the first is a warm-up
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(_stage):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        sampling_stages(tester, jb, noise, mark)
        torch.cuda.synchronize()
        rows.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    return {s: statistics.median(r[i] for r in rows[1:])
            for i, s in enumerate(SAMPLING_STAGES)}


def sampling_loop_ms(tester: FullSamplingTester, loader, reps: int) -> dict:
    """Median host ms per model-11 run() batch: the sample_step (then
    synchronized) and the rest of the batch, over `reps` batches after
    the first."""
    step, marks = tester.sample_step, []

    def timed_step(*args):
        marks.append(time.perf_counter())
        out = step(*args)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return out

    tester.sample_step = timed_step
    try:
        tester.run(loader, test_batch_num=reps + 1,
                   pose_source=SAMPLING_SOURCE)
    finally:
        del tester.sample_step
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    rows = [(marks[i + 1] - marks[i], marks[i + 2] - marks[i + 1])
            for i in range(2, len(marks) - 1, 2)]
    return {"sample_step": statistics.median(r[0] for r in rows) * 1e3,
            "rest": statistics.median(r[1] for r in rows) * 1e3}


def loop_ms(tester, loader, dirs, reps: int) -> dict:
    """Median host ms of each part of run()'s loop body, synchronized."""
    cfg = tester.cfg
    rows = []
    for i in range(reps + 1):
        batch = next(loader)
        t = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        jb = batch_to_device(batch, tester.device)
        mark()
        g, pose_t, _ = tester.transfer_step(jb)
        mark()
        with torch.inference_mode():
            pose_s = pose_maps_from_batch(jb, cfg)
        mark()
        g = g.cpu().numpy()
        pose_s, pose_t = pose_s.cpu().numpy(), pose_t.cpu().numpy()
        mark()
        x_target = (batch["x_target"] + 1) * 127.5
        _save_batch_pngs(dirs, {
            "x": (batch["x"] + 1) * 127.5, "x_target": x_target, "G": g,
            "pose": pose_to_gray(pose_s), "pose_target": pose_to_gray(pose_t),
            "mask": batch["mask_r4"] * 255.0,
            "mask_target": batch["mask_r4_target"] * 255.0,
        }, i * cfg.batch_size)
        mark()
        ssim_images(g, x_target)
        mark()
        rows.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
    return {s: statistics.median(r[i] for r in rows[1:])
            for i, s in enumerate(LOOP)}


def train_phase_ms(app: Stage1App, state, batch, reps: int) -> dict:
    """Median device ms of each phase of a train step (CUDA events)."""
    rows = []
    for _ in range(reps + 1):  # the first is a warm-up
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(_phase):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        app.train_step(state, batch, mark)
        torch.cuda.synchronize()
        rows.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    return {p: statistics.median(r[i] for r in rows[1:])
            for i, p in enumerate(TRAIN_PHASES)}


def train_step_ms(app: Stage1App, state, loader, reps: int) -> list:
    """Host ms of `reps` train steps on fresh batches, each from copy-in
    to a synchronize, after one warm-up step."""
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        app.train_step(state, batch_to_device(next(loader), app.device))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[1:]


def stage2_phase_ms(app, state, batch, noise, reps: int) -> dict:
    """Median device ms of each phase of a Stage-II train step (CUDA
    events; the critic phases summed over their iterations)."""
    rows = []
    for _ in range(reps + 1):  # the first is a warm-up
        events, names = [torch.cuda.Event(enable_timing=True)], []
        events[0].record()

        def mark(phase):
            names.append(phase)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        app.train_step(state, batch, noise, mark)
        torch.cuda.synchronize()
        row = defaultdict(float)
        for name, a, b in zip(names, events, events[1:]):
            row[name] += a.elapsed_time(b)
        rows.append(row)
    return {p: statistics.median(r[p] for r in rows[1:])
            for p in STAGE2_PHASES}


def trainer_step_ms(trainer: Trainer, state, reps: int) -> list:
    """Host ms of `reps` Trainer steps (copy in, noise, step), each
    synchronized, after one warm-up step."""
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        trainer.step(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[1:]


def stage2_profile(cls, cfg: Config, reps: int) -> dict:
    """Phase ms, host ms per step and a traced step of the Stage-II app
    `cls` on the card, cold start."""
    app = cls(cfg, torch.device("cuda"))
    state = app.init_state()
    trainer = Trainer(cfg, app, SyntheticLoader(cfg.batch_size, cfg.img_H,
                                                cfg.img_W))
    host = tuple(next(trainer.loader) for _ in range(app.batches_per_step))
    batch = tuple(batch_to_device(b, app.device) for b in host)
    noise = app.step_noise(trainer.noise_gen, cfg.batch_size)
    phases = stage2_phase_ms(app, state, batch if len(batch) > 1
                             else batch[0], noise, reps)
    step_ms = trainer_step_ms(trainer, state, reps)
    return {"phases_ms": phases, "step_ms": step_ms,
            "trace": trace(lambda: trainer.step(state))}


def stage2_loader_profile(cfg: Config, reps: int) -> dict:
    """Host ms per model-3 `Trainer.step` and a traced step, the batches
    read from the tfrecord pairs under `cfg.data_path`."""
    app = Stage2AppApp(cfg, torch.device("cuda"))
    state = app.init_state()
    with TFRecordPairLoader(
            cfg.data_path, cfg.split, cfg.batch_size, cfg.img_H, cfg.img_W,
            dataset=cfg.dataset, shuffle=True, seed=cfg.random_seed,
            num_workers=cfg.num_worker,
            worker_mode=cfg.worker_mode) as loader:
        trainer = Trainer(cfg, app, loader)
        step_ms = trainer_step_ms(trainer, state, reps)
        return {"step_ms": step_ms,
                "trace": trace(lambda: trainer.step(state))}


def _device_time_us(evt) -> float:
    """Device time of a key_averages() row (`cuda_time_total` before
    PyTorch 2.4)."""
    if hasattr(evt, "device_time_total"):
        return evt.device_time_total
    return evt.cuda_time_total


def trace(fn, top: int = 12, crop: bool = False) -> dict:
    """torch.profiler over `fn()`, synchronized: busy share, kernel times
    and, with `crop`, the ROI crop backward's device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = _device_summary(prof, wall_us, top)
    if crop:
        ops = [e for e in prof.key_averages() if e.key == CROP_BACKWARD_OP]
        out["crop_backward_ms"] = sum(_device_time_us(e) for e in ops) / 1e3
        out["crop_backward_calls"] = sum(e.count for e in ops)
    return out


def _device_summary(prof, wall_us: float, top: int) -> dict:
    """Busy share of the wall time (union of device intervals), device
    time by kernel name, the host-to-device copies (`Memcpy HtoD`
    events, by kind), and the share of the wall time in which the card
    is idle while the host is inside a `copy_in` span (its
    `record_function`)."""
    ops, by_name, counts, copy_in = [], defaultdict(float), \
        defaultdict(int), []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name == COPY_IN and e.is_user_annotation:
                copy_in.append((e.time_range.start, e.time_range.end))
            continue
        if e.is_user_annotation:  # a span's annotation on the device
            continue
        ops.append((e.time_range.start, e.time_range.end))
        by_name[e.name] += e.time_range.elapsed_us()
        counts[e.name] += 1
    busy = spans.union(ops)
    busy_us = spans.covered(busy)
    idle_in_copy = sum((e - s) - spans.covered(busy, s, e)
                       for s, e in spans.union(copy_in))
    kernels = sorted(by_name, key=by_name.get, reverse=True)[:top]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us if wall_us else 0.0,
            "copy_in_idle_share": idle_in_copy / wall_us if wall_us
            else 0.0,
            "device_events": len(ops),
            "top": [{"name": n[:90], "ms": by_name[n] / 1e3,
                     "count": counts[n]} for n in kernels],
            "pose_raster_us": [by_name[n] / counts[n] for n in by_name
                               if "pose_raster" in n],
            "h2d_copies": {n: counts[n] for n in by_name if "HtoD" in n}}


def span_profile(step, reps: int) -> dict:
    """The recorder's table of `reps` calls of `step()` (one Trainer.step,
    or one batch copied in, transferred and copied out) after a warm-up
    (`spans`), and a profiled stretch of `reps` more with the recorder on
    (`trace`: busy share, copy-in idle share). The recorder is left off
    and reset."""
    out = {"spans": recorded(step, reps)}
    spans.enable()
    try:
        out["trace"] = trace(lambda: [step() for _ in range(reps)])
    finally:
        spans.reset()
        spans.disable()
    return out


def transfer_client(tester, loader):
    """One batch as a client serves it: copied in, transferred, images
    copied out to host memory."""
    def step():
        images, _, _ = tester.transfer_step(
            batch_to_device(next(loader), tester.device))
        images.cpu()
    return step


def _print_spans(tag: str, prof: dict, reps: int) -> None:
    """Per call: each span's count, device ms, self ms and host ms, with
    its parent and the bytes it counted; the traced stretch's shares."""
    tr = prof["trace"]
    for name, row in prof["spans"].items():
        where = f" in {row['parent'][0]}" if row["parent"][0] else ""
        moved = (f", {row['counts']['bytes'] / reps / 1e6:.2f} MB"
                 if "bytes" in row["counts"] else "")
        print(f"[spans] {tag}: {name}{where} x{row['count'] / reps:g}: "
              f"device ms {sum(row['device_ms']) / reps:.3f} (self "
              f"{sum(row['self_ms']) / reps:.3f}), host ms "
              f"{sum(row['host_ms']) / reps:.3f}{moved}")
    print(f"[spans] {tag}: traced stretch busy share "
          f"{tr['device_busy_share']:.4f}, idle inside copy_in "
          f"{tr['copy_in_idle_share']:.4f} of the stretch")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device; this measures the card")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(platform="", model_dir=tmp)
        tester = ConditionalTransferTester(cfg)
        loader = SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                                 seed=cfg.random_seed)
        jb = batch_to_device(next(loader), tester.device)
        transfer_spans = span_profile(transfer_client(tester, loader),
                                      REPS)
        stages = stages_of(transfer_spans["spans"])
        dirs = {d: os.path.join(tmp, "loop", d) for d in (
            "x", "x_target", "G", "pose", "pose_target", "mask",
            "mask_target")}
        for d in dirs.values():
            os.makedirs(d)
        loop = loop_ms(tester, loader, dirs, REPS)
        tester.run(loader, test_batch_num=1)  # warm run() before tracing
        trace_12 = trace(lambda: tester.run(loader, test_batch_num=1))
        del tester

        sampler = FullSamplingTester(Config(platform="", model_dir=tmp,
                                            sample_app=True))
        noise = sampler.draw_noise(torch.Generator().manual_seed(0),
                                   cfg.batch_size)
        s_stages = sampling_stage_ms(sampler, jb, noise, REPS)
        s_loop = sampling_loop_ms(sampler, loader, REPS)
        sampler.run(loader, test_batch_num=1, pose_source=SAMPLING_SOURCE)
        s_trace = trace(lambda: sampler.run(loader, test_batch_num=1,
                                            pose_source=SAMPLING_SOURCE))
        del sampler

        app = Stage1App(cfg, torch.device("cuda"))
        state = app.init_state()
        tb = batch_to_device(next(loader), app.device)
        train_ms = train_phase_ms(app, state, tb, REPS)
        step_ms = train_step_ms(app, state, loader, REPS)
        train_trace = trace(lambda: app.train_step(state, tb), crop=True)
        trainer = Trainer(cfg, app, loader)
        train_spans = span_profile(lambda: trainer.step(state), REPS)
        del trainer
        del app, state
        stage2 = {m: stage2_profile(cls, Config(platform="",
                                                model_dir=f"{tmp}/m{m}"),
                                    REPS)
                  for m, cls in ((3, Stage2AppApp), (4, Stage2PoseApp))}
        data_cfg = Config(platform="", model_dir=f"{tmp}/m3_data",
                          data_dir=f"{tmp}/data",
                          dataset="Market1501").finalize()
        write_synthetic_tfrecords(data_cfg.data_path, data_cfg.split,
                                  LOADER_PAIRS, cfg.img_H, cfg.img_W,
                                  n_shards=2)
        stage2_loader = stage2_loader_profile(data_cfg, REPS)
    name = torch.cuda.get_device_name(0)
    print(f"[profile] {name}, model 12 {cfg.img_H}x{cfg.img_W} hidden "
          f"{cfg.conv_hidden_num} z {cfg.z_num} batch {cfg.batch_size}")
    _print_spans(f"model 12 batch {cfg.batch_size} (copy in, "
                 "transfer_step, copy out)", transfer_spans, REPS)
    print("[stages] device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items())
        + f" | sum {sum(stages.values()):.3f}")
    print("[loop] host ms: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                         loop.items())
          + f" | sum {sum(loop.values()):.2f}")
    print(f"[trace] one run() batch: wall {trace_12['wall_ms']:.2f} ms, "
          f"device busy {trace_12['device_busy_ms']:.2f} ms (share "
          f"{trace_12['device_busy_share']:.3f}), "
          f"{trace_12['device_events']} device events; pose_raster kernel "
          f"us {trace_12['pose_raster_us']}")
    for row in trace_12["top"]:
        print(f"[trace]   {row['ms']:9.3f} ms  x{row['count']:<4d} "
              f"{row['name']}")
    print(f"[sampling] model 11, sample_app, pose_source {SAMPLING_SOURCE}, "
          f"batch {cfg.batch_size}: device ms: " + ", ".join(
              f"{k} {v:.3f}" for k, v in s_stages.items())
          + f" | sum {sum(s_stages.values()):.3f}")
    print(f"[sampling loop] host ms per run() batch (median of {REPS}): "
          f"sample_step {s_loop['sample_step']:.2f}, rest {s_loop['rest']:.2f}"
          f" | sum {sum(s_loop.values()):.2f}")
    print(f"[sampling trace] one run() batch: wall {s_trace['wall_ms']:.2f} "
          f"ms, device busy {s_trace['device_busy_ms']:.2f} ms (share "
          f"{s_trace['device_busy_share']:.3f}), "
          f"{s_trace['device_events']} device events; pose_raster kernel "
          f"us {s_trace['pose_raster_us']}")
    for row in s_trace["top"]:
        print(f"[sampling trace]   {row['ms']:9.3f} ms  x{row['count']:<4d} "
              f"{row['name']}")
    print(f"[train] model 1, batch {cfg.batch_size}, fast_gan_step="
          f"{cfg.fast_gan_step}: device ms per phase: " + ", ".join(
              f"{k} {v:.3f}" for k, v in train_ms.items())
          + f" | sum {sum(train_ms.values()):.3f}")
    print(f"[train] host ms per step (copy in, step, sync; {REPS} steps): "
          f"median {statistics.median(step_ms):.2f}, all "
          f"{[round(t, 2) for t in step_ms]}; "
          f"{cfg.batch_size * 1e3 / statistics.median(step_ms):.2f} images/s")
    print(f"[train trace] one train_step: wall {train_trace['wall_ms']:.2f} "
          f"ms, device busy {train_trace['device_busy_ms']:.2f} ms (share "
          f"{train_trace['device_busy_share']:.3f}), "
          f"{train_trace['device_events']} device events; ROI crop backward "
          f"({CROP_BACKWARD_OP}) {train_trace['crop_backward_ms']:.3f} ms in "
          f"{train_trace['crop_backward_calls']} calls; pose_raster kernel "
          f"us {train_trace['pose_raster_us']}")
    for row in train_trace["top"]:
        print(f"[train trace]   {row['ms']:9.3f} ms  x{row['count']:<4d} "
              f"{row['name']}")
    _print_spans(f"model 1 batch {cfg.batch_size} (Trainer.step)",
                 train_spans, REPS)
    for m, prof in stage2.items():
        ph, tr = prof["phases_ms"], prof["trace"]
        print(f"[stage2] model {m}, batch {cfg.batch_size}, critic_batch_mode "
              f"{cfg.critic_batch_mode}: device ms per phase: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in ph.items())
              + f" | sum {sum(ph.values()):.3f}")
        print(f"[stage2] model {m} host ms per Trainer step (copy in, noise, "
              f"step, sync; {REPS} steps): median "
              f"{statistics.median(prof['step_ms']):.2f}, all "
              f"{[round(t, 2) for t in prof['step_ms']]}")
        print(f"[stage2 trace] model {m}, one Trainer step: wall "
              f"{tr['wall_ms']:.2f} ms, device busy {tr['device_busy_ms']:.2f}"
              f" ms (share {tr['device_busy_share']:.3f}), "
              f"{tr['device_events']} device events; host-to-device copies "
              f"{tr['h2d_copies']}")
        for row in tr["top"]:
            print(f"[stage2 trace]   {row['ms']:9.3f} ms  x{row['count']:<4d} "
                  f"{row['name']}")
    tr = stage2_loader["trace"]
    print(f"[stage2 loader] model 3 fed by TFRecordPairLoader ({LOADER_PAIRS} "
          f"pairs, JPEG, num_worker {data_cfg.num_worker} "
          f"{data_cfg.worker_mode}): host ms per Trainer step (copy in, "
          f"noise, step, sync; {REPS} steps): median "
          f"{statistics.median(stage2_loader['step_ms']):.2f}, all "
          f"{[round(t, 2) for t in stage2_loader['step_ms']]} (synthetic "
          f"batches: median {statistics.median(stage2[3]['step_ms']):.2f}); "
          f"traced step: wall {tr['wall_ms']:.2f} ms, device busy "
          f"{tr['device_busy_ms']:.2f} ms (share "
          f"{tr['device_busy_share']:.3f}); host-to-device copies "
          f"{tr['h2d_copies']}")
    print(json.dumps({"device": name, "batch_size": cfg.batch_size,
                      "stages_ms": stages, "transfer_spans": transfer_spans,
                      "loop_ms": loop, "trace": trace_12,
                      "sampling_stages_ms": s_stages,
                      "sampling_loop_ms": s_loop, "sampling_trace": s_trace,
                      "train_phase_ms": train_ms,
                      "train_step_ms": step_ms, "train_trace": train_trace,
                      "train_spans": train_spans,
                      "stage2": stage2, "stage2_loader": stage2_loader}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
