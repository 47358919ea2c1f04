"""Where a model-12 batch spends its time on the card (the port's
counterpart of `dpig_tpu/utils/profiling.py`, for the one ported path).

    python -m dpig_tpu_torch.utils.profiling

Runs `ConditionalTransferTester` on the card at full Market width (the
`Config()` defaults: 128x64, hidden 128, z 64, batch 16), cold start,
float32, and prints three breakdowns:

  stages  device time of each layer of `transfer_step` (CUDA events,
          median over REPS after a warm-up): ROI encoder (stem, crop,
          towers), pose raster, generator, D score; with each stage's
          conv and matrix-product FLOPs (FlopCounterMode, from shapes)
          and the achieved rate;
  loop    host time of each part of `run()`'s loop (synchronized): copy
          in, transfer_step, source pose map, copy out, PNG writes, SSIM;
  trace   torch.profiler over one `run()` batch: the device's busy share of
          the batch's wall time and device time by kernel (top 12).

The last line is one JSON object with every number printed. Needs a card.
"""
from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from ..apps.common import batch_to_device, pose_maps_from_batch
from ..apps.testers import ConditionalTransferTester, _save_batch_pngs
from ..config import Config
from ..data.synthetic import SyntheticLoader
from ..eval.metrics import ssim_images
from .viz import pose_to_gray

STAGES = ("encode", "pose_raster", "generate", "disc_score")
LOOP = ("copy_in", "transfer_step", "source_pose", "copy_out", "png_write",
        "ssim")
REPS = 5


@torch.inference_mode()
def stage_flops(tester, jb) -> dict:
    """FLOPs (2 per multiply-add) of the convs and matrix products of each
    stage of transfer_step on batch `jb`, counted from their shapes by
    PyTorch's FlopCounterMode in one forward."""
    from torch.utils.flop_counter import FlopCounterMode

    def count(fn):
        with FlopCounterMode(display=False) as counter:
            out = fn()
        return out, counter.get_total_flops()

    embs, enc = count(lambda: tester._encode_app(jb))
    pose = pose_maps_from_batch(jb, tester.cfg, "pose_rcv_target")
    g_raw, gen = count(lambda: tester._generate(embs, pose))
    _, disc = count(lambda: tester._disc_score(g_raw))
    return {"encode": enc, "generate": gen, "disc_score": disc}


@torch.inference_mode()
def stage_ms(tester, jb, reps: int) -> dict:
    """Median device ms of each layer of transfer_step on batch `jb`."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 1)]
    rows = []
    for _ in range(reps + 1):  # the first is a warm-up
        ev[0].record()
        embs = tester._encode_app(jb)
        ev[1].record()
        pose = pose_maps_from_batch(jb, tester.cfg, "pose_rcv_target")
        ev[2].record()
        g_raw = tester._generate(embs, pose)
        ev[3].record()
        tester._disc_score(g_raw)
        ev[4].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(STAGES))])
    return {s: statistics.median(r[i] for r in rows[1:])
            for i, s in enumerate(STAGES)}


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


def trace_one_batch(tester, loader, top: int = 12) -> dict:
    """torch.profiler over one run() batch: busy share and kernel times."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tester.run(loader, test_batch_num=1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, counts = [], defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] += e.time_range.elapsed_us()
        counts[e.name] += 1
    busy, end = 0.0, -np.inf
    for s, e in sorted(spans):  # union of device intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    kernels = sorted(by_name, key=by_name.get, reverse=True)[:top]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if wall_us else 0.0,
            "device_events": len(spans),
            "top": [{"name": n[:90], "ms": by_name[n] / 1e3,
                     "count": counts[n]} for n in kernels],
            "pose_raster_us": [by_name[n] / counts[n] for n in by_name
                               if "pose_raster" in n]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device; this measures the card")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(platform="", model_dir=tmp)
        tester = ConditionalTransferTester(cfg)
        loader = SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                                 seed=cfg.random_seed)
        jb = batch_to_device(next(loader), tester.device)
        flops = stage_flops(tester, jb)
        stages = stage_ms(tester, jb, REPS)
        dirs = {d: os.path.join(tmp, "loop", d) for d in (
            "x", "x_target", "G", "pose", "pose_target", "mask",
            "mask_target")}
        for d in dirs.values():
            os.makedirs(d)
        loop = loop_ms(tester, loader, dirs, REPS)
        tester.run(loader, test_batch_num=1)  # warm run() before tracing
        trace = trace_one_batch(tester, loader)
    name = torch.cuda.get_device_name(0)
    print(f"[profile] {name}, model 12 {cfg.img_H}x{cfg.img_W} hidden "
          f"{cfg.conv_hidden_num} z {cfg.z_num} batch {cfg.batch_size}")
    print("[stages] device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items())
        + f" | sum {sum(stages.values()):.3f}")
    print("[stages] GFLOP (achieved TFLOP/s): " + ", ".join(
        f"{k} {v / 1e9:.1f} ({v / stages[k] / 1e9:.2f})"
        for k, v in flops.items()))
    print("[loop] host ms: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                         loop.items())
          + f" | sum {sum(loop.values()):.2f}")
    print(f"[trace] one run() batch: wall {trace['wall_ms']:.2f} ms, device "
          f"busy {trace['device_busy_ms']:.2f} ms (share "
          f"{trace['device_busy_share']:.3f}), {trace['device_events']} "
          f"device events; pose_raster kernel us {trace['pose_raster_us']}")
    for row in trace["top"]:
        print(f"[trace]   {row['ms']:9.3f} ms  x{row['count']:<4d} "
              f"{row['name']}")
    print(json.dumps({"device": name, "batch_size": cfg.batch_size,
                      "stages_ms": stages, "stages_flops": flops,
                      "loop_ms": loop, "trace": trace}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
