#!/usr/bin/env python3
"""On-card smoke test of dpig_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and `nvcc`.
Phases, each printing one line; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi); TF32 off for
              cuDNN convs and cuBLAS matmuls, so float32 is float32;
  2. build    every CUDA kernel of the port, from the sources here, with
              ptxas's registers, shared memory and spills per kernel;
  3. kernels  each kernel against its plain PyTorch version on the card at
              the Market shape and at 256x256, in both coordinate modes,
              bit-equal, with kernel / plain times, the card's bound for the
              same work and its share, and `fill_ms`: torch.empty(same
              shape).fill_(-1), the same bytes written by PyTorch, as a
              yardstick of the write rate the card reaches at this size.
              All times are device times (calls captured in a CUDA graph
              and replayed);
  4. slice    model-12 pose transfer (ConditionalTransferTester) at full
              Market width (128x64, hidden 128, z 64, batch 16), cold start,
              4 batches: the PNG tree, finite outputs, and the pose kernel
              launched exactly twice per batch;
  5. parity   the same weights on the card and on the CPU: transfer outputs
              within a stated tolerance, also with PyTorch's TF32 flags on
              (the tester runs float32 whatever they say); the same forward
              past the tester's float32 guard, with TF32 on, must exceed
              the tolerance, which shows the check can see that fault;
  6. train    model-1 Stage-I training through the CLI entry point
              (`dpig_tpu_torch.main --model=1`) at full Market width,
              batch 16, the re-forward D step, TRAIN_STEPS steps with
              log_step TRAIN_LOG_STEP: finite metrics, per-step ms,
              metrics.jsonl at the logged steps, previews and the final
              checkpoint written, the pose kernel launched exactly once per
              step plus once per preview and once for the fixed pose
              preview; then a fresh Trainer on the same model_dir resumes
              at the saved step with params, optimizer moments and BN
              buffers equal to the checkpoint's;
  7. train parity  one train step, batch 2 at full width, on the card and
              on the CPU from the same weights, the card's D step starting
              from the CPU's updated G: the losses, the G and D gradients
              and the D's running statistics within TRAIN_PARITY_TOL, also
              with the TF32 flags on; the same step past the float32 guard,
              TF32 on, must exceed the G gradient tolerance, and the step
              with only its forwards guarded (TF32 in the backward passes
              alone) the D gradient one. Then, with the L1 term alone as
              the G objective, the generator's gradients within
              L1_GRAD_TOL, and TF32 in the backward passes alone must
              exceed it.

  8. sampling  through the CLI entry point at full Market width, cold
              start: model 11 (`--model=11 --sample_app=true
              --pose_source=sampled`, SAMPLING_BATCHES batches of 16): the
              8-directory tree with its G/{idx}_score{s}.png names and
              pose_rcv dumps, finite outputs, per-batch ms, the pose kernel
              launched exactly 3 times per batch (the decoded pose, the
              `pose` and `pose_target` trees; no radius-0 preview) and the
              ROI encoder called 0 times (its output is dead with
              sample_app); model 13 (`--sample_fg=true`, FACTOR_BATCHES
              batches): 1 launch per batch; interpolation
              (`--interpolate_pose=true`, 8 steps): 1 launch;
  9. sampling parity  the model-11 tester's weights on the card and on the
              CPU, batch 2 at full width, the same noise, for each
              pose_source: the mapper embeddings, the decoded rcv, g_raw
              and the D score within SAMPLING_PARITY_TOL (float32, and
              with the TF32 flags on), the decoded visibility and the pose
              maps bit-equal, every decoded keypoint at least FLOOR_MARGIN
              px from a floor boundary, and the CPU's decoded rcv rendered
              by the card kernel bit-equal to the CPU's maps; the mappers
              and the pose AE past their float32 guard with TF32 on must
              exceed the embedding limit and, for a decoded pose, the rcv
              limit.

 10. stage-2 train  the Market training chain through the CLI at full
              width, batch 16, each stage on the port checkpoints of the
              stages before it: model 2 (the pose AE, POSE_AE_STEPS steps;
              the pose kernel launched once, for the fixed pose preview),
              model 3 (`--pretrained_path=` phase 6's model-1 dir,
              STAGE2_STEPS steps, `fresh` batches) and model 4
              (`--pretrained_path=`, `--pretrained_poseAE_path=` model 2's):
              per-step ms, finite metrics, the hist means and deviations in
              metrics.jsonl, every critic parameter within +-0.01 and the
              frozen nets equal to the checkpoints they came from in the
              saved checkpoint, the ROI encoder run exactly 6 times per
              model-3 train step and 0 times per model-4 step (once per
              model-4 preview, never in a model-3 one), the pose kernel
              launched once plus once per preview; then model 11
              (`--sample_app=true --pose_source=sampled`, CHAIN_BATCHES
              batches) with all four `--pretrained_*` flags on those
              model_dirs: no RANDOM-init line, the trained weights loaded,
              the tree written, every score 0 (no D, as in JAX), 3 pose
              launches per batch;
 11. stage-2 parity  one model-3 and one model-4 train step, batch 2 at
              full width, `fresh` batches, the same weights and noise on
              the card and on the CPU, the card's critic iterations started
              where the CPU's were (`train.parity.recorded_train_step`):
              the G and D losses, the mapper and critic gradients and the
              real and fake embeddings within STAGE2_PARITY_TOL, in float32
              and with the TF32 flags on; the step past its float32 guard
              with TF32 on must exceed it on each of them.

 12. data     real data on the card: a Market-format tfrecord dataset at
              128x64 written by the port's `build_pair_example` and writer
              (DATA_TRAIN_PAIRS train, DATA_TEST_PAIRS test pairs, PIL
              JPEGs, pn_pairs_num_*.p); every record read back by the
              native scanner equal to the plain reader's, CRCs verified,
              and parsed bit-equal by `tfr_parse` and the plain decoder;
              the test split's batches identical in order with 0 workers,
              LOADER_WORKERS threads and 2 processes; the loader's
              samples/s on this host; model 12 through the CLI on the test
              split (2 batches, 2 pose launches each; asked for 3, it
              raises StopIteration after the same 2); model 1 (6 steps)
              and model 3 (`fresh`, on phase 6's model-1 dir, 4 steps) on
              the train split, per-step ms and pose launches.

The line before the last is {"kernels": [...]}, with the pose kernel's
launches on each path; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# Non-tensor INT32 peak: the data sheet's 67 TFLOP/s float32 counts an FMA
# as 2 on 128 FP32 lanes per SM; an SM has 64 INT32 lanes (Hopper white
# paper), so 67e12 / 2 / 2 integer operations per second.
INT32_OPS_PER_S = 16.75e12
# Integer operations the pose raster needs: two compares and a select per
# output element, and about 20 per keypoint and row for its column span.
RASTER_OPS_PER_ELEMENT, RASTER_OPS_PER_SPAN = 3, 20
MARKET = dict(b=16, h=128, w=64, k=18)
RASTER_SHAPES = {"Market": MARKET, "256x256": dict(b=16, h=256, w=256, k=18)}
# Card vs CPU limit on max |diff| of g_raw and of the D score, batch 2 at
# full width. Both sides float32; cuDNN and the CPU's conv kernels sum in
# other orders through ~50 conv layers. On an NVIDIA H100 80GB HBM3 at
# 700 W this phase read 2.0e-6 (g_raw) and 1.8e-5 (score) in float32, and
# 6.0e-4 and 4.5e-3 with TF32 on: 1e-4 sits between the two on both, at
# least 5x from each reading (PERF.md, "Card vs CPU").
PARITY_TOL = 1e-4
TRAIN_STEPS, TRAIN_LOG_STEP = 6, 2
SAMPLING_BATCHES, FACTOR_BATCHES, INTERPOLATION_STEPS = 4, 2, 8
# Card vs CPU limits (max |diff|) of the model-11 sampling step, batch 2 at
# full width, the same weights and noise. On an NVIDIA H100 80GB HBM3 at
# 700 W this phase read, float32 and with the TF32 flags on alike: mapper
# embeddings 2.4e-7, decoded rcv 1.2e-7 to 7.2e-7, g_raw 4.1e-6, score
# 2.9e-6 to 2.4e-5; with the mappers and the pose AE past their float32
# guard, TF32 on: embeddings 4.2e-4, rcv 2.7e-4 to 1.3e-3. The embedding
# and rcv limits sit at least 14x from each reading; g_raw and the score
# share the model-12 limit.
SAMPLING_PARITY_TOL = {"embs": 1e-5, "rcv": 1e-5, "g_raw": PARITY_TOL,
                       "score": PARITY_TOL}
# A decoded keypoint this close to a floor boundary could render at
# another pixel on the card than on the CPU (ops.pose.floor_margin).
FLOOR_MARGIN = 1e-3
# Card vs CPU limits for one train step, batch 2 at full width (keys of
# `train.parity.step_errors`). The G-step losses and the G gradients come
# before any update; the card's D step starts from the CPU's updated G
# (the first Adam step is sign-like: a gradient near 0 moves its parameter
# by +-lr by the sign each side computes), so d_loss, the D gradients and
# the D's statistics see only the two sides' own rounding. On an NVIDIA
# H100 80GB HBM3 at 700 W this phase read in three runs, float32 (the
# same with the TF32 flags on): G-step losses 1.1e-6, d_loss 2.0e-6 to
# 3.2e-6, Encoder 1.0e-3, ID_AE 1.3e-3, Discriminator 5.7e-6 to 6.0e-6,
# d_stats 6.6e-7 to 7.2e-7. Past the float32 guard with TF32 on: 1.6e-3,
# 1.8e-4 to 1.3e-3, 8.9e-2, 9.9e-2, 3.4e-2 to 4.1e-2, 1.8e-4 to 2.3e-4.
# TF32 in the backward passes alone: Discriminator 8.5e-4 to 8.7e-4, the
# rest as in float32. The G gradients of this model are only good to ~1e-3 in
# float32 at batch 2 (the CPU's float32 against its float64: 1.7e-3 for
# the adversarial term, scripts/port_grad_precision.py), so a TF32
# backward hides in them; the D gradients and the L1 term below show it.
TRAIN_PARITY_TOL = {"g_step_losses": 1e-5, "d_loss": 1e-5, "Encoder": 5e-3,
                    "ID_AE": 5e-3, "Discriminator": 1e-4, "d_stats": 1e-5}
# The generator's gradients of the L1 term alone (adversarial term
# weighted 0): 2.4e-5 in float32 and with the TF32 flags on, 4.9e-4 with
# TF32 in the backward passes alone (same card). The encoder's read
# 8.1e-4 and 1.1e-3 and are shown, not checked.
L1_GRAD_TOL = {"ID_AE": 1e-4}
G_NETS = ("Encoder", "ID_AE")
POSE_AE_STEPS, POSE_AE_LOG_STEP = 10, 5
STAGE2_STEPS, STAGE2_LOG_STEP, CHAIN_BATCHES = 4, 1, 2
# Card vs CPU limit on every error of one Stage-II train step (keys of
# `train.parity.step_errors`: losses relative, gradients ||diff|| / ||grad||
# and max|diff| / max|grad|, embeddings max |diff|), batch 2 at full width,
# models 3 and 4. On an NVIDIA H100 80GB HBM3 at 700 W this phase read at
# most 8.5e-7 in float32 and with the TF32 flags on (losses 0 to 5.3e-7,
# gradients 1.3e-7 to 8.5e-7, embeddings 1.2e-7 to 4.8e-7), and at least
# 8.0e-5 past the float32 guard with TF32 on (model 4's G loss 8.0e-5,
# model 3's real FG embeddings 8.7e-5, the gradients 1.3e-2 to 5.0e-1): so
# 1e-5, at least 8x from each reading, and the control must exceed it on
# every key.
STAGE2_PARITY_TOL = 1e-5
DATA_TRAIN_PAIRS, DATA_TEST_PAIRS = 96, 40
LOADER_WORKERS, LOADER_RATE_BATCHES = 4, 12


def _graph_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """Device time of one call: `inner` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events (median), so the host's
    launch cost is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as required
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi, flush=True)
    print(f"[device] {name} | nvidia-smi: {smi} | count "
          f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    return name


def phase_build():
    """The CUDA kernel (nvcc) and the host tfrecord parser (g++), built at
    once, each by its own compiler process."""
    from concurrent.futures import ThreadPoolExecutor
    from dpig_tpu_torch.kernels import _build
    sources = {"pose_raster": ("pose_raster.cu", _build.load),
               "tfrecord_scanner": ("tfrecord_scanner.cc", _build.load_host)}

    def build(lib):
        source, load = sources[lib]
        fresh = not os.path.exists(_build.library_path(lib, source))
        t0 = time.perf_counter()
        load(lib)
        return fresh, time.perf_counter() - t0

    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources)))
    for lib, (fresh, secs) in built.items():
        print(f"[build] {sources[lib][0]}: "
              f"{'built' if fresh else 'cached library'} and loaded in "
              f"{secs:.2f} s", flush=True)
    name = "pose_raster"
    ptxas = [ln.split(":", 1)[-1].strip() for ln in
             _build.build_log(name).splitlines()
             if "Used" in ln or "spill" in ln]
    print(f"[build] {name} ptxas -v: {' | '.join(ptxas) or 'not reported'}"
          f"; shared memory: dynamic only, K*8 B per block (144 B at K=18)",
          flush=True)


def _rcv(rng, shape, normalized):
    b, h, w, k = (shape[x] for x in "bhwk")
    if normalized:
        r = rng.uniform(-1.2, 1.2, (b, k))
        c = rng.uniform(-1.2, 1.2, (b, k))
    else:  # includes keypoints outside the image
        r = rng.uniform(-8, h + 8, (b, k))
        c = rng.uniform(-8, w + 8, (b, k))
    v = (rng.uniform(size=(b, k)) > 0.2).astype(np.float32)
    rcv = np.stack([r, c, v], -1).astype(np.float32).reshape(b, k * 3)
    return torch.from_numpy(rcv).cuda()


def _raster_bound_ms(b, h, w, k):
    """(bound, "bytes" or "operations"): each input read once, the output
    written once, at the data sheet's rates."""
    bytes_ms = (b * k * 3 * 4 + b * h * w * k * 4) / HBM_BYTES_PER_S * 1e3
    ops = (b * h * w * k * RASTER_OPS_PER_ELEMENT
           + b * h * k * RASTER_OPS_PER_SPAN)
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def phase_kernels():
    from dpig_tpu_torch.kernels.pose_raster import render_pose_maps_cuda
    from dpig_tpu_torch.ops.pose import render_pose_maps_plain
    rng = np.random.default_rng(0)
    rows = []
    for label, shape in RASTER_SHAPES.items():
        b, h, w, k = (shape[x] for x in "bhwk")
        bound_ms, bound_by = _raster_bound_ms(b, h, w, k)

        def fill():
            return torch.empty((b, h, w, k), device="cuda").fill_(-1.0)

        fills = [_graph_ms(fill)]
        for normalized in (False, True):
            rcv = _rcv(rng, shape, normalized)
            out = render_pose_maps_cuda(rcv, h, w, k, 4, normalized)
            ref = render_pose_maps_plain(rcv, h, w, k, 4, normalized)
            torch.cuda.synchronize()
            equal = bool(torch.equal(out, ref))
            err = float((out - ref).abs().max())
            on = float((out > 0).float().mean())

            def kernel():
                return render_pose_maps_cuda(rcv, h, w, k, 4, normalized)

            def plain():
                return render_pose_maps_plain(rcv, h, w, k, 4, normalized)

            ms, plain_ms = _graph_ms(kernel), _graph_ms(plain)
            mode = "normalized" if normalized else "pixel"
            rows.append(dict(shape=label, mode=mode, bit_equal=equal,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             share_of_bound=bound_ms / ms))
            print(f"[kernels] pose_raster {mode} coords B={b} {h}x{w} K={k}: "
                  f"bit_equal={equal} max_abs_err={err} on_fraction={on:.4f} "
                  f"| device time (CUDA graph): kernel {ms * 1e3:.3f} us, "
                  f"plain {plain_ms * 1e3:.3f} us, bound {bound_ms * 1e3:.3f} "
                  f"us ({bound_by}), kernel at {bound_ms / ms:.1%} of it",
                  flush=True)
            if not equal:
                raise AssertionError(f"pose_raster ({mode}, {label}) differs "
                                     f"from its plain version: max abs err "
                                     f"{err}")
        fills.append(_graph_ms(fill))
        for row in rows[-2:]:
            row["fill_ms"] = min(fills)
        print(f"[kernels] fill_ yardstick {label} {(b, h, w, k)}: "
              f"{fills[0] * 1e3:.3f} us before the kernels, "
              f"{fills[1] * 1e3:.3f} us after; {b * h * w * k * 4} B, "
              f"{b * h * w * k * 4 / min(fills) / 1e6:.1f} GB/s at the "
              f"faster", flush=True)
    main = rows[0]   # Market, pixel coords: the main path's call
    return {"name": "pose_raster", "route": "cuda",
            "source": "dpig_tpu_torch/csrc/pose_raster.cu",
            "replaces": "dpig_tpu/ops/pose_pallas.py:72",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "bit_equal": main["bit_equal"],
            "fill_ms": main["fill_ms"], "shapes": rows}


def phase_slice(model_dir):
    from dpig_tpu_torch.apps.testers import ConditionalTransferTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.kernels import pose_raster

    n_batches = 4
    cfg = Config(platform="", model_dir=model_dir)
    if (cfg.img_H, cfg.img_W, cfg.conv_hidden_num, cfg.z_num,
            cfg.batch_size, cfg.repeat_num) != (128, 64, 128, 64, 16, 5):
        raise AssertionError("Config() defaults are not the Market model")
    tester = ConditionalTransferTester(cfg)
    step = tester.transfer_step
    starts, outputs = [], []

    def recorded_step(batch):
        starts.append(time.perf_counter())
        out = step(batch)
        outputs.append(out)
        return out

    tester.transfer_step = recorded_step
    loader = SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                             seed=cfg.random_seed)
    pose_raster.launches = 0
    out_root = tester.run(loader, test_batch_num=n_batches)
    torch.cuda.synchronize()
    launches = pose_raster.launches
    end = time.perf_counter()

    batch_ms = [(t1 - t0) * 1e3 for t0, t1 in zip(starts, starts[1:] + [end])]
    counts = {d: len(os.listdir(os.path.join(out_root, d)))
              for d in sorted(os.listdir(out_root))}
    finite = all(bool(torch.isfinite(t).all()) for o in outputs for t in o)
    g = outputs[-1][0]
    print(f"[slice] model 12 {cfg.img_H}x{cfg.img_W} hidden "
          f"{cfg.conv_hidden_num} z {cfg.z_num} batch {cfg.batch_size}: "
          f"{n_batches} batches, pose kernel launches {launches}, PNGs "
          f"{counts}, finite={finite}, G shape {tuple(g.shape)}, per-batch "
          f"ms after the first {[round(x, 2) for x in batch_ms[1:]]} "
          f"(first {batch_ms[0]:.1f})", flush=True)
    if launches != 2 * n_batches:
        raise AssertionError(f"pose kernel launched {launches} times, "
                             f"expected {2 * n_batches}")
    if len(counts) != 7 or set(counts.values()) != {n_batches * cfg.batch_size}:
        raise AssertionError(f"PNG tree {counts}")
    if not finite or g.shape != (cfg.batch_size, cfg.img_H, cfg.img_W, 3):
        raise AssertionError("non-finite or mis-shaped transfer outputs")
    return tester, launches


def _raw_outputs(tester, batch):
    """(g_raw, score) of transfer_step before the [0,255] clip."""
    from dpig_tpu_torch.apps.common import (batch_to_device,
                                            pose_maps_from_batch)
    with torch.inference_mode():
        jb = batch_to_device(batch, tester.device)
        embs = tester._encode_app(jb)
        pose = pose_maps_from_batch(jb, tester.cfg, "pose_rcv_target")
        g_raw = tester._generate(embs, pose)
        return g_raw.cpu(), tester._disc_score(g_raw).cpu()


def _raw_outputs_unguarded(tester, batch):
    """The same forward with the modules called straight, past Stage1App's
    float32 guard, so that the caller's TF32 flags reach cuDNN/cuBLAS."""
    from dpig_tpu_torch.apps.common import (batch_to_device,
                                            pose_maps_from_batch,
                                            select_parts)
    s1, cfg = tester.stage1, tester.cfg
    with torch.inference_mode():
        jb = batch_to_device(batch, tester.device)
        bbox, vis = select_parts(jb["part_bbox"], jb["part_vis"],
                                 cfg.roi_part_num)
        embs = s1.encoder(jb["x"], jb["mask_r6"], bbox, vis)
        g_raw, _ = s1.generator(
            embs, pose_maps_from_batch(jb, cfg, "pose_rcv_target"))
        return g_raw.cpu(), s1.disc(g_raw, train=True).cpu()


def _set_tf32(on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def phase_parity(card_tester, model_dir):
    from dpig_tpu_torch.apps.testers import ConditionalTransferTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    s1 = card_tester.stage1
    state = {"Encoder": s1.encoder.state_dict(),
             "ID_AE": s1.generator.state_dict(),
             "Discriminator": s1.disc.state_dict(),
             "Discriminator_stats": {}}
    state = {k: {n: t.cpu() for n, t in v.items()} for k, v in state.items()}
    cpu_tester = ConditionalTransferTester(
        Config(platform="cpu", model_dir=model_dir), params=state)
    batch = next(SyntheticLoader(2, 128, 64, seed=99))
    g_cpu, s_cpu = _raw_outputs(cpu_tester, batch)

    def diff(outs):
        return (float((outs[0] - g_cpu).abs().max()),
                float((outs[1] - s_cpu).abs().max()))

    sound = diff(_raw_outputs(card_tester, batch))          # TF32 flags off
    _set_tf32(True)  # PyTorch's default for cuDNN convs
    try:
        guarded = diff(_raw_outputs(card_tester, batch))
        tf32 = diff(_raw_outputs_unguarded(card_tester, batch))
    finally:
        _set_tf32(False)
    print(f"[parity] card vs CPU, batch 2 at full width, max|diff| of "
          f"(g_raw, score): float32 {sound[0]:.3e}, {sound[1]:.3e}; with the "
          f"TF32 flags on {guarded[0]:.3e}, {guarded[1]:.3e}; TF32 past the "
          f"guard (control) {tf32[0]:.3e}, {tf32[1]:.3e}; tolerance "
          f"{PARITY_TOL} (max|g_raw| {float(g_cpu.abs().max()):.3f}, "
          f"max|score| {float(s_cpu.abs().max()):.3f})", flush=True)
    if max(sound + guarded) > PARITY_TOL:
        raise AssertionError("card and CPU disagree beyond the tolerance")
    if min(tf32) <= PARITY_TOL:
        raise AssertionError("a TF32 run passes the tolerance: the parity "
                             "check cannot tell TF32 from float32")


def _run_cli(argv):
    """`dpig_tpu_torch.main.main(argv)` with the pose kernel's launch count
    set to 0 just before -> (launches, wall s)."""
    from dpig_tpu_torch import main as port_main
    from dpig_tpu_torch.kernels import pose_raster
    pose_raster.launches = 0
    t0 = time.perf_counter()
    port_main.main(argv)
    torch.cuda.synchronize()
    return pose_raster.launches, time.perf_counter() - t0


def phase_sampling(model_dir):
    """Models 11 and 13 and interpolation through the CLI entry point at
    full Market width, cold start -> (the model-11 tester, launches per
    path)."""
    from dpig_tpu_torch.apps.testers import FullSamplingTester
    from dpig_tpu_torch.models.encoders import RoiEncoderFgBg
    common = ["--is_train=false", "--synthetic_data=true",
              f"--model_dir={model_dir}"]
    step = FullSamplingTester.sample_step
    starts, outputs, seen = [], [], []
    encoder_calls = [0]

    def recorded_step(self, batch, noise, pose_source="real"):
        starts.append(time.perf_counter())
        out = step(self, batch, noise, pose_source)
        outputs.append(out)
        seen.append(self)
        return out

    def count_encoder(module, args, out):
        if isinstance(module, RoiEncoderFgBg):
            encoder_calls[0] += 1

    FullSamplingTester.sample_step = recorded_step
    hook = torch.nn.modules.module.register_module_forward_hook(count_encoder)
    try:
        launches, wall = _run_cli(
            ["--model=11", "--sample_app=true", "--pose_source=sampled",
             f"--test_batch_num={SAMPLING_BATCHES}", *common])
    finally:
        hook.remove()
        FullSamplingTester.sample_step = step
    end = time.perf_counter()
    tester, cfg = seen[0], seen[0].cfg
    if (cfg.img_H, cfg.img_W, cfg.conv_hidden_num, cfg.z_num, cfg.batch_size,
            tester.fg_dim) != (128, 64, 128, 64, 16, 224):
        raise AssertionError("Config() defaults are not the Market model")
    out_root = os.path.join(model_dir, f"test_result_SampleAppTruePose-"
                            f"sampled_{SAMPLING_BATCHES}x{cfg.batch_size}")
    counts = {d: len(os.listdir(os.path.join(out_root, d)))
              for d in sorted(os.listdir(out_root))}
    g_names = sorted(os.listdir(os.path.join(out_root, "G")))
    dumps = sorted(f for f in os.listdir(os.path.join(out_root, "G_pose"))
                   if f.endswith(".npy"))
    finite = all(bool(torch.isfinite(t).all()) for o in outputs for t in o)
    batch_ms = [(t1 - t0) * 1e3 for t0, t1 in zip(starts, starts[1:] + [end])]
    n_img = SAMPLING_BATCHES * cfg.batch_size
    print(f"[sampling] model 11 (CLI, sample_app, pose_source=sampled) "
          f"{cfg.img_H}x{cfg.img_W} hidden {cfg.conv_hidden_num} z "
          f"{cfg.z_num} batch {cfg.batch_size}: {SAMPLING_BATCHES} batches "
          f"in {wall:.1f} s, pose kernel launches {launches}, ROI encoder "
          f"calls {encoder_calls[0]}, files {counts}, G names "
          f"{g_names[0]} ..., rcv dumps {dumps}, finite={finite}; per-batch "
          f"ms after the first {[round(x, 2) for x in batch_ms[1:]]} (first "
          f"{batch_ms[0]:.1f})", flush=True)
    if launches != 3 * SAMPLING_BATCHES:
        raise AssertionError(f"model 11: pose kernel launched {launches} "
                             f"times, expected {3 * SAMPLING_BATCHES}")
    if encoder_calls[0] != 0:
        raise AssertionError(f"model 11 with sample_app ran the ROI encoder "
                             f"{encoder_calls[0]} times")
    want = {d: n_img for d in ("mask", "mask_target", "pose", "pose_target",
                               "x", "x_target", "G")}
    want["G_pose"] = n_img + min(SAMPLING_BATCHES, 4)
    if counts != want or len(dumps) != min(SAMPLING_BATCHES, 4) or not all(
            "_score" in n for n in g_names):
        raise AssertionError(f"model 11 tree {counts}, dumps {dumps}")
    if not finite or len(outputs) != SAMPLING_BATCHES:
        raise AssertionError("model 11: non-finite outputs or a step short")

    factor, wall13 = _run_cli(["--model=13", "--sample_fg=true",
                               f"--test_batch_num={FACTOR_BATCHES}", *common])
    root13 = os.path.join(model_dir, "test_result_ROI7_SampleFgTrueSampleBg"
                          f"FalseSamplePoseFalse_pretrain_{FACTOR_BATCHES}x"
                          f"{cfg.batch_size}")
    counts13 = {d: len(os.listdir(os.path.join(root13, d)))
                for d in sorted(os.listdir(root13))}
    interp, wall_i = _run_cli(["--model=11", "--interpolate_pose=true",
                               *common])
    png = os.path.join(model_dir, "test_result_interpolate",
                       "interpolation.png")
    print(f"[sampling] model 13 (--sample_fg=true): {FACTOR_BATCHES} batches "
          f"in {wall13:.1f} s, pose kernel launches {factor}, files "
          f"{counts13}; interpolation (--interpolate_pose=true, "
          f"{INTERPOLATION_STEPS} steps) in {wall_i:.1f} s: pose kernel "
          f"launches {interp}, {png} written: {os.path.exists(png)}",
          flush=True)
    if factor != FACTOR_BATCHES or counts13 != {
            d: FACTOR_BATCHES * cfg.batch_size for d in ("G", "pose", "x")}:
        raise AssertionError(f"model 13: {factor} launches, tree {counts13}")
    if interp != 1 or not os.path.exists(png):
        raise AssertionError(f"interpolation: {interp} launches")
    return tester, {"model 11 sampling": launches,
                    "model 13 factor sampling": factor,
                    "interpolation": interp}


def _sampling_raw(tester, batch, noise, pose_source, guarded=True):
    """(mapper embeddings, rcv, pose maps, g_raw, score) of the model-11
    step with sample_app, copied to the CPU. `guarded=False` calls the
    mappers and the pose AE straight, past their float32 guard, so the
    caller's TF32 flags reach cuBLAS."""
    from dpig_tpu_torch.apps.common import batch_to_device
    from dpig_tpu_torch.models.pose_ae import assemble_pose_rcv
    from dpig_tpu_torch.ops.pose import pose_rcv_normalize, render_pose_maps
    cfg, m = tester.cfg, tester.mappers
    with torch.inference_mode():
        jb = batch_to_device(batch, tester.device)
        noise = {k: v.to(tester.device) for k, v in noise.items()}
        if guarded:
            embs = torch.cat([tester._map("Gaussian_FC_Fg", noise["fg"]),
                              tester._map("Gaussian_FC_Bg", noise["bg"])], -1)
            maps, rcv = tester._pose_maps(jb, noise["pose"], pose_source)
        else:
            embs = torch.cat([m["Gaussian_FC_Fg"](noise["fg"]),
                              m["Gaussian_FC_Bg"](noise["bg"])], -1)
            if pose_source == "real":
                maps, rcv = tester._pose_maps(jb, noise["pose"], "real")
            else:
                if pose_source == "sampled":
                    z = m["PoseGaussian"](noise["pose"])
                else:
                    rcv_norm = pose_rcv_normalize(jb["pose_rcv"], cfg.img_H,
                                                  cfg.img_W)
                    flat = rcv_norm.reshape(rcv_norm.shape[0], -1)
                    z = tester.pose_ae.encoder(flat)
                rcv = assemble_pose_rcv(*tester.pose_ae.decoder(z))
                maps = render_pose_maps(rcv, cfg.img_H, cfg.img_W,
                                        cfg.keypoint_num, 4, True)
        g_raw = tester._generate(embs, maps)
        return {"embs": embs.cpu(), "rcv": rcv.cpu(), "maps": maps.cpu(),
                "g_raw": g_raw.cpu(), "score": tester._disc_score(g_raw).cpu()}


def phase_sampling_parity(card_tester, model_dir):
    from dpig_tpu_torch.apps.testers import FullSamplingTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.ops.pose import floor_margin, render_pose_maps
    cfg = card_tester.cfg
    if not cfg.sample_app:
        raise AssertionError("the sampling parity needs the sample_app tester")
    cpu_tester = FullSamplingTester(
        Config(platform="cpu", sample_app=True, batch_size=2,
               model_dir=model_dir), params=card_tester.cpu_state())
    batch = next(SyntheticLoader(2, 128, 64, seed=98))
    noise = cpu_tester.draw_noise(torch.Generator().manual_seed(0), 2)
    failures, lines = [], []
    for source in ("real", "reconstructed", "sampled"):
        ref = _sampling_raw(cpu_tester, batch, noise, source)
        runs = {"float32": (False, True), "TF32 flags on": (True, True),
                "control: mappers and pose AE past the guard, TF32": (True,
                                                                      False)}
        errs = {}
        for label, (tf32, guarded) in runs.items():
            _set_tf32(tf32)
            try:
                got = _sampling_raw(card_tester, batch, noise, source, guarded)
            finally:
                _set_tf32(False)
            errs[label] = {k: float((got[k] - ref[k]).abs().max())
                           for k in SAMPLING_PARITY_TOL}
            if guarded:
                if not torch.equal(got["maps"], ref["maps"]):
                    failures.append(f"{source}, {label}: pose maps differ")
                if not torch.equal(got["rcv"][..., 2], ref["rcv"][..., 2]):
                    failures.append(f"{source}, {label}: decoded vis differ")
                failures += [f"{source}, {label}: {k} {v:.3e}"
                             for k, v in errs[label].items()
                             if v > SAMPLING_PARITY_TOL[k]]
            else:
                seen = ("embs",) if source == "real" else ("embs", "rcv")
                failures += [f"{source}: TF32 past the guard passes the {k} "
                             f"limit" for k in seen
                             if errs[label][k] <= SAMPLING_PARITY_TOL[k]]
        note = ""
        if source != "real":
            margin = floor_margin(ref["rcv"], 128, 64)
            kernel = render_pose_maps(ref["rcv"].cuda(), 128, 64, 18, 4,
                                      True).cpu()
            same = bool(torch.equal(kernel, ref["maps"]))
            note = (f"; floor margin {margin:.4f} px, card kernel on the "
                    f"CPU's rcv bit-equal: {same}")
            if margin < FLOOR_MARGIN or not same:
                failures.append(f"{source}: floor margin {margin} or kernel "
                                f"on the CPU's rcv differs")
        lines.append(f"[sampling parity] {source}: " + "; ".join(
            f"{label} " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
            for label, e in errs.items()) + note)
    for line in lines:
        print(line, flush=True)
    print(f"[sampling parity] card vs CPU, model 11 with sample_app, batch 2 "
          f"at full width (max |diff|; max|embs| "
          f"{float(ref['embs'].abs().max()):.3f}); tolerances "
          f"{SAMPLING_PARITY_TOL}; pose maps and decoded vis bit-equal",
          flush=True)
    if failures:
        raise AssertionError("; ".join(failures))


def _previews(max_step: int, log_step: int) -> int:
    """Previews of a Trainer run from step 0 to max_step: step 0 and every
    3 * log_step steps (train/harness.py)."""
    every = 3 * log_step
    return sum(1 for s in range(max_step) if s == 0 or s % every == every - 1)


def _expected_train_launches(cfg) -> int:
    """Pose-kernel launches of a model-1 Trainer run from step 0 to
    cfg.max_step: one per train step, one for the fixed pose preview, one
    per preview."""
    return cfg.max_step + 1 + _previews(cfg.max_step, cfg.log_step)


def phase_train(model_dir):
    """Model 1 through the CLI entry point at full width, then a fresh
    Trainer on the same model_dir auto-resumes from the checkpoint."""
    from dpig_tpu_torch import main as port_main
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.kernels import pose_raster
    from dpig_tpu_torch.train import checkpoint as ckpt
    from dpig_tpu_torch.train.harness import Trainer

    argv = ["--model=1", "--synthetic_data=true",
            f"--max_step={TRAIN_STEPS}", f"--log_step={TRAIN_LOG_STEP}",
            f"--model_dir={model_dir}"]
    step_ms, metrics_seen = [], []
    train_step = Stage1App.train_step

    def timed_step(app, state, batch):  # synchronized, so ms are the card's
        t0 = time.perf_counter()
        metrics = train_step(app, state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics_seen.append({k: float(v) for k, v in metrics.items()})
        return metrics

    Stage1App.train_step = timed_step
    try:
        pose_raster.launches = 0
        t0 = time.perf_counter()
        port_main.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pose_raster.launches
    finally:
        Stage1App.train_step = train_step

    cfg = Config(model_dir=model_dir, max_step=TRAIN_STEPS,
                 log_step=TRAIN_LOG_STEP)
    if (cfg.img_H, cfg.img_W, cfg.conv_hidden_num, cfg.z_num,
            cfg.batch_size, cfg.fast_gan_step) != (128, 64, 128, 64, 16,
                                                   False):
        raise AssertionError("Config() defaults are not the Market model")
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    files = sorted(os.listdir(model_dir))
    previews = [f for f in files if "_G_ssim" in f]
    saved = ckpt.latest_checkpoint(model_dir)
    expected = _expected_train_launches(cfg)
    finite = all(np.isfinite(v) for m in metrics_seen for v in m.values())
    print(f"[train] model 1 {cfg.img_H}x{cfg.img_W} hidden "
          f"{cfg.conv_hidden_num} z {cfg.z_num} batch {cfg.batch_size}, "
          f"{TRAIN_STEPS} steps, log_step {TRAIN_LOG_STEP}: wall {wall:.1f} "
          f"s; per-step ms after the first "
          f"{[round(x, 2) for x in step_ms[1:]]} (first {step_ms[0]:.1f}); "
          f"{cfg.batch_size * 1e3 / statistics.median(step_ms[1:]):.2f} "
          f"images/s at the median; metrics.jsonl steps "
          f"{[r['step'] for r in logged]}; L1Loss "
          f"{[round(m['L1Loss'], 4) for m in metrics_seen]}; finite={finite}"
          f"; previews {previews}; checkpoint {saved}; pose kernel launches "
          f"{launches} (expected {expected})", flush=True)
    if launches != expected:
        raise AssertionError(f"pose kernel launched {launches} times, "
                             f"expected {expected}")
    if not finite or len(metrics_seen) != TRAIN_STEPS:
        raise AssertionError(f"train metrics {metrics_seen}")
    want_steps = [s for s in range(TRAIN_STEPS)
                  if s == 0 or s % TRAIN_LOG_STEP == TRAIN_LOG_STEP - 1]
    if [r["step"] for r in logged] != want_steps or not all(
            np.isfinite(v) for r in logged for v in r.values()):
        raise AssertionError(f"metrics.jsonl {logged}")
    if len(previews) != expected - TRAIN_STEPS - 1 or not {
            "x_fixed.png", "pose_fixed.png", "mask_fixed.png"} <= set(files):
        raise AssertionError(f"preview files {files}")
    if saved is None or not saved.endswith(f"step_{TRAIN_STEPS:08d}"):
        raise AssertionError(f"checkpoint {saved}")

    app = Stage1App(cfg, torch.device("cuda"))  # fresh weights, same seed
    loader = SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W)
    resumed = ckpt.state_tree(Trainer(cfg, app, loader).init_state())
    stored = torch.load(os.path.join(saved, ckpt.STATE_FILE),
                        map_location="cpu", weights_only=True)
    unequal = _tree_differences(resumed, stored)
    print(f"[train] resume: a fresh Trainer on the model_dir starts at step "
          f"{resumed['step']}; params, optimizer moments and BN buffers "
          f"equal to the checkpoint's: {not unequal}", flush=True)
    if resumed["step"] != TRAIN_STEPS or unequal:
        raise AssertionError(f"resume differs from the checkpoint: "
                             f"{unequal[:5]}")
    return launches


def _tree_differences(got, want, path=""):
    """Paths where two checkpoint trees differ (tensors bit for bit)."""
    if isinstance(want, dict):
        if set(got) != set(want):
            return [path]
        return [d for k in want
                for d in _tree_differences(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, torch.Tensor):
        return [] if torch.equal(got, want) else [path]
    return [] if got == want else [path]


def _train_step_unguarded(app, state, batch, mark):
    """Stage1App.train_step with the modules called straight, past the
    float32 guard, so that the caller's TF32 flags reach cuDNN and cuBLAS
    in the forwards and in the backward passes."""
    from dpig_tpu_torch.apps.common import l1_loss, masked_l1_loss
    from dpig_tpu_torch.losses import gan
    x, pose, mask, bbox, vis = app.step_inputs(batch)
    g_raw, _ = app.generator(app.encoder(x, mask, bbox, vis), pose)
    adv = gan.g_loss("dcgan", app.disc(g_raw))
    l1 = l1_loss(g_raw, x)
    g_total = adv + app.cfg.L1Loss_weight * l1
    state.g_opt.step(torch.autograd.grad(g_total, state.g_params))
    mark("g_update")
    with torch.no_grad():
        fake, _ = app.generator(app.encoder(x, mask, bbox, vis), pose)
    d_total = gan.d_loss("dcgan", app.disc(x, update_stats=True),
                         app.disc(fake, update_stats=True))
    state.d_opt.step(torch.autograd.grad(d_total, state.d_params))
    state.step += 1
    metrics = {"g_loss": g_total, "g_loss_only": adv, "d_loss": d_total,
               "L1Loss": l1, "PoseMaskLoss": masked_l1_loss(g_raw, x, mask)}
    return {k: v.detach() for k, v in metrics.items()}


@contextlib.contextmanager
def _l1_term_only():
    """The G objective with its adversarial term weighted 0, so that the G
    gradients are the L1 term's alone (the D still runs in the G step)."""
    from dpig_tpu_torch.losses import gan
    g_loss = gan.g_loss
    gan.g_loss = lambda mode, d_fake: 0.0 * g_loss(mode, d_fake)
    try:
        yield
    finally:
        gan.g_loss = g_loss


def phase_train_parity(model_dir):
    """One train step, batch 2 at full width, default variant, from the
    same weights on the card and on the CPU, the card's D step from the
    CPU's updated G: float32, with the TF32 flags on, and two controls with
    TF32 on (past the float32 guard; the forwards alone guarded, so TF32 in
    the backward passes alone). Then the same with the L1 term alone as
    the G objective (see TRAIN_PARITY_TOL)."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.train.parity import recorded_train_step, step_errors
    batch = next(SyntheticLoader(2, 128, 64, seed=99))
    cfgs = {p: Config(platform=p, batch_size=2, model_dir=model_dir)
            for p in ("", "cpu")}
    runs = {"float32": (False, None), "TF32 flags on": (True, None),
            "control: past the guard, TF32": (True, _train_step_unguarded),
            "control: forwards guarded only, TF32": (
                True, Stage1App.train_step.__wrapped__)}
    errs = {}
    for term, context in (("G objective", contextlib.nullcontext),
                          ("L1 term", _l1_term_only)):
        with context():
            ref = recorded_train_step(
                Stage1App(cfgs["cpu"], torch.device("cpu")), batch)
            for label, (tf32, step_fn) in runs.items():
                if term == "L1 term" and "past the guard" in label:
                    continue
                _set_tf32(tf32)
                try:
                    got = recorded_train_step(
                        Stage1App(cfgs[""], torch.device("cuda")), batch,
                        step_fn, g_updated=ref.g_updated)
                finally:
                    _set_tf32(False)
                errs[term, label] = step_errors(ref, got)
            del ref, got
    tols = {"G objective": TRAIN_PARITY_TOL, "L1 term": L1_GRAD_TOL}
    for (term, label), e in errs.items():
        print(f"[train parity] {term}, {label}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in e.items()
            if term == "G objective" or k.split()[0] in G_NETS), flush=True)
    print(f"[train parity] card vs CPU, one step, batch 2 at full width "
          f"(losses: relative diff; sub-nets: gradient ||diff|| / ||grad||, "
          f"'max': max|diff| / max|grad|; d_stats: max abs diff); "
          f"tolerances {tols}", flush=True)
    for term, tol in tols.items():
        for label in ("float32", "TF32 flags on"):
            if any(errs[term, label][k] > t for k, t in tol.items()):
                raise AssertionError(f"card and CPU train steps disagree "
                                     f"beyond the tolerances ({term}, "
                                     f"{label})")
    guarded_forwards = "control: forwards guarded only, TF32"
    for term, label, keys in (
            ("G objective", "control: past the guard, TF32", G_NETS),
            ("G objective", guarded_forwards, ("Discriminator",)),
            ("L1 term", guarded_forwards, ("ID_AE",))):
        if any(errs[term, label][k] <= tols[term][k] for k in keys):
            raise AssertionError(f"a TF32 train step passes the {keys} "
                                 f"gradient tolerance ({term}, {label}): "
                                 f"the check cannot see TF32")


def phase_stage2_train(tmp, m1_dir):
    """Models 2, 3 and 4 through the CLI, chained on the port's own
    checkpoints, then model 11 on all four -> launches per path."""
    from dpig_tpu_torch.apps.stage1_pose import Stage1PoseApp
    from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
    from dpig_tpu_torch.apps.stage2_pose import Stage2PoseApp
    from dpig_tpu_torch.apps.testers import FullSamplingTester
    from dpig_tpu_torch.models.encoders import RoiEncoderFgBg
    from dpig_tpu_torch.train import checkpoint as ckpt
    dirs = {m: os.path.join(tmp, f"m{m}") for m in (2, 3, 4, 11)}
    encoder_calls = [0]
    steps = {2: [], 3: [], 4: []}  # (ms, encoder calls, finite) per step
    testers = []

    def count_encoder(module, args, out):
        if isinstance(module, RoiEncoderFgBg):
            encoder_calls[0] += 1

    def timed(model, step):
        def run(app, state, *args):  # synchronized, so ms are the card's
            calls, t0 = encoder_calls[0], time.perf_counter()
            out = step(app, state, *args)
            torch.cuda.synchronize()
            steps[model].append(((time.perf_counter() - t0) * 1e3,
                                 encoder_calls[0] - calls,
                                 all(bool(torch.isfinite(v).all())
                                     for v in out.values())))
            return out
        return run

    def recorded_sample_step(self, *args, **kwargs):
        testers.append(self)
        return sample_step(self, *args, **kwargs)

    classes = {2: Stage1PoseApp, 3: Stage2AppApp, 4: Stage2PoseApp}
    originals = {m: cls.train_step for m, cls in classes.items()}
    sample_step = FullSamplingTester.sample_step
    common = ["--synthetic_data=true"]
    argv = {
        2: ["--model=2", f"--max_step={POSE_AE_STEPS}",
            f"--log_step={POSE_AE_LOG_STEP}"],
        3: ["--model=3", f"--max_step={STAGE2_STEPS}",
            f"--log_step={STAGE2_LOG_STEP}", f"--pretrained_path={m1_dir}"],
        4: ["--model=4", f"--max_step={STAGE2_STEPS}",
            f"--log_step={STAGE2_LOG_STEP}", f"--pretrained_path={m1_dir}",
            f"--pretrained_poseAE_path={dirs[2]}"],
        11: ["--model=11", "--is_train=false", "--sample_app=true",
             "--pose_source=sampled", f"--test_batch_num={CHAIN_BATCHES}",
             f"--pretrained_path={m1_dir}",
             f"--pretrained_poseAE_path={dirs[2]}",
             f"--pretrained_appSample_path={dirs[3]}",
             f"--pretrained_poseSample_path={dirs[4]}"]}
    launches, walls, encoder_total = {}, {}, {}
    out11 = io.StringIO()
    hook = torch.nn.modules.module.register_module_forward_hook(
        count_encoder)
    for m, cls in classes.items():
        cls.train_step = timed(m, originals[m])
    FullSamplingTester.sample_step = recorded_sample_step
    try:
        for m in (2, 3, 4, 11):
            calls = encoder_calls[0]
            with (contextlib.redirect_stdout(out11) if m == 11
                  else contextlib.nullcontext()):
                launches[m], walls[m] = _run_cli(
                    [*argv[m], *common, f"--model_dir={dirs[m]}"])
            encoder_total[m] = encoder_calls[0] - calls
    finally:
        hook.remove()
        for m, cls in classes.items():
            cls.train_step = originals[m]
        FullSamplingTester.sample_step = sample_step

    failures = []
    s1 = ckpt.restore_subtrees(m1_dir, ["Encoder", "ID_AE"])
    trees = {m: ckpt.load_tree(dirs[m]) for m in (2, 3, 4)}
    frozen_want = {3: s1, 4: {**s1, "PoseAE": trees[2]["g_params"]["PoseAE"]}}
    for m, n_steps, log_step in ((2, POSE_AE_STEPS, POSE_AE_LOG_STEP),
                                 (3, STAGE2_STEPS, STAGE2_LOG_STEP),
                                 (4, STAGE2_STEPS, STAGE2_LOG_STEP)):
        with open(os.path.join(dirs[m], "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        previews = 0 if m == 2 else _previews(n_steps, log_step)
        ms = [x[0] for x in steps[m]]
        tree = trees[m]
        critic_max = max((float(t.abs().max()) for sub in
                          tree.get("d_params", {}).values()
                          for t in sub.values()), default=None)
        frozen_ok = ("frozen_params" not in tree if m == 2 else
                     not _tree_differences(tree["frozen_params"],
                                           frozen_want[m]))
        hist_keys = sorted(k for k in logged[0] if k.endswith(("_mean",
                                                               "_std")))
        per_step_encoder = sorted({x[1] for x in steps[m]})
        print(f"[stage2 train] model {m} (CLI, batch 16, {n_steps} steps, "
              f"log_step {log_step}): wall {walls[m]:.1f} s; per-step ms "
              f"after the first {[round(x, 2) for x in ms[1:]]} (first "
              f"{ms[0]:.1f}); {16 * 1e3 / statistics.median(ms[1:]):.2f} "
              f"images/s at the median (batch_size per step, as JAX counts)"
              f"; metrics.jsonl steps {[r['step'] for r in logged]}, hist "
              f"keys {hist_keys}; ROI encoder calls per step "
              f"{per_step_encoder}, in all {encoder_total[m]}; pose kernel "
              f"launches {launches[m]} (expected {1 + previews}); "
              f"checkpoint step {tree['step']}, critic max |w| {critic_max}, "
              f"frozen nets equal to their sources: {frozen_ok}", flush=True)
        if launches[m] != 1 + previews:
            failures.append(f"model {m}: {launches[m]} pose launches")
        if len(steps[m]) != n_steps or not all(x[2] for x in steps[m]):
            failures.append(f"model {m}: steps {steps[m]}")
        want_steps = [s for s in range(n_steps)
                      if s == 0 or s % log_step == log_step - 1]
        if [r["step"] for r in logged] != want_steps or not all(
                np.isfinite(v) for r in logged for v in r.values()):
            failures.append(f"model {m}: metrics.jsonl {logged}")
        if tree["step"] != n_steps or not frozen_ok:
            failures.append(f"model {m}: checkpoint step {tree['step']}, "
                            f"frozen nets equal {frozen_ok}")
        if m != 2 and (critic_max > 0.01 or len(hist_keys) != (
                8 if m == 3 else 4)):
            failures.append(f"model {m}: critic max {critic_max}, hists "
                            f"{hist_keys}")
    per_step = sorted({x[1] for x in steps[3]})
    if per_step != [6]:
        failures.append(f"model 3: ROI encoder calls per step {per_step}")
    if encoder_total[3] != 6 * STAGE2_STEPS:
        failures.append(f"model 3: {encoder_total[3]} encoder calls")
    if sorted({x[1] for x in steps[4]}) != [0] or encoder_total[4] != \
            _previews(STAGE2_STEPS, STAGE2_LOG_STEP):
        failures.append(f"model 4: encoder calls {encoder_total[4]}")

    tester = testers[0]
    root = os.path.join(dirs[11], "test_result_SampleAppTruePose-sampled_"
                        f"{CHAIN_BATCHES}x16")
    counts = {d: len(os.listdir(os.path.join(root, d)))
              for d in sorted(os.listdir(root))}
    g_names = sorted(os.listdir(os.path.join(root, "G")))
    zeros = all(n.endswith("_score0.000.png") for n in g_names)
    state = tester.cpu_state()
    sources = {"Encoder": s1["Encoder"], "ID_AE": s1["ID_AE"],
               "PoseAE": trees[2]["g_params"]["PoseAE"],
               "PoseGaussian": trees[4]["g_params"]["PoseGaussian"],
               **{k: trees[3]["g_params"][k]
                  for k in ("Gaussian_FC_Fg", "Gaussian_FC_Bg")}}
    loaded = not any(_tree_differences(state[k], v)
                     for k, v in sources.items())
    random_init = "RANDOM" in out11.getvalue()
    print(f"[stage2 chain] model 11 with the four --pretrained_* flags on "
          f"models 1-4: {CHAIN_BATCHES} batches in {walls[11]:.1f} s, "
          f"RANDOM-init line: {random_init}, trained weights loaded: "
          f"{loaded}, D: {tester.stage1.disc is not None}, files {counts}, "
          f"all scores 0: {zeros}, pose kernel launches {launches[11]} "
          f"(expected {3 * CHAIN_BATCHES})", flush=True)
    if random_init or not loaded or not zeros or tester.stage1.disc is not \
            None or launches[11] != 3 * CHAIN_BATCHES or counts.get(
                "G") != CHAIN_BATCHES * 16:
        failures.append("model 11 on the trained chain")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"model 2 training": launches[2], "model 3 training": launches[3],
            "model 4 training": launches[4],
            "model 11 on trained weights": launches[11]}


@contextlib.contextmanager
def _stage2_unguarded(app):
    """The app's Stage-II step with its forwards (mappers, frozen encoder)
    and its backward passes and updates past the float32 guard, so that the
    caller's TF32 flags reach cuBLAS and cuDNN."""
    from dpig_tpu_torch.apps.stage2_app import WganSamplerApp

    def sample(noise):
        zs = torch.split(noise, list(app.noise_dims), dim=-1)
        return [m(z) for m, z in zip(app.mappers.values(), zs)]

    encoder = ((app.pose_ae, "encode", app.pose_ae.encoder)
               if hasattr(app, "pose_ae")
               else (app.stage1, "_encode", app.stage1.encoder))
    patches = [(app, "sample_embs", sample),
               (app, "wgan_step", functools.partial(
                   WganSamplerApp.wgan_step.__wrapped__, app)), encoder]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, _ in patches:
            delattr(obj, name)


def phase_stage2_parity(model_dir):
    """One model-3 and one model-4 step, batch 2 at full width, card vs
    CPU: float32, TF32 flags on, and past the float32 guard with TF32 on
    (the control)."""
    from dpig_tpu_torch.apps.common import select_device
    from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
    from dpig_tpu_torch.apps.stage2_pose import Stage2PoseApp
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.train.parity import recorded_train_step, step_errors
    cfgs = {p: Config(platform=p, batch_size=2, model_dir=model_dir)
            for p in ("", "cpu")}
    loader = SyntheticLoader(2, cfgs[""].img_H, cfgs[""].img_W, seed=97)
    host = tuple(next(loader) for _ in range(6))
    runs = {"float32": (False, False), "TF32 flags on": (True, False),
            "control: past the guard, TF32": (True, True)}
    errs, failures = {}, []
    for model, cls in ((3, Stage2AppApp), (4, Stage2PoseApp)):
        cpu_app = cls(cfgs["cpu"], torch.device("cpu"))
        noise = cpu_app.step_noise(torch.Generator().manual_seed(5), 2)
        ref = recorded_train_step(cpu_app, host, noise=noise)
        del cpu_app
        for label, (tf32, unguarded) in runs.items():
            app = cls(cfgs[""], select_device(""))
            _set_tf32(tf32)
            try:
                with (_stage2_unguarded(app) if unguarded
                      else contextlib.nullcontext()):
                    got = recorded_train_step(app, host, noise=noise,
                                              g_updated=ref.g_updated,
                                              d_clipped=ref.d_clipped)
            finally:
                _set_tf32(False)
            e = errs[model, label] = step_errors(ref, got)
            del app, got
            print(f"[stage2 parity] model {model}, {label}: " + ", ".join(
                f"{k} {v:.3e}" for k, v in e.items()), flush=True)
            if unguarded:
                failures += [f"model {model}: TF32 past the guard passes the "
                             f"{k} limit" for k, v in e.items()
                             if v <= STAGE2_PARITY_TOL]
            else:
                failures += [f"model {model}, {label}: {k} {v:.3e}"
                             for k, v in e.items() if v > STAGE2_PARITY_TOL]
    print(f"[stage2 parity] card vs CPU, one step, batch 2 at full width, "
          f"fresh batches (losses: relative diff; nets: gradient ||diff|| / "
          f"||grad||, 'max': max|diff| / max|grad|; hist/: max abs diff); "
          f"tolerance {STAGE2_PARITY_TOL} on each", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))


def _same_batches(got, want) -> bool:
    return len(got) == len(want) and all(
        set(g) == set(w) and all(g[k].dtype == w[k].dtype and
                                 g[k].tobytes() == w[k].tobytes() for k in w)
        for g, w in zip(got, want))


def _drain(loader):
    out = []
    with loader:
        try:
            while True:
                out.append(next(loader))
        except StopIteration:
            return out


def _loader_rate(make, batches: int) -> float:
    """Host samples/s of the loader `make()` builds, over `batches` batches
    after one."""
    with make() as loader:
        next(loader)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(loader)
        return batches * loader.batch_size / (time.perf_counter() - t0)


def phase_data(tmp, m1_dir):
    """Phase 12: a Market-format tfrecord dataset written by the port,
    read back by the native scanner and parser against their plain
    versions, batched in every worker mode, and fed to models 12, 1 and 3
    through the CLI -> launches per path."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
    from dpig_tpu_torch.apps.testers import ConditionalTransferTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data import loader as dl
    from dpig_tpu_torch.data import tfrecord
    from dpig_tpu_torch.data.synthetic import write_synthetic_tfrecords

    h, w = MARKET["h"], MARKET["w"]
    data_dir = os.path.join(tmp, "data")
    ds = os.path.join(data_dir, "Market1501")
    t0 = time.perf_counter()
    shards = {split: write_synthetic_tfrecords(ds, split, n, h, w, seed=i,
                                               n_shards=2)
              for i, (split, n) in enumerate((("train", DATA_TRAIN_PAIRS),
                                              ("test", DATA_TEST_PAIRS)))}
    size = sum(os.path.getsize(p) for v in shards.values() for p in v)
    print(f"[data] wrote {DATA_TRAIN_PAIRS} train and {DATA_TEST_PAIRS} "
          f"test pairs at {h}x{w} (PIL JPEGs, 2 shards each, "
          f"pn_pairs_num_*.p): {size / 2 ** 20:.1f} MiB in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    failures, n_records = [], 0
    for paths in shards.values():
        for path in paths:
            records = list(tfrecord.read_records(path, verify_crc=True))
            if records != list(tfrecord.read_records(path, verify_crc=True,
                                                     native_scan=False)):
                failures.append(f"native and plain readers differ on {path}")
            for rec in records:
                if not _same_batches(
                        [dl.parse_example(rec, h, w, parser="native")],
                        [dl.parse_example(rec, h, w, parser="plain")]):
                    failures.append(f"record {n_records}: tfr_parse and the "
                                    "plain decoder differ")
                n_records += 1
    print(f"[data] {n_records} records: CRCs verified, the native scanner "
          f"equal to the plain reader, tfr_parse bit-equal to the plain "
          f"decoder on every key: {not failures}", flush=True)

    def test_split(workers, mode):
        return dl.TFRecordPairLoader(ds, "test", 16, h, w,
                                     dataset="Market1501", shuffle=False,
                                     num_workers=workers, worker_mode=mode)

    ref = _drain(test_split(0, "thread"))
    same = {f"{n} {m}": _same_batches(_drain(test_split(n, m)), ref)
            for n, m in ((LOADER_WORKERS, "thread"), (2, "process"))}
    print(f"[data] test split: {len(ref)} batches of 16 (40 pairs; the 8 "
          f"left over dropped); identical in order with 0 workers and "
          f"{same}", flush=True)
    if len(ref) != DATA_TEST_PAIRS // 16 or not all(same.values()):
        failures.append(f"test split batches {len(ref)}, {same}")

    def train_split(workers, mode="thread"):
        return lambda: dl.TFRecordPairLoader(
            ds, "train", 16, h, w, dataset="Market1501", shuffle=True,
            seed=123, num_workers=workers, worker_mode=mode)

    rates = {f"{n} {m}": _loader_rate(train_split(n, m), LOADER_RATE_BATCHES)
             for n, m in ((0, "thread"), (LOADER_WORKERS, "thread"),
                          (LOADER_WORKERS, "process"))}
    records = list(tfrecord.read_records(shards["train"][0]))
    parse_us = {}
    for fields in ("all", "pose_only"):
        t0 = time.perf_counter()
        for rec in records:
            dl.parse_example(rec, h, w, fields=fields)
        parse_us[fields] = (time.perf_counter() - t0) * 1e6 / len(records)
    print(f"[data] loader samples/s on this host (os.cpu_count() "
          f"{os.cpu_count()}, shuffled train split, {LOADER_RATE_BATCHES} "
          f"batches of 16 after one), by workers: "
          f"{ {k: round(v, 1) for k, v in rates.items()} }; one parse_example"
          f" on one thread {parse_us['all']:.1f} us a sample (pose_only, no "
          f"JPEG or masks: {parse_us['pose_only']:.1f} us)", flush=True)

    common = [f"--data_dir={data_dir}", "--dataset=Market1501",
              f"--num_worker={LOADER_WORKERS}"]
    batch_starts = []
    transfer_step = ConditionalTransferTester.transfer_step

    def timed_transfer(self, batch):
        batch_starts.append(time.perf_counter())
        return transfer_step(self, batch)

    m12 = os.path.join(tmp, "m12_data")
    ConditionalTransferTester.transfer_step = timed_transfer
    try:
        launches12, wall12 = _run_cli(["--model=12", "--is_train=false",
                                       "--test_batch_num=2", *common,
                                       f"--model_dir={m12}"])
        per_batch = [(b - a) * 1e3 for a, b in zip(
            batch_starts, batch_starts[1:] + [time.perf_counter()])]
        stopped = False
        try:
            _run_cli(["--model=12", "--is_train=false", "--test_batch_num=3",
                      *common, f"--model_dir={m12}_3"])
        except StopIteration:
            stopped = True
    finally:
        ConditionalTransferTester.transfer_step = transfer_step
    trees = [os.path.join(d, "test_result") for d in (m12, f"{m12}_3")]
    counts = [{d: len(os.listdir(os.path.join(t, d)))
               for d in sorted(os.listdir(t))} for t in trees]
    same_x = all(open(os.path.join(trees[0], "x", f), "rb").read()
                 == open(os.path.join(trees[1], "x", f), "rb").read()
                 for f in os.listdir(os.path.join(trees[0], "x")))
    print(f"[data] model 12 on the test split (CLI, --test_batch_num=2): "
          f"wall {wall12:.1f} s, ms per batch (transfer step to the next, "
          f"PNG writes included) {[round(x, 1) for x in per_batch]}, files "
          f"{counts[0]}, pose kernel launches {launches12} (expected 4); "
          f"--test_batch_num=3: StopIteration raised {stopped}, files "
          f"{counts[1]}, inputs equal to the first run's {same_x}",
          flush=True)
    if (launches12 != 4 or not stopped or not same_x
            or any(set(c.values()) != {32} for c in counts)):
        failures.append("model 12 on the test split")

    step_ms = {1: [], 3: []}
    originals = {1: Stage1App.train_step, 3: Stage2AppApp.train_step}

    def timed(m):
        def run(app, state, *args):
            t0 = time.perf_counter()
            out = originals[m](app, state, *args)
            torch.cuda.synchronize()
            step_ms[m].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    Stage1App.train_step, Stage2AppApp.train_step = timed(1), timed(3)
    try:
        launches1, wall1 = _run_cli([
            "--model=1", f"--max_step={TRAIN_STEPS}",
            f"--log_step={TRAIN_LOG_STEP}", *common,
            f"--model_dir={tmp}/m1_data"])
        launches3, wall3 = _run_cli([
            "--model=3", f"--max_step={STAGE2_STEPS}",
            f"--log_step={STAGE2_LOG_STEP}", f"--pretrained_path={m1_dir}",
            *common, f"--model_dir={tmp}/m3_data"])
    finally:
        Stage1App.train_step, Stage2AppApp.train_step = (originals[1],
                                                         originals[3])
    expected1 = _expected_train_launches(Config(max_step=TRAIN_STEPS,
                                                log_step=TRAIN_LOG_STEP))
    expected3 = 1 + _previews(STAGE2_STEPS, STAGE2_LOG_STEP)
    for m, ms, n, wall, got, want in (
            (1, step_ms[1], TRAIN_STEPS, wall1, launches1, expected1),
            (3, step_ms[3], STAGE2_STEPS, wall3, launches3, expected3)):
        print(f"[data] model {m} on the train split (CLI, batch 16, "
              f"num_worker {LOADER_WORKERS}, {n} steps"
              f"{', fresh batches' if m == 3 else ''}): wall {wall:.1f} s; "
              f"per-step ms after the first {[round(x, 2) for x in ms[1:]]}"
              f" (first {ms[0]:.1f}); "
              f"{16 * 1e3 / statistics.median(ms[1:]):.2f} images/s at the "
              f"median; pose kernel launches {got} (expected {want})",
              flush=True)
        if got != want or len(ms) != n:
            failures.append(f"model {m} on the train split: {got} launches,"
                            f" {len(ms)} steps")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"model 12 on tfrecords": launches12,
            "model 1 on tfrecords": launches1,
            "model 3 on tfrecords": launches3}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 1
    import dpig_tpu_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    kernel = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        tester, model12 = phase_slice(os.path.join(tmp, "m12"))
        phase_parity(tester, os.path.join(tmp, "m12_cpu"))
        del tester
        tester, sampling = phase_sampling(os.path.join(tmp, "m11"))
        phase_sampling_parity(tester, os.path.join(tmp, "m11_cpu"))
        del tester
        train = phase_train(os.path.join(tmp, "m1"))
        phase_train_parity(os.path.join(tmp, "m1_parity"))
        stage2 = phase_stage2_train(tmp, os.path.join(tmp, "m1"))
        phase_stage2_parity(os.path.join(tmp, "stage2_parity"))
        data = phase_data(tmp, os.path.join(tmp, "m1"))
    by_path = {"model 12 transfer": model12, **sampling,
               "model 1 training": train, **stage2, **data}
    kernel["launches"] = sum(by_path.values())
    kernel["launches_by_path"] = by_path
    print(f"[done] chip_smoke.py in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
