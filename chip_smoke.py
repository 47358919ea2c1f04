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

 13. bf16     `--compute_dtype=bfloat16`: model 1 through the CLI with
              phase 6's checks (TRAIN_STEPS steps, metrics, previews,
              checkpoint, resume), each train-step phase's device ms beside
              float32's; model 12 through the CLI (BF16_BATCHES batches)
              and its device ms per batch beside float32's; card vs CPU at
              batch 2 within the CPU's own bf16-vs-float32 gap.
 14. s8 conv  the s8 conv on every call one int8 model-12 batch at full
              width makes (the generator and the FG/BG encoder, recorded
              after calibration), on the route `plan` gives it (wgmma,
              csrc/s8_conv_sm90.cu, or mma_sync, csrc/s8_conv.cu) and, for
              the wgmma shapes, on the mma_sync kernel too: 0 elements
              differing from the plain version on each, the device times
              of both kernels and of the plain version, launches per batch,
              the bound (2*M*N*K at the dense s8 tensor rate, or the bytes
              at the memory rate) and its share, cuDNN's bf16 conv at the
              same shape (the float path int8 stands in for) and
              `torch._int_mm` on the im2col matrix (the integer product
              alone, without the gather or the epilogue; n/a where it
              refuses the shape). No PyTorch call computes the whole
              function;
 15. int8     `--inference_dtype=int8` at the defaults (channel, island):
              models 12 and 11 (sample_app, sampled poses) through the CLI,
              each printing its self-check SSIM(int8,float), with the s8
              launches per route and the pose launches each path must
              make; `--int8_fallback_layers=dec/Conv_13,to_rgb` in island
              and legacy modes; device ms per batch of model 12 at float32,
              bf16 and int8 (per stage, and the kernels' sum under
              torch.profiler), and the int8 batch's device time outside
              the s8 conv by the PyTorch op that launched it; card vs CPU
              at batch 2 within the CPU's own int8-vs-float32 gap.

16. df256    the DeepFashion 256x256 family at full width (hidden 128,
              z 64, 7 x 32-d codes at ROI 64, repeat_num 6): models 101
              (on DeepFashion-flavoured tfrecords: pose_mask_r4 /
              pose_mask_r8) -> 102 -> 103 (`fresh`) -> 104 through the
              CLI at batch 6, DF_STEPS steps each, each on the port
              checkpoints of the stages before it (phase 10's checks: per-
              step ms, finite metrics, the checkpoint, frozen nets, critics
              within +-0.01, 6 encoder runs per model-103 step, pose
              launches), model 101 resumed, and each step's device ms per
              phase (utils/profiling.py) at float32 and bf16 for 101;
              models 1001 and 1002 (--sample_fg) through the CLI on those
              checkpoints at batch 16, DF_TEST_BATCHES batches, in float32,
              bf16 and int8 (trees, no RANDOM-init line, pose and s8
              launches per path); model 1001's device ms per stage at each
              precision and its int8 batch by op (torch.profiler); the s8
              conv on every conv shape of one int8 model-1001 batch, as in
              phase 14 (its plain float64 conv on the whole batch); card vs
              CPU at batch 2: one model-1001 batch (phase 5's tolerance and
              TF32 control) and one model-101 step (phase 7's). The pose
              kernel at 256x256 for B = 6 and 16 is in phase 3.

The line before the last is {"kernels": [...]}: the pose kernel with its
launches on each path, and the s8 conv's two routes, each with its
launches on the int8 paths and its times summed over its calls of one
int8 model-12 batch, and under "df256" over one int8 model-1001 batch at
256x256; the last line is {"ok": true, "device": {...}}.
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
RASTER_SHAPES = {"Market": MARKET, "256x256": dict(b=16, h=256, w=256, k=18),
                 "256x256 B=6": dict(b=6, h=256, w=256, k=18)}
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
               "s8_conv": ("s8_conv.cu", _build.load),
               "s8_conv_sm90": ("s8_conv_sm90.cu", _build.load),
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
    for name, note in (("pose_raster", "; shared memory: dynamic only, "
                        "K*8 B per block (144 B at K=18)"),
                       ("s8_conv", "; two kernels: 16-byte loads / bytes"),
                       ("s8_conv_sm90", "; five conv kernels (128x128 and "
                        "128x256 tiles, split-K off / on; 256x128) and the "
                        "split-K finish; 168 at launch, setmaxnreg 64 "
                        "producer / 216 consumers")):
        ptxas = [ln.split(":", 1)[-1].strip() for ln in
                 _build.build_log(name).splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"[build] {name} ptxas -v: "
              f"{' | '.join(ptxas) or 'not reported'}{note}", flush=True)


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
        embs = _encoder_call(s1, jb["x"], jb["mask_r6"], bbox, vis)
        g_raw, _ = s1.generator(
            embs, pose_maps_from_batch(jb, cfg, "pose_rcv_target"))
        return g_raw.cpu(), s1.disc(g_raw, train=True).cpu()


def _encoder_call(app, x, mask, bbox, vis):
    """The Stage-I encoder module called straight: the FG/BG one reads the
    mask, the single-branch one (the 256 family) does not."""
    if app.fg_bg:
        return app.encoder(x, mask, bbox, vis)
    return app.encoder(x, bbox, vis)


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


def phase_train(model_dir, dtype="float32"):
    """Model 1 through the CLI entry point at full width in `dtype`
    (`--compute_dtype`), then a fresh Trainer on the same model_dir
    auto-resumes from the checkpoint."""
    from dpig_tpu_torch import main as port_main
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.kernels import pose_raster
    from dpig_tpu_torch.train import checkpoint as ckpt
    from dpig_tpu_torch.train.harness import Trainer

    argv = ["--model=1", "--synthetic_data=true",
            f"--max_step={TRAIN_STEPS}", f"--log_step={TRAIN_LOG_STEP}",
            f"--compute_dtype={dtype}", f"--model_dir={model_dir}"]
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
                 log_step=TRAIN_LOG_STEP, compute_dtype=dtype)
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
    print(f"[train] model 1 {dtype} {cfg.img_H}x{cfg.img_W} hidden "
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
    g_raw, _ = app.generator(_encoder_call(app, x, mask, bbox, vis), pose)
    adv = gan.g_loss("dcgan", app.disc(g_raw))
    l1 = l1_loss(g_raw, x)
    g_total = adv + app.cfg.L1Loss_weight * l1
    state.g_opt.step(torch.autograd.grad(g_total, state.g_params))
    mark("g_update")
    with torch.no_grad():
        fake, _ = app.generator(_encoder_call(app, x, mask, bbox, vis),
                                pose)
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


def _float64(app):
    """A Stage1App's nets with their parameters and their layers' compute
    dtype (models/layers.py) in float64; the generator's embedding-stem
    term stays float32 (models/generator.py)."""
    for net in (app.encoder, app.generator, app.disc):
        net.to(torch.float64)
        for m in net.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
    return app


def phase_train_parity(model_dir, size=None, fg_bg=True,
                       tag="[train parity]", tol=None, df256=False):
    """One train step, batch 2 at full width, default variant, from the
    same weights on the card and on the CPU, the card's D step from the
    CPU's updated G: float32, with the TF32 flags on, and two controls with
    TF32 on (past the float32 guard; the forwards alone guarded, so TF32 in
    the backward passes alone). Then the same with the L1 term alone as
    the G objective (see TRAIN_PARITY_TOL). `size` (Config fields) and
    `fg_bg` pick the model: Market model 1 by default.

    `tol` replaces TRAIN_PARITY_TOL. `df256`: the CPU's float32 step is
    also read against the same step in float64 (the yardstick of what
    float32 can give), and the D-backward TF32 control is shown, not
    required (see DF_TRAIN_PARITY_TOL)."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.train.parity import recorded_train_step, step_errors
    size = size or {}
    cfgs = {p: Config(platform=p, batch_size=2, model_dir=model_dir, **size)
            for p in ("", "cpu")}
    batch = next(SyntheticLoader(2, cfgs[""].img_H, cfgs[""].img_W,
                                 seed=99))
    runs = {"float32": (False, None), "TF32 flags on": (True, None),
            "control: past the guard, TF32": (True, _train_step_unguarded),
            "control: forwards guarded only, TF32": (
                True, Stage1App.train_step.__wrapped__)}
    errs, gaps = {}, {}
    for term, context in (("G objective", contextlib.nullcontext),
                          ("L1 term", _l1_term_only)):
        with context():
            ref = recorded_train_step(
                Stage1App(cfgs["cpu"], torch.device("cpu"), fg_bg=fg_bg),
                batch)
            if df256 and term == "G objective":
                gaps[term] = step_errors(recorded_train_step(
                    _float64(Stage1App(cfgs["cpu"], torch.device("cpu"),
                                       fg_bg=fg_bg)), batch,
                    g_updated=ref.g_updated), ref)
            for label, (tf32, step_fn) in runs.items():
                if term == "L1 term" and "past the guard" in label:
                    continue
                _set_tf32(tf32)
                try:
                    got = recorded_train_step(
                        Stage1App(cfgs[""], torch.device("cuda"),
                                  fg_bg=fg_bg), batch,
                        step_fn, g_updated=ref.g_updated)
                finally:
                    _set_tf32(False)
                errs[term, label] = step_errors(ref, got)
            del ref, got
    tols = {"G objective": tol or TRAIN_PARITY_TOL, "L1 term": L1_GRAD_TOL}
    for term, gap in gaps.items():
        print(f"{tag} {term}, the CPU's float32 step against its float64 "
              f"step: " + ", ".join(f"{k} {v:.3e}" for k, v in gap.items()),
              flush=True)
    for (term, label), e in errs.items():
        print(f"{tag} {term}, {label}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in e.items()
            if term == "G objective" or k.split()[0] in G_NETS), flush=True)
    print(f"{tag} card vs CPU, one step, batch 2 at full width "
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
    controls = [("G objective", "control: past the guard, TF32", G_NETS),
                ("L1 term", guarded_forwards, ("ID_AE",))]
    if not df256:
        controls.append(("G objective", guarded_forwards,
                         ("Discriminator",)))
    for term, label, keys in controls:
        if any(errs[term, label][k] <= tols[term][k] for k in keys):
            raise AssertionError(f"a TF32 train step passes the {keys} "
                                 f"gradient tolerance ({term}, {label}): "
                                 f"the check cannot see TF32")


def _timed_steps(classes, steps, encoder_calls):
    """Patch each class's train_step (`classes`: model -> app class) to
    append (ms, encoder calls, all metrics finite) of each step to
    `steps[model]`, synchronized so that the ms are the card's; the
    encoder calls are read from the counter `encoder_calls[0]` -> the
    original methods, to restore."""
    originals = {m: cls.train_step for m, cls in classes.items()}

    def timed(model, step):
        def run(app, state, *args):
            calls, t0 = encoder_calls[0], time.perf_counter()
            out = step(app, state, *args)
            torch.cuda.synchronize()
            steps[model].append(((time.perf_counter() - t0) * 1e3,
                                 encoder_calls[0] - calls,
                                 all(bool(torch.isfinite(v).all())
                                     for v in out.values())))
            return out
        return run

    for m, cls in classes.items():
        cls.train_step = timed(m, originals[m])
    return originals


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

    def recorded_sample_step(self, *args, **kwargs):
        testers.append(self)
        return sample_step(self, *args, **kwargs)

    classes = {2: Stage1PoseApp, 3: Stage2AppApp, 4: Stage2PoseApp}
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
    originals = _timed_steps(classes, steps, encoder_calls)
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


# ------------------------------------------------ reduced precision
# Dense s8 tensor-core rate of the H100 SXM (data sheet, without sparsity).
S8_OPS_PER_S = 1979e12
BF16_BATCHES = 2
INT8_BATCHES = 2
INT8_FALLBACK = "dec/Conv_13,to_rgb"
# s8 conv launches of one int8 batch at full Market width: the encoder's
# stem/Conv_1..2 and its two towers of 14 convs, the generator's g_stem,
# 14 + 14 tower convs and to_rgb (all-int8 defaults).
S8_ENCODER_CONVS, S8_GENERATOR_CONVS = 30, 30


def _stage_ms_sum(tester, batch, reps=5):
    """Device ms per layer of transfer_step (utils/profiling.py) on one
    host batch, and their sum."""
    from dpig_tpu_torch.apps.common import batch_to_device
    from dpig_tpu_torch.utils import profiling
    ms = profiling.stage_ms(tester, batch_to_device(batch, tester.device),
                            reps)
    return ms, sum(ms.values())


def phase_bf16(tmp):
    """`--compute_dtype=bfloat16`: model 1 through the CLI (phase 6's
    checks) with its per-phase device profile beside float32's; model 12
    through the CLI and its device ms per batch beside float32's; card vs
    CPU at batch 2 within the CPU's own bf16-vs-float32 gap."""
    from dpig_tpu_torch.apps.common import batch_to_device
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.apps.testers import ConditionalTransferTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.utils import profiling

    launches = {"model 1 training bf16": phase_train(
        os.path.join(tmp, "m1_bf16"), "bfloat16")}
    batch = next(SyntheticLoader(16, 128, 64, seed=5))
    phases = {}
    for dtype in ("float32", "bfloat16"):
        app = Stage1App(Config(compute_dtype=dtype), torch.device("cuda"))
        state = app.init_state()
        phases[dtype] = profiling.train_phase_ms(
            app, state, batch_to_device(batch, app.device), reps=3)
        del app, state
    for dtype, ms in phases.items():
        print(f"[bf16] model-1 train step device ms per phase, {dtype}: "
              f"{ {k: round(v, 3) for k, v in ms.items()} } sum "
              f"{sum(ms.values()):.3f}", flush=True)

    n, wall = _run_cli(["--model=12", "--is_train=false",
                        "--synthetic_data=true", "--compute_dtype=bfloat16",
                        f"--test_batch_num={BF16_BATCHES}",
                        f"--model_dir={os.path.join(tmp, 'm12_bf16')}"])
    launches["model 12 transfer bf16"] = n
    print(f"[bf16] model 12 through the CLI, {BF16_BATCHES} batches: pose "
          f"kernel launches {n}, wall {wall:.1f} s", flush=True)
    if n != 2 * BF16_BATCHES:
        raise AssertionError(f"pose kernel launched {n} times")
    f32 = ConditionalTransferTester(Config(model_dir=tmp))
    b16 = ConditionalTransferTester(Config(model_dir=tmp,
                                           compute_dtype="bfloat16"),
                                    params=f32.cpu_state())
    for name, t in (("float32", f32), ("bfloat16", b16)):
        ms, total = _stage_ms_sum(t, batch)
        print(f"[bf16] model 12 device ms per batch of 16, {name}: "
              f"{ {k: round(v, 3) for k, v in ms.items()} } sum {total:.3f}",
              flush=True)

    cpu = {d: ConditionalTransferTester(
        Config(platform="cpu", model_dir=tmp, compute_dtype=d),
        params=f32.cpu_state()) for d in ("float32", "bfloat16")}
    small = next(SyntheticLoader(2, 128, 64, seed=99))
    g32, s32 = _raw_outputs(cpu["float32"], small)
    g16, s16 = _raw_outputs(cpu["bfloat16"], small)
    gc, sc = _raw_outputs(b16, small)
    # The D score normalizes by the statistics of a batch of 2, which
    # amplifies the bf16 roundings of its input (g_raw, itself within the
    # gap): on an NVIDIA H100 80GB HBM3 at 700 W the score read 0.141
    # against a gap of 0.121 (g_raw 5.9e-3 against 7.7e-3), so the score
    # is held to twice its gap.
    gap = (float((g16 - g32).abs().max()), float((s16 - s32).abs().max()))
    got = (float((gc - g16).abs().max()), float((sc - s16).abs().max()))
    print(f"[bf16] card vs CPU at bf16, batch 2 at full width, max|diff| of "
          f"(g_raw, score): {got[0]:.3e}, {got[1]:.3e}; the CPU's "
          f"bf16-vs-float32 gap {gap[0]:.3e}, {gap[1]:.3e}; limits 1x and "
          f"2x of it", flush=True)
    if got[0] > gap[0] or got[1] > 2 * gap[1]:
        raise AssertionError("card and CPU bf16 disagree beyond the CPU's "
                             "own bf16-vs-float32 gap")
    return launches


def _s8_bound_ms(c):
    """(bound ms, 'bytes' or 'operations', ops) of one s8 conv call `c`
    (its arguments by name): 2*M*N*K at the dense s8 tensor rate, or each
    input read once and the output written once at the memory rate."""
    from dpig_tpu_torch.kernels.s8_conv import out_shape
    x8, w8, res = c["x8"], c["w8"], c["res"]
    b, ho, wo, co = out_shape(x8, w8, c["stride"])
    ops = 2 * b * ho * wo * co * w8[0].numel()
    nbytes = (x8.numel() + w8.numel() + 4 * 4 * co
              + b * ho * wo * co * torch.empty(
                  0, dtype=c["out_dtype"]).element_size()
              + (0 if res is None else res.numel() * res.element_size()))
    ops_ms, bytes_ms = ops / S8_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), ops


def _record_s8_calls(fn):
    """Run fn() with every s8 conv launch recorded -> [its arguments by
    name, but the route: `plan` picks it]."""
    import inspect
    from dpig_tpu_torch.kernels import s8_conv as sc
    calls, launch = [], sc.s8_conv_cuda
    sig = inspect.signature(launch)

    def recording(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        calls.append({k: v for k, v in bound.arguments.items()
                      if k != "route"})
        return launch(*args, **kw)

    sc.s8_conv_cuda = recording
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        sc.s8_conv_cuda = launch
    return calls


def _s8_key(c):
    res = c["res"]
    return (tuple(c["x8"].shape), tuple(c["w8"].shape), c["stride"],
            str(c["out_dtype"]).replace("torch.", ""),
            None if res is None else str(res.dtype).replace("torch.", ""))


def _im2col(x8, k, stride):
    """x8 [B,H,W,Ci] s8 -> its [M, k*k*Ci] im2col matrix, SAME-padded."""
    import torch.nn.functional as F
    from dpig_tpu_torch.models.layers import same_pads
    b, h, w, ci = x8.shape
    ph, pw = same_pads(h, k, stride), same_pads(w, k, stride)
    xp = F.pad(x8.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    cols = xp.permute(0, 2, 3, 1).unfold(1, k, stride).unfold(2, k, stride)
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * ci)


def _int_mm_ms(c, reps=25, inner=20):
    """Device ms of `torch._int_mm` on the call's im2col matrix [M, K]
    (built before the timed window) times its weights [K, N]: the integer
    product alone, a yardstick the port never calls. None where _int_mm
    refuses the shape."""
    w8 = c["w8"]
    a = _im2col(c["x8"], w8.shape[1], c["stride"])
    b = w8.reshape(w8.shape[0], -1).t()
    try:
        torch._int_mm(a, b)
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return _graph_ms(lambda: torch._int_mm(a, b), reps=reps, inner=inner)


def _s8_route_entry(route, rows, per):
    """The kernels-line entry of one s8 route: its times, bound and
    yardsticks summed over its calls of one int8 batch."""
    mine = [r for r in rows if r["route"] == route]

    def per_batch(key):
        vals = [r[key] for r in mine]
        if not mine or any(v is None for v in vals):
            return None
        return sum(v * r["launches_per_batch"] for v, r in zip(vals, mine))

    bound_by = max(("operations", "bytes"), key=lambda b: sum(
        r["bound_ms"] * r["launches_per_batch"] for r in mine
        if r["bound_by"] == b))
    source = {"wgmma": "s8_conv_sm90.cu", "mma_sync": "s8_conv.cu"}[route]
    return {"name": f"s8_conv ({route})", "route": "cuda",
            "source": f"dpig_tpu_torch/csrc/{source}",
            "replaces": "dpig_tpu/models/quant.py:71",
            "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_batch("ms"), "plain_ms": per_batch("plain_ms"),
            "bound_ms": per_batch("bound_ms"), "bound_by": bound_by,
            "library_ms": per_batch("int_mm_ms"),
            "library_call": "torch._int_mm on the im2col matrix (the "
                            "integer product alone); null where it refuses "
                            "a shape",
            "mma_sync_ms": per_batch("mma_sync_ms"),
            "cudnn_bf16_ms": per_batch("cudnn_bf16_ms"),
            "per": f"its {sum(r['launches_per_batch'] for r in mine)} calls "
                   f"of {per}",
            "shapes": mine}


def phase_s8_conv():
    """The s8 conv on every conv shape one int8 model-12 batch at full
    Market width gives it (the generator and the FG/BG encoder, recorded
    from a real batch after calibration), on the route `plan` picks and,
    for the wgmma shapes, on the mma_sync kernel too: each bit-equal to the
    plain version, the device times of both kernels and of the plain
    version, launches per batch, the card's bound and its share, cuDNN's
    bfloat16 conv at the same shape (the float path it stands in for) and
    `torch._int_mm` on the im2col matrix."""
    from dpig_tpu_torch.apps.common import batch_to_device
    from dpig_tpu_torch.apps.testers import ConditionalTransferTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader

    tester = ConditionalTransferTester(Config(inference_dtype="int8",
                                              int8_selfcheck=False))
    batch = batch_to_device(next(SyntheticLoader(16, 128, 64, seed=5)),
                            tester.device)
    tester._inference_params(batch)
    entries, n_calls = _s8_table(tester, batch, "[s8 conv]",
                                 "one int8 model-12 batch of 16")
    if n_calls != S8_ENCODER_CONVS + S8_GENERATOR_CONVS:
        raise AssertionError(f"{n_calls} s8 launches in one batch")
    return entries


def _s8_table(tester, batch, tag, per, reps=25, inner=20):
    """Every s8 conv call of one `transfer_step` of the calibrated int8
    `tester` on the device `batch`, grouped by shape: each bit-equal to
    the plain version on its route and on mma_sync, with the times of
    both kernels, the plain version, cuDNN's bf16 conv and
    `torch._int_mm`, the bound and its share, printed under `tag` ->
    (the two routes' entries summed per batch, the number of calls).
    `reps` / `inner` set the CUDA-graph timing of the kernels and the
    yardsticks."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    from dpig_tpu_torch.models.layers import conv2d_same

    calls = _record_s8_calls(lambda: tester.transfer_step(batch))
    shapes = {}
    for c in calls:
        shapes.setdefault(_s8_key(c), []).append(c)
    rows, worst = [], 0
    for key, group in shapes.items():
        c = group[0]
        stride = c["stride"]
        how = sc.plan(tuple(c["x8"].shape), tuple(c["w8"].shape), stride)
        want = sc.s8_conv_plain(**c)
        differ, err = {}, 0.0
        for route in {how.route, "mma_sync"}:
            got = sc.s8_conv_cuda(**c, route=route)
            torch.cuda.synchronize()
            differ[route] = int((got != want).sum())
            err = max(err, float((got.float() - want.float()).abs().max()))
        del got, want
        worst = max(worst, *differ.values())
        timed = functools.partial(_graph_ms, reps=reps, inner=inner)
        ms = timed(lambda: sc.s8_conv_cuda(**c))
        mma_ms = (ms if how.route == "mma_sync" else
                  timed(lambda: sc.s8_conv_cuda(**c, route="mma_sync")))
        plain_ms = _graph_ms(lambda: sc.s8_conv_plain(**c), reps=3, inner=2)
        xb = c["x8"].to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = c["w8"].to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
        cudnn_ms = timed(lambda: conv2d_same(xb, wb, None, stride))
        del xb, wb
        int_mm_ms = _int_mm_ms(c, reps, inner)
        bound_ms, bound_by, ops = _s8_bound_ms(c)
        row = dict(x=key[0], w=key[1], stride=stride, out=key[3],
                   res=key[4], route=how.route, tile=[how.bm, how.bn],
                   split=how.split, launches_per_batch=len(group),
                   differing=differ, max_abs_err=err, ms=ms,
                   mma_sync_ms=mma_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / ms,
                   cudnn_bf16_ms=cudnn_ms, int_mm_ms=int_mm_ms,
                   tops=ops / ms / 1e9)
        rows.append(row)
        imm = ("n/a" if int_mm_ms is None else f"{int_mm_ms * 1e3:.1f} us")
        print(f"{tag} x{key[0]} w{key[1]} stride {stride} out {key[3]}"
              f" res {key[4]}: {len(group)} per batch, {how.route} "
              f"{how.bm}x{how.bn} split {how.split}, differing {differ}; "
              f"{how.route} {ms * 1e3:.1f} us ({ops / ms / 1e9:.1f} TOP/s, "
              f"{bound_ms / ms:.1%} of the {bound_ms * 1e3:.1f} us "
              f"{bound_by} bound), mma_sync {mma_ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us, cuDNN bf16 conv "
              f"{cudnn_ms * 1e3:.1f} us, torch._int_mm {imm}", flush=True)
    entries = {r: _s8_route_entry(r, rows, per) for r in sc.ROUTES}
    for route, e in entries.items():
        imm = ("n/a" if e["library_ms"] is None
               else f"{e['library_ms']:.3f} ms")
        print(f"{tag} {per}, {e['per']} "
              f"({route}): {e['ms']:.3f} ms (mma_sync kernel on the same "
              f"calls {e['mma_sync_ms']:.3f} ms), plain {e['plain_ms']:.3f} "
              f"ms, bound {e['bound_ms']:.3f} ms "
              f"({e['bound_ms'] / e['ms']:.1%}), cuDNN bf16 convs "
              f"{e['cudnn_bf16_ms']:.3f} ms, torch._int_mm {imm}",
              flush=True)
    total = {k: sum(e[k] for e in entries.values())
             for k in ("ms", "mma_sync_ms", "bound_ms", "cudnn_bf16_ms")}
    print(f"{tag} {per}: {len(calls)} launches "
          f"on {len(rows)} shapes, {total['ms']:.3f} ms as routed (all on "
          f"the mma_sync kernel {total['mma_sync_ms']:.3f} ms), bound "
          f"{total['bound_ms']:.3f} ms ({total['bound_ms'] / total['ms']:.1%}"
          f"), cuDNN bf16 convs at the same shapes "
          f"{total['cudnn_bf16_ms']:.3f} ms", flush=True)
    if worst:
        raise AssertionError("the s8 conv differs from its plain version")
    return entries, len(calls)


def _run_cli_s8(argv):
    """`_run_cli` with the s8 conv's launch counts (total and per route)
    also set to 0 just before and read just after; stdout kept -> (pose
    launches, s8 launches, s8 launches by route, wall s, stdout)."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    sc.launches = 0
    sc.launches_by_route.update(dict.fromkeys(sc.ROUTES, 0))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pose, wall = _run_cli(argv)
    text = out.getvalue()
    sys.stdout.write(text)
    return pose, sc.launches, dict(sc.launches_by_route), wall, text


def _selfcheck(text):
    lines = [ln for ln in text.splitlines() if "int8 self-check" in ln]
    if not lines:
        raise AssertionError("no int8 self-check line")
    return float(lines[-1].split("SSIM(int8,float)=")[1].split()[0])


def _profile_transfer(tester, batch):
    """torch.profiler over one `transfer_step` (after a warm-up one) ->
    (device kernel events, key_averages rows with self device time)."""
    from torch.profiler import ProfilerActivity, profile
    from dpig_tpu_torch.apps.common import batch_to_device
    jb = batch_to_device(batch, tester.device)
    tester.transfer_step(jb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tester.transfer_step(jb)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    if not kernels:
        raise AssertionError("the profiler saw no device time")
    ops = [e for e in prof.key_averages()
           if e.device_type != cuda and _self_device_us(e) > 0]
    return kernels, sorted(ops, key=_self_device_us, reverse=True)


def _self_device_us(evt) -> float:
    """A key_averages() row's self device time (`self_cuda_time_total`
    before PyTorch 2.4)."""
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _int8_remainder(kernels, ops, tag="[int8]",
                    what="model 12 int8 batch of 16"):
    """Prints the int8 batch's device time in the s8 conv and, outside it,
    by the PyTorch op that launched it (self device time), top 10."""
    us = sum(e.time_range.elapsed_us() for e in kernels)
    s8 = [e for e in kernels if "s8_conv" in e.name]
    s8_us = sum(e.time_range.elapsed_us() for e in s8)
    print(f"{tag} {what} under torch.profiler: device "
          f"kernels {us / 1e3:.3f} ms in {len(kernels)} launches; the s8 "
          f"conv {s8_us / 1e3:.3f} ms in {len(s8)}; outside it "
          f"{(us - s8_us) / 1e3:.3f} ms", flush=True)
    for e in ops[:10]:
        print(f"{tag}   outside the s8 conv: {e.key} "
              f"{_self_device_us(e) / 1e3:.3f} ms device, {e.count} calls",
              flush=True)


def phase_int8(tmp):
    """`--inference_dtype=int8` at the defaults (channel, island): models 12
    and 11 through the CLI, their self-check SSIM and s8 / pose launches;
    the fallback `dec/Conv_13,to_rgb` in island and legacy modes; device
    ms per batch beside float32 and bf16; card vs CPU at batch 2."""
    from dpig_tpu_torch.apps.testers import ConditionalTransferTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader

    base = ["--is_train=false", "--synthetic_data=true",
            "--inference_dtype=int8"]
    # path: (flags, batches, s8 launches of the generator, of them on the
    # mma_sync route, encoder run per batch, pose launches per batch).
    # Calibration adds one int8 encoder pass (its embeddings) and the
    # self-check one int8 generator pass; the fallback runs the two named
    # layers in bf16, and the legacy graph has no s8 stem. The mma_sync
    # route takes the 18-channel stem and the 3-channel to_rgb, the wgmma
    # route every other conv (all the encoder's).
    runs = {
        "model 12 transfer int8": (
            ["--model=12"], INT8_BATCHES, S8_GENERATOR_CONVS, 2, True, 2),
        "model 11 sampling int8": (
            ["--model=11", "--sample_app=true", "--pose_source=sampled"],
            INT8_BATCHES, S8_GENERATOR_CONVS, 2, False, 3),
        "model 12 int8 island fallback": (
            ["--model=12", f"--int8_fallback_layers={INT8_FALLBACK}"], 1,
            S8_GENERATOR_CONVS - 2, 1, True, 2),
        "model 12 int8 legacy fallback": (
            ["--model=12", f"--int8_fallback_layers={INT8_FALLBACK}",
             "--int8_fallback_mode=legacy"], 1, S8_GENERATOR_CONVS - 3, 0,
            True, 2)}
    s8_launches, pose_launches = {}, {}
    for i, (path, (flags, n, gen, gen_mma, enc, pose_per)) in enumerate(
            runs.items()):
        want_s8 = S8_ENCODER_CONVS + gen + n * (gen + (
            S8_ENCODER_CONVS if enc else 0))
        want_routes = {"mma_sync": (n + 1) * gen_mma}
        want_routes["wgmma"] = want_s8 - want_routes["mma_sync"]
        pose, s8, by_route, wall, text = _run_cli_s8(
            base + flags + [f"--test_batch_num={n}",
                            f"--model_dir={os.path.join(tmp, f'q{i}')}"])
        ssim = _selfcheck(text)
        print(f"[int8] {path}: {n} batches of 16, s8 conv launches {s8} "
              f"(expected {want_s8}), by route {by_route} (expected "
              f"{want_routes}), pose kernel launches {pose}, wall "
              f"{wall:.1f} s, self-check SSIM(int8,float) {ssim:.4f}",
              flush=True)
        if s8 != want_s8 or by_route != want_routes or \
                pose != n * pose_per + 1:  # +1: calibration
            raise AssertionError(f"{path}: {s8} s8 launches {by_route}, "
                                 f"{pose} pose launches")
        s8_launches[path], pose_launches[path] = by_route, pose

    batch = next(SyntheticLoader(16, 128, 64, seed=5))
    f32 = ConditionalTransferTester(Config(model_dir=tmp))
    testers = {"float32": f32,
               "bfloat16": ConditionalTransferTester(Config(
                   model_dir=tmp, compute_dtype="bfloat16"),
                   params=f32.cpu_state()),
               "int8": ConditionalTransferTester(Config(
                   model_dir=tmp, inference_dtype="int8",
                   int8_selfcheck=False), params=f32.cpu_state())}
    from dpig_tpu_torch.apps.common import batch_to_device
    testers["int8"]._inference_params(batch_to_device(batch, f32.device))
    for name, t in testers.items():
        ms, total = _stage_ms_sum(t, batch)
        kernels, ops = _profile_transfer(t, batch)
        kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        print(f"[int8] model 12 device ms per batch of 16, {name}: "
              f"{ {k: round(v, 3) for k, v in ms.items()} } sum {total:.3f};"
              f" device kernels (torch.profiler) {kernel_ms:.3f}", flush=True)
        if name == "int8":
            _int8_remainder(kernels, ops)

    small = next(SyntheticLoader(2, 128, 64, seed=99))
    card = ConditionalTransferTester(Config(model_dir=tmp,
                                            inference_dtype="int8",
                                            int8_selfcheck=False),
                                     params=f32.cpu_state())
    cpu = ConditionalTransferTester(Config(platform="cpu", model_dir=tmp,
                                           inference_dtype="int8",
                                           int8_selfcheck=False),
                                    params=f32.cpu_state())
    cpu32 = ConditionalTransferTester(Config(platform="cpu", model_dir=tmp),
                                      params=f32.cpu_state())
    for t in (card, cpu):
        t._inference_params(batch_to_device(small, t.device))
    scale_err = max(float((card.quant_gen["act_scales"][k].cpu() - v).abs()
                          .max() / v.abs().max())
                    for k, v in cpu.quant_gen["act_scales"].items())
    g_card, _ = _raw_outputs(card, small)
    g_cpu, _ = _raw_outputs(cpu, small)
    g_f32, _ = _raw_outputs(cpu32, small)
    diff, gap = (g_card - g_cpu).abs(), (g_cpu - g_f32).abs()
    print(f"[int8] card vs CPU at int8, batch 2 at full width, each "
          f"calibrating its own tables (generator scales within "
          f"{scale_err:.2e} of each layer's largest: statistics of "
          f"embeddings the two "
          f"int8 encoders round differently); g_raw max|diff| "
          f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}; limit: "
          f"the CPU's int8-vs-float32 gap, max {float(gap.max()):.3e}, "
          f"mean {float(gap.mean()):.3e}", flush=True)
    if float(diff.max()) > float(gap.max()) or \
            float(diff.mean()) > float(gap.mean()):
        raise AssertionError("card and CPU int8 disagree beyond the limits")
    return s8_launches, pose_launches


# ------------------------------------------------ DeepFashion 256x256
# The DeepFashion family at full width (256x256, hidden 128, z 64, 7 x 32-d
# ROI codes at ROI 64, repeat_num 6): Stage I at batch 6 as
# run_DF_train.sh trains it, the testers at batch 16.
DF = dict(img_H=256, img_W=256)
DF_TRAIN_BATCH = 6
DF_STEPS, DF_LOG_STEP = 4, 1
DF_TEST_BATCHES = 2
DF_TRAIN_PAIRS = 36
# Card vs CPU limits for one model-101 step, batch 2 at full 256 width
# (keys of `train.parity.step_errors`; phase 7's method: between the
# float32 and the TF32 readings). At 256 fresh nets are less well
# conditioned than at Market: the D normalizes a batch of 2 nearly equal
# fakes, and the adversarial G loss moves by about |logit| times its
# logits' relative error. On an NVIDIA H100 80GB HBM3 at 700 W this phase
# read in two runs, float32 (the same with the TF32 flags on): G-step
# losses 3.46e-5, d_loss 9.7e-7 to 6.7e-6, Encoder 3.07e-3, ID_AE 5.08e-3,
# Discriminator 1.9e-3 to 3.6e-3, d_stats 2.9e-6 to 3.1e-6; the CPU's own
# float32 step against its float64 step 1.1e-7, 2.1e-6 to 2.8e-6, 4.5e-3,
# 4.3e-3, 6.1e-3 to 6.4e-3, 8.8e-7 to 1.2e-6 (so float32 holds these
# gradients to ~5e-3 here, and the card's loss is the one off); past the
# float32 guard with TF32 on: 2.85e-2, 3.3e-5 to 3.5e-4, 1.39e-1,
# 1.18e-1, 5.4e-2 to 5.7e-2, 6.1e-4 to 6.7e-4. The D step's readings move
# between runs, so d_loss is held at 3e-5, 4.5x the larger float32 one.
# TF32 in the backward passes alone moves the D's gradients less than
# float32 can resolve (2.7e-3 to 4.3e-3), so here the L1 term's generator
# gradients (phase 7's L1_GRAD_TOL) show a TF32 backward instead.
# Market's d_stats limit is kept.
DF_TRAIN_PARITY_TOL = {"g_step_losses": 1e-4, "d_loss": 3e-5,
                       "Encoder": 1.5e-2, "ID_AE": 1.5e-2,
                       "Discriminator": 2e-2, "d_stats": 1e-5}
DF_PRECISIONS = {"float32": [], "bf16": ["--compute_dtype=bfloat16"],
                 "int8": ["--inference_dtype=int8"]}


def phase_df256_train(tmp):
    """Models 101 (on DeepFashion-flavoured tfrecords) -> 102 -> 103 ->
    104 through the CLI at full 256 width, batch 6, each on the port's
    checkpoints of the stages before it: per-step ms, finite metrics, the
    checkpoints (frozen nets equal to their sources, critics within
    +-0.01), 6 encoder runs per model-103 step, pose launches; model 101
    resumed by a fresh Trainer; each step's device ms per phase
    (utils/profiling.py) -> (model dirs, pose launches by path)."""
    from dpig_tpu_torch.apps.common import batch_to_device
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.apps.stage1_pose import Stage1PoseApp
    from dpig_tpu_torch.apps.stage2_app_single import Stage2AppSingleApp
    from dpig_tpu_torch.apps.stage2_pose import Stage2PoseApp
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import (SyntheticLoader,
                                               write_synthetic_tfrecords)
    from dpig_tpu_torch.models.encoders import RoiEncoder
    from dpig_tpu_torch.train import checkpoint as ckpt
    from dpig_tpu_torch.train.harness import Trainer
    from dpig_tpu_torch.utils import profiling

    data_dir = os.path.join(tmp, "df_data")
    t0 = time.perf_counter()
    shards = write_synthetic_tfrecords(
        os.path.join(data_dir, "DF_img_pose"), "train", DF_TRAIN_PAIRS, 256,
        256, seed=7, n_shards=2, name="DF_img_pose")
    print(f"[df256] wrote {DF_TRAIN_PAIRS} DeepFashion-flavoured train "
          f"pairs at 256x256 (pose_mask_r4 / pose_mask_r8): "
          f"{sum(os.path.getsize(p) for p in shards) / 2 ** 20:.1f} MiB in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dirs = {m: os.path.join(tmp, f"df{m}") for m in (101, 102, 103, 104)}
    size = ["--img_H=256", "--img_W=256", f"--batch_size={DF_TRAIN_BATCH}",
            f"--max_step={DF_STEPS}", f"--log_step={DF_LOG_STEP}"]
    argv = {101: ["--model=101", f"--data_dir={data_dir}",
                  "--dataset=DF_img_pose", "--num_worker=2"],
            102: ["--model=102", "--synthetic_data=true"],
            103: ["--model=103", "--synthetic_data=true",
                  f"--pretrained_path={dirs[101]}"],
            104: ["--model=104", "--synthetic_data=true",
                  f"--pretrained_path={dirs[101]}",
                  f"--pretrained_poseAE_path={dirs[102]}"]}
    classes = {101: Stage1App, 102: Stage1PoseApp, 103: Stage2AppSingleApp,
               104: Stage2PoseApp}
    steps = {m: [] for m in classes}
    encoder_calls = [0]

    def count_encoder(module, args, out):
        if isinstance(module, RoiEncoder):
            encoder_calls[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(
        count_encoder)
    originals = _timed_steps(classes, steps, encoder_calls)
    launches, walls, encoder_total = {}, {}, {}
    try:
        for m in classes:
            calls = encoder_calls[0]
            launches[m], walls[m] = _run_cli(
                [*argv[m], *size, f"--model_dir={dirs[m]}"])
            encoder_total[m] = encoder_calls[0] - calls
    finally:
        hook.remove()
        for m, cls in classes.items():
            cls.train_step = originals[m]

    failures = []
    trees = {m: ckpt.load_tree(dirs[m]) for m in classes}
    s1 = {k: trees[101]["g_params"][k] for k in ("Encoder", "ID_AE")}
    frozen_want = {103: s1,
                   104: {**s1, "PoseAE": trees[102]["g_params"]["PoseAE"]}}
    previews = _previews(DF_STEPS, DF_LOG_STEP)
    for m in classes:
        with open(os.path.join(dirs[m], "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        ms = [x[0] for x in steps[m]]
        tree = trees[m]
        critic_max = max((float(t.abs().max()) for sub in
                          tree.get("d_params", {}).values()
                          for t in sub.values()), default=None)
        frozen_ok = (not _tree_differences(tree["frozen_params"],
                                           frozen_want[m])
                     if m in frozen_want else "frozen_params" not in tree)
        per_step_encoder = sorted({x[1] for x in steps[m]})
        want = {101: DF_STEPS + 1 + previews, 102: 1}.get(m, 1 + previews)
        print(f"[df256] model {m} (CLI, 256x256, batch {DF_TRAIN_BATCH}, "
              f"{DF_STEPS} steps{', tfrecords' if m == 101 else ''}): wall "
              f"{walls[m]:.1f} s; per-step ms after the first "
              f"{[round(x, 2) for x in ms[1:]]} (first {ms[0]:.1f}); "
              f"{DF_TRAIN_BATCH * 1e3 / statistics.median(ms[1:]):.2f} "
              f"images/s at the median; metrics.jsonl steps "
              f"{[r['step'] for r in logged]}; encoder calls per step "
              f"{per_step_encoder}, in all {encoder_total[m]}; pose kernel "
              f"launches {launches[m]} (expected {want}); checkpoint step "
              f"{tree['step']}, critic max |w| {critic_max}, frozen nets "
              f"equal to their sources: {frozen_ok}", flush=True)
        want_steps = [s for s in range(DF_STEPS)
                      if s == 0 or s % DF_LOG_STEP == DF_LOG_STEP - 1]
        if (launches[m] != want or len(steps[m]) != DF_STEPS
                or not all(x[2] for x in steps[m])
                or [r["step"] for r in logged] != want_steps
                or not all(np.isfinite(v) for r in logged
                           for v in r.values())
                or tree["step"] != DF_STEPS or not frozen_ok
                or (critic_max is not None and m != 101
                    and critic_max > 0.01)):
            failures.append(f"model {m}")
    if sorted({x[1] for x in steps[103]}) != [6] or \
            encoder_total[103] != 6 * DF_STEPS:
        failures.append(f"model 103: encoder calls {steps[103]}")
    if sorted({x[1] for x in steps[101]}) != [2]:  # G step + re-forward
        failures.append(f"model 101: encoder calls {steps[101]}")

    cfg = Config(model_dir=dirs[101], max_step=DF_STEPS, log_step=DF_LOG_STEP,
                 batch_size=DF_TRAIN_BATCH, **DF)
    app = Stage1App(cfg, torch.device("cuda"), fg_bg=False)
    resumed = ckpt.state_tree(Trainer(cfg, app, SyntheticLoader(
        DF_TRAIN_BATCH, 256, 256)).init_state())
    unequal = _tree_differences(resumed, trees[101])
    print(f"[df256] resume: a fresh model-101 Trainer starts at step "
          f"{resumed['step']}, equal to the checkpoint: {not unequal}",
          flush=True)
    if resumed["step"] != DF_STEPS or unequal:
        failures.append("model 101 resume")
    del app, resumed

    host = [next(SyntheticLoader(DF_TRAIN_BATCH, 256, 256, seed=s))
            for s in range(6)]
    dev = [batch_to_device(b, torch.device("cuda")) for b in host]
    for dtype in ("float32", "bfloat16"):
        app = Stage1App(Config(batch_size=DF_TRAIN_BATCH,
                               compute_dtype=dtype, **DF),
                        torch.device("cuda"), fg_bg=False)
        ms = profiling.train_phase_ms(app, app.init_state(), dev[0], reps=2)
        print(f"[df256] model-101 train step device ms per phase, {dtype}, "
              f"batch {DF_TRAIN_BATCH}: "
              f"{ {k: round(v, 3) for k, v in ms.items()} } sum "
              f"{sum(ms.values()):.3f}", flush=True)
        del app
    gen = torch.Generator().manual_seed(0)
    frozen = ckpt.restore_subtrees(dirs[101], ["Encoder", "ID_AE"])
    frozen.update(ckpt.restore_subtrees(dirs[102], ["PoseAE"]))
    for m, cls in ((103, Stage2AppSingleApp), (104, Stage2PoseApp)):
        app = cls(Config(batch_size=DF_TRAIN_BATCH, **DF),
                  torch.device("cuda"), frozen)
        ms = profiling.stage2_phase_ms(app, app.init_state(), tuple(dev),
                                       app.step_noise(gen, DF_TRAIN_BATCH),
                                       reps=2)
        print(f"[df256] model-{m} train step device ms per phase (fresh, "
              f"batch {DF_TRAIN_BATCH}): "
              f"{ {k: round(v, 3) for k, v in ms.items()} } sum "
              f"{sum(ms.values()):.3f}", flush=True)
        del app
    if failures:
        raise AssertionError("; ".join(failures))
    return dirs, {f"model {m} training (256)": launches[m] for m in classes}


def phase_df256_test(tmp, dirs):
    """Models 1001 and 1002 (--sample_fg) through the CLI on the chain's
    checkpoints, batch 16, DF_TEST_BATCHES batches, in float32, bf16 and
    int8: the trees, no RANDOM-init line, the pose and s8 launches each
    path must make -> (pose launches by path, s8 launches by path and
    route)."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    flags = [f"--pretrained_path={dirs[101]}",
             f"--pretrained_poseAE_path={dirs[102]}",
             f"--pretrained_appSample_path={dirs[103]}",
             f"--pretrained_poseSample_path={dirs[104]}"]
    n = DF_TEST_BATCHES
    trees = {1001: ("test_result", ("x", "x_target", "G", "pose",
                                    "pose_target", "mask", "mask_target")),
             1002: (f"test_result_ROI7_SampleFgTrueSampleBgFalseSamplePose"
                    f"False_pretrain_{n}x16", ("x", "G", "pose"))}
    pose_launches, s8_launches, failures = {}, {}, []
    for model in (1001, 1002):
        for prec, extra in DF_PRECISIONS.items():
            out = os.path.join(tmp, f"df{model}_{prec}")
            pose, s8, by_route, wall, text = _run_cli_s8(
                [f"--model={model}", "--is_train=false", "--img_H=256",
                 "--img_W=256", "--synthetic_data=true",
                 f"--test_batch_num={n}", f"--model_dir={out}", *flags,
                 *extra, *(["--sample_fg=true"] if model == 1002 else [])])
            int8 = prec == "int8"
            # 1001: the target and source pose maps per batch; 1002: the
            # one real pose; int8 adds the calibration batch's pose maps
            want_pose = n * (2 if model == 1001 else 1) + int8
            # int8: the generator per batch plus the self-check pass, no
            # int8 encoder at 256; the stem and to_rgb on mma_sync
            want_s8 = (n + 1) * S8_GENERATOR_CONVS if int8 else 0
            want_routes = ({"mma_sync": 2 * (n + 1),
                            "wgmma": (n + 1) * (S8_GENERATOR_CONVS - 2)}
                           if int8 else dict.fromkeys(sc.ROUTES, 0))
            root = os.path.join(out, trees[model][0])
            counts = {d: len(os.listdir(os.path.join(root, d)))
                      for d in sorted(os.listdir(root))}
            ssim = _selfcheck(text) if int8 else None
            random_init = "RANDOM" in text
            path = f"model {model} {prec} (256)"
            print(f"[df256] {path}: {n} batches of 16 in {wall:.1f} s, "
                  f"RANDOM-init line {random_init}, files {counts}, pose "
                  f"kernel launches {pose} (expected {want_pose}), s8 conv "
                  f"launches {s8} {by_route} (expected {want_s8} "
                  f"{want_routes})"
                  + (f", self-check SSIM(int8,float) {ssim:.4f}" if int8
                     else ""), flush=True)
            if (random_init or pose != want_pose or s8 != want_s8
                    or by_route != want_routes
                    or counts != dict.fromkeys(trees[model][1], n * 16)):
                failures.append(path)
            pose_launches[path] = pose
            if int8:
                s8_launches[path] = by_route
    if failures:
        raise AssertionError("; ".join(failures))
    return pose_launches, s8_launches


def phase_df256_kernels(tmp):
    """Model 1001 at batch 16: device ms per stage in float32, bf16 and
    int8, the int8 batch by op under torch.profiler, and the s8 conv on
    every conv shape of one int8 batch (bit-equal, timed); then card vs
    CPU at batch 2 (float32, TF32 flags on, the control past the guard)
    -> the s8 routes' entries summed over one int8 batch."""
    from dpig_tpu_torch.apps.common import batch_to_device
    from dpig_tpu_torch.apps.testers import ConditionalTransferTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader

    batch = next(SyntheticLoader(16, 256, 256, seed=5))
    f32 = ConditionalTransferTester(Config(model_dir=tmp, **DF))
    kw = dict(model_dir=tmp, **DF)
    testers = {"float32": f32,
               "bfloat16": ConditionalTransferTester(Config(
                   compute_dtype="bfloat16", **kw), params=f32.cpu_state()),
               "int8": ConditionalTransferTester(Config(
                   inference_dtype="int8", int8_selfcheck=False, **kw),
                   params=f32.cpu_state())}
    jb = batch_to_device(batch, f32.device)
    testers["int8"]._inference_params(jb)
    for name, t in testers.items():
        ms, total = _stage_ms_sum(t, batch, reps=3)
        kernels, ops = _profile_transfer(t, batch)
        kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        print(f"[df256] model 1001 device ms per batch of 16, {name}: "
              f"{ {k: round(v, 3) for k, v in ms.items()} } sum {total:.3f};"
              f" device kernels (torch.profiler) {kernel_ms:.3f}", flush=True)
        if name == "int8":
            _int8_remainder(kernels, ops, "[df256]",
                            "model 1001 int8 batch of 16")
        del kernels, ops
    entries, n_calls = _s8_table(testers["int8"], jb, "[df256 s8]",
                                 "one int8 model-1001 batch of 16",
                                 reps=5, inner=3)
    if n_calls != S8_GENERATOR_CONVS:
        raise AssertionError(f"{n_calls} s8 launches in one 256 batch")
    del testers, jb

    cpu = ConditionalTransferTester(Config(platform="cpu", **kw),
                                    params=f32.cpu_state())
    small = next(SyntheticLoader(2, 256, 256, seed=99))
    g_cpu, s_cpu = _raw_outputs(cpu, small)

    def diff(outs):
        return (float((outs[0] - g_cpu).abs().max()),
                float((outs[1] - s_cpu).abs().max()))

    sound = diff(_raw_outputs(f32, small))
    _set_tf32(True)
    try:
        guarded = diff(_raw_outputs(f32, small))
        tf32 = diff(_raw_outputs_unguarded(f32, small))
    finally:
        _set_tf32(False)
    print(f"[df256 parity] model 1001, card vs CPU, batch 2 at full width, "
          f"max|diff| of (g_raw, score): float32 {sound[0]:.3e}, "
          f"{sound[1]:.3e}; with the TF32 flags on {guarded[0]:.3e}, "
          f"{guarded[1]:.3e}; TF32 past the guard (control) {tf32[0]:.3e}, "
          f"{tf32[1]:.3e}; tolerance {PARITY_TOL} (max|g_raw| "
          f"{float(g_cpu.abs().max()):.3f}, max|score| "
          f"{float(s_cpu.abs().max()):.3f})", flush=True)
    if max(sound + guarded) > PARITY_TOL:
        raise AssertionError("model 1001: card and CPU disagree beyond the "
                             "tolerance")
    if min(tf32) <= PARITY_TOL:
        raise AssertionError("model 1001: a TF32 run passes the tolerance")
    del cpu, f32
    phase_train_parity(os.path.join(tmp, "df_parity"), DF, fg_bg=False,
                       tag="[df256 train parity] model 101,",
                       tol=DF_TRAIN_PARITY_TOL, df256=True)
    return entries


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
        bf16 = phase_bf16(tmp)
        s8 = phase_s8_conv()
        s8_by_path, int8_pose = phase_int8(tmp)
        df_dirs, df_train = phase_df256_train(tmp)
        df_pose, df_s8 = phase_df256_test(tmp, df_dirs)
        df_entries = phase_df256_kernels(tmp)
    by_path = {"model 12 transfer": model12, **sampling,
               "model 1 training": train, **stage2, **data, **bf16,
               **int8_pose, **df_train, **df_pose}
    for path in (*df_train, *df_pose):
        if not by_path[path]:
            raise AssertionError(f"the pose kernel was not launched on "
                                 f"{path}")
    kernel["launches"] = sum(by_path.values())
    kernel["launches_by_path"] = by_path
    s8_by_path.update(df_s8)
    for route, entry in s8.items():
        entry["df256"] = {k: df_entries[route][k] for k in (
            "per", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "mma_sync_ms", "cudnn_bf16_ms", "max_abs_err", "shapes")}
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   df_entries[route]["max_abs_err"])
        entry["launches_by_path"] = {p: n[route]
                                     for p, n in s8_by_path.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if not entry["launches"]:
            raise AssertionError(f"the s8 conv's {route} route was not "
                                 "launched on the int8 paths")
    print(f"[done] chip_smoke.py in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [kernel, *s8.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
