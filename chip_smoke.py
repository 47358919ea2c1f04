#!/usr/bin/env python3
"""On-card smoke test of dpig_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and `nvcc`.
Phases, each printing one line; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi), its driver,
              cuDNN, and the host's CPU (where the parity phases' CPU
              references run); TF32 off for cuDNN convs and cuBLAS
              matmuls, so float32 is float32;
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
              exceed it. Where the check fails, the phase fails, after
              printing the CPU reference step against the CPU's float64
              step and each side's float32 step against a float64 step
              (which side moved, ROADMAP §3: the card's, when cuDNN's
              float32 backward of the D's Conv_1 went wrong, before the
              DCGAN D's convs left cuDNN).

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
              csrc/s8_conv_sm90.cu; narrow_ci, csrc/s8_conv_narrow_ci.cu,
              the pose stem; narrow_co, csrc/s8_conv_narrow_co.cu,
              to_rgb) and on the mma_sync kernel (csrc/s8_conv.cu, the
              yardstick and the route of any other shape) too: 0 elements
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
              TF32 control) and one model-101 step (phase 7's; where it
              fails, also read against a float64 step on the card and on
              the CPU, and with cuDNN's deterministic algorithms). The pose
              kernel at 256x256 for B = 6 and 16 is in phase 3.

17. demo     `--test_one_by_one` through the CLI at full Market width on
              DEMO_PAIRS pairs of 128x64 JPEGs with OpenPose pickles written
              from a seed (a name without peaks, an image without a
              subset): 2 pose launches per written pair, ms per pair; the
              same demo on the CPU with the same weights: the seven
              trees' names equal, pose / mask / image PNGs bit-equal, G
              within one level; one pair's g_raw and D score within
              PARITY_TOL.
18. d_arch   model 1 through the CLI with `--D_arch` DCGANRegion, Patch
              and FCDis, float32 and bf16, D_ARCH_STEPS steps each (ms per
              step, finite metrics, phase 6's pose launches); one step of
              each card vs CPU within D_ARCH_PARITY_TOL (phase 7's limits,
              the Patch D's ill-conditioned gradient excepted), a TF32
              step past the guard outside them.
19. remat    `--remat` through the CLI for models 1 and 101 (2 steps);
              one step with and without remat from the same weights for
              model 1 at batch 16 and 256 and model 101 at 6: ms per step,
              peak torch.cuda.max_memory_allocated, the G-step losses
              within REMAT_LOSS_TOL, one pose launch per step; whether
              batch 256 fits the card without remat is printed.
20. inversion `--inverse_fg --inverse_bg` through the CLI at batch 16,
              INVERSION_STEPS Adam steps (no pose launch: the inversion
              renders no pose map), ms per Adam step on a built tool; card
              vs CPU from the same weights, batch and z0 within
              INVERSION_TOL after INVERSION_FEW and INVERSION_STEPS steps,
              beside a float64 run of the mappers.
21. ddp      data parallelism across processes: (a) model 1 through the
              CLI at full Market width, batch 16, DDP_STEPS steps as rank
              0 of a one-rank NCCL group (`--coordinator_address=127.0.0.1:
              <port> --num_processes=1 --process_id=0`: the gradient and
              metric all-reduces counted in every step), resumed to
              DDP_RESUME_TO, ms per step beside the same run without a
              group; (b) two ranks sharing the card on gloo, asked for by
              argument (NCCL refuses two ranks on one device): one model-1
              step on two batches of 8 against the world-1 step on the 16
              rows, in float64 within TRAIN_PARITY_TOL (per-rank
              BatchNorm statistics outside it) and in float32 (the
              all-reduce exact, as near the float64 step as world 1's),
              one model-3 step (`fresh`) within STAGE2_PARITY_TOL (TF32
              past the guard outside it), ms per step beside world 1's;
              which gloo collectives take CUDA tensors; (c) one
              int8 model-12 batch over the two ranks, 8 rows each, with
              the same tables, against world 1's rows within world 1's
              int8-vs-float32 gap, with each path's s8 launches per route
              (the stem on narrow_ci, to_rgb on narrow_co); the s8 conv on
              every shape of a batch of 8 bit-equal to its plain version on
              both kernels (and the pose kernel at B=8 in phase 3).
22. score    `python -m dpig_tpu_torch.eval.score 1 <phase 4's model_dir>
              test_result` and `--mask` on the card (the IS-skipped
              line), then `score_stage1` on the card and on the CPU:
              every value within SCORE_TOL, score.txt / score_mask.txt
              equal; images scored per second on each.
23. quality  the int8 gate (`python -m dpig_tpu_torch.eval.int8_quality`)
              at full width: Market `train` QUALITY_STEPS at bs64
              (bfloat16, fast D step; ms per step, images/s), `check`,
              `check --transfer`, `check --per_layer`, `sweep` (all six
              rows, on SWEEP_BATCHES batches) and `gate` (exit code as its verdict line); then
              `--size=256`: `train` QUALITY_256_STEPS at bs16, `check`,
              `sweep`, `gate`; each path's s8 launches per route and pose
              launches as `_gate_launches` counts them; the s8 conv on
              every call of one gate batch (Market 64 with --transfer) as
              in phase 14; at 256 the gate batch of 16 makes phase 16's
              model-1001 calls, shape for shape: each is checked
              bit-equal on its route and on mma_sync, and its times are
              [df256 s8]'s;
              `check` at batch 2 on the card and on the CPU from one
              checkpoint, its four SSIM numbers within half the CPU's
              int8-vs-float SSIM gap.
24. convert  the dataset converters (`python -m
              dpig_tpu_torch.data.convert.run`) on this host at full width,
              on seeded JPEGs and OpenPose pickles: Market 128x64 (train
              with its flip shard, test), DeepFashion 256x256 (with
              roi10_mask) and the rcv converter on a MaskRCNN-remapped
              pickle, host ms per converted pair; every record read and
              parsed natively and plainly alike; the Market test split's
              batches equal with 0 workers, LOADER_WORKERS threads and 2
              processes; models 1 (CONVERT_STEPS steps, full Config()
              width) and 12 (CONVERT_TEST_BATCHES batches) through the CLI
              on the converted Market records and one model-101 step at
              batch DF_TRAIN_BATCH on the DeepFashion ones, each path's
              pose launches as the phases above count them.
25. pipeline `python -m dpig_tpu_torch.apps.pipeline_demo <dir>
              PIPELINE_SCALE` on the card: stick people drawn, converted,
              models 1 -> 2 -> 3 -> 4 trained on the port's checkpoints,
              testers 12 / 11 / 13, scored; results.json printed; wall ms
              per step of each stage; pose launches of each stage and
              tester, each > 0; the Stage-I L1 must fall.
26. critic ab `python -m dpig_tpu_torch.apps.critic_batch_ab` on the card,
              CRITIC_AB_STEPS steps of batch CRITIC_AB_BATCH a mode (the W
              tails and moment gaps printed; the A/B renders no pose
              map: its launches are counted, 0), then 3 steps of batch 4
              of each mode on the card and on the CPU from one seed, each
              W tail within STAGE2_PARITY_TOL absolute and each moment gap
              within it relative.

27. tf1 import  a TF1 checkpoint (TF V2 tensor bundle) of every scope at
              full Market width, written from a seeded template of the
              testers' nets in the reference's names and layouts
              (`train/tf1_bundle.write_bundle`; no TensorFlow on the
              card's machine): `python -m dpig_tpu_torch.train.tf1_import`
              on it, every imported tensor bit-equal to its source; models
              12 and 11 (`--sample_app --pose_source=sampled`) through the
              CLI from the imported checkpoint with the four
              --pretrained_* flags, TF1_BATCHES batches, their trees
              byte-equal to the same testers run on the source weights;
              pose launches (2 / 3 per batch); the bundle's bytes and its
              write, read and import seconds with the card's name and
              power limit.
28. zoo      the modules no CLI path reaches, at their JAX defaults' full
              width, batch ZOO_BATCH, float32: ResnetGenerator (128x64,
              dim 64, 6 blocks a scale, z 128), ResnetDiscriminator and
              MultiplicativeDCGANDiscriminator (128x64, dim 64),
              DCGANDiscriminatorAttr (27 attributes, dim 64, keep 0.5 on
              seeded masks, on 8x4 maps of 640 channels, the Market
              encoder tower's output), DCGANGenerator (64x64, dim 64),
              FCGenerator (out 128*64*3), PlainEncoder (z 64, repeat 5,
              hidden 128, image + 18-channel pose), PlainDecoder (128x64,
              repeat 5, hidden 128), the DCGAN (4 stages), Region and
              Patch Ds in 'wgan-gp' (LayerNorm), SSIM at 128x64 and
              256x256, MS-SSIM at 256x256: finite outputs, device ms of the
              forward (CUDA graph replay; SSIM's by CUDA events, its window
              is copied in each call) and of forward + backward (CUDA
              events), card vs CPU at batch 2 on the same weights and
              inputs within ZOO_PARITY_TOL; one WGAN-GP critic step
              (`losses/gan.py:d_loss("wgan-gp")`, alpha a tensor) of the
              'wgan-gp' DCGAN D and of ResnetDiscriminator: the penalty,
              device ms at ZOO_BATCH, the critic's gradients card vs CPU
              at batch 2; `utils/plot.load_metrics` on phase 6's
              metrics.jsonl: the logged steps and values. No hand kernel
              runs here (`plot_metrics` needs matplotlib, not on the
              card's machine).

The line before the last is {"kernels": [...]}: the pose kernel with its
launches on each path, and the s8 conv's four routes (wgmma, narrow_ci,
narrow_co, and mma_sync, the yardstick, timed on every call and launched
by no main path), each with its launches on the int8 paths and its times
summed over its calls of one int8 model-12 batch, under "df256" over one
int8 model-1001 batch at
256x256, under "ddp batch 8" over one rank's int8 model-12 batch of 8
and under "gate Market batch 64" over one int8 gate batch of 64 (the
256 gate batch makes the "df256" calls); the last line is {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import math
import os
import pickle
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
                 "256x256 B=6": dict(b=6, h=256, w=256, k=18),
                 "Market B=8": dict(MARKET, b=8),  # a rank's rows, [ddp]
                 "Market B=64": dict(MARKET, b=64)}  # the int8 gate's batch
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
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi, flush=True)
    print(f"[device] {name} | nvidia-smi: {smi} | count "
          f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} cudnn {torch.backends.cudnn.version()} | "
          f"driver {driver} | cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    print(f"[device] host: {_host_cpu()}", flush=True)
    return name


def _host_cpu() -> str:
    """The host CPU's model, cores, vector ISA and PyTorch's CPU kernels'
    capability: the CPU references of the parity phases run there."""
    model, flags = "unknown", set()
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key.strip() == "model name" and model == "unknown":
                model = value.strip()
            elif key.strip() == "flags" and not flags:
                flags = set(value.split())
    isa = [x for x in ("avx2", "avx512f", "avx512_bf16", "amx_tile")
           if x in flags]
    return (f"{model}, {os.cpu_count()} CPUs, {torch.get_num_threads()} "
            f"torch threads, {' '.join(isa) or 'no AVX2'}, torch CPU "
            f"capability {torch.backends.cpu.get_cpu_capability()}")


def phase_build():
    """The CUDA kernel (nvcc) and the host tfrecord parser (g++), built at
    once, each by its own compiler process."""
    from concurrent.futures import ThreadPoolExecutor
    from dpig_tpu_torch.kernels import _build
    sources = {"pose_raster": ("pose_raster.cu", _build.load),
               "s8_conv": ("s8_conv.cu", _build.load),
               "s8_conv_sm90": ("s8_conv_sm90.cu", _build.load),
               "s8_conv_narrow_ci": ("s8_conv_narrow_ci.cu", _build.load),
               "s8_conv_narrow_co": ("s8_conv_narrow_co.cu", _build.load),
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
                        "producer / 216 consumers"),
                       ("s8_conv_narrow_ci", "; 18 kernels: 1x1 / 3x3 x "
                        "out s8 / bf16 / f32 x residual none / s8 / bf16; "
                        "dynamic shared memory"),
                       ("s8_conv_narrow_co", "; 2 kernels: 1x1 / 3x3; "
                        "dynamic shared memory")):
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
    from dpig_tpu_torch.train.parity import to_float64
    return to_float64(app)


def _float32_gaps(cfgs, batch, fg_bg, ref):
    """What float32 gives on each side: the CPU's float32 step `ref`
    against the CPU's float64 step, the card's float32 step against the
    card's float64 step, and the card's float32 step with cuDNN's
    deterministic algorithms (`cudnn.deterministic`, no benchmark) against
    the card's float64 step and against `ref`. Every step's D step starts
    from `ref`'s updated G."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.train.parity import recorded_train_step, step_errors

    def step(platform, device, wide=False):
        app = Stage1App(cfgs[platform], torch.device(device), fg_bg=fg_bg)
        return recorded_train_step(_float64(app) if wide else app, batch,
                                   g_updated=ref.g_updated)

    card64 = step("", "cuda", wide=True)
    card32 = step("", "cuda")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark, cudnn.enabled
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        card_det = step("", "cuda")
        cudnn.enabled = False
        card_native = step("", "cuda")
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.enabled = saved
    return {"the CPU's float32 step against its float64 step": step_errors(
                step("cpu", "cpu", wide=True), ref),
            "the card's float32 step against the card's float64 step":
                step_errors(card64, card32),
            "the card's float32 step, cuDNN deterministic, against the "
            "card's float64 step": step_errors(card64, card_det),
            "the card's float32 step, cuDNN deterministic, against the "
            "CPU's float32 step": step_errors(ref, card_det),
            "the card's float32 step without cuDNN (PyTorch's own conv "
            "kernels) against the card's float64 step": step_errors(
                card64, card_native)}


def phase_train_parity(model_dir, size=None, fg_bg=True,
                       tag="[train parity]", tol=None, df256=False,
                       d_arch=False):
    """One train step, batch 2 at full width, default variant, from the
    same weights on the card and on the CPU, the card's D step from the
    CPU's updated G: float32, with the TF32 flags on, and two controls with
    TF32 on (past the float32 guard; the forwards alone guarded, so TF32 in
    the backward passes alone). Then the same with the L1 term alone as
    the G objective (see TRAIN_PARITY_TOL). `size` (Config fields) and
    `fg_bg` pick the model: Market model 1 by default.

    `tol` replaces TRAIN_PARITY_TOL. `df256`: the D-backward TF32 control
    is shown, not required (see DF_TRAIN_PARITY_TOL). Without
    `d_arch` (a D other than DCGAN) the L1-term runs and the D-backward
    control are left out (the L1 term reads the generator's backward,
    which the D does not change), and the control past the guard must
    break the check on one of its limits, not on each G net's (such a D
    moves the generator's TF32 error less). A failing check prints
    `_float32_gaps` (each side's float32 step against a float64 step, the
    card's also with cuDNN's deterministic algorithms and without cuDNN).
    A limit on a key the step does not have (`d_stats` of a D without
    BatchNorm) is not read."""
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
    terms = (("G objective", contextlib.nullcontext),
             ("L1 term", _l1_term_only))[:1 if d_arch else 2]
    errs, g_ref = {}, None
    for term, context in terms:
        with context():
            ref = recorded_train_step(
                Stage1App(cfgs["cpu"], torch.device("cpu"), fg_bg=fg_bg),
                batch)
            if term == "G objective":
                g_ref = ref
            for label, (tf32, step_fn) in runs.items():
                if term == "L1 term" and "past the guard" in label:
                    continue
                if "forwards guarded" in label and d_arch:
                    continue  # a run that nothing below reads
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
    tols = {"G objective": tol or TRAIN_PARITY_TOL,
            "L1 term": L1_GRAD_TOL}
    tols = {term: tols[term] for term, _ in terms}
    for (term, label), e in errs.items():
        print(f"{tag} {term}, {label}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in e.items()
            if term == "G objective" or k.split()[0] in G_NETS), flush=True)
    print(f"{tag} card vs CPU, one step, batch 2 at full width "
          f"(losses: relative diff; sub-nets: gradient ||diff|| / ||grad||, "
          f"'max': max|diff| / max|grad|; d_stats: max abs diff); "
          f"tolerances {tols}", flush=True)
    failed = [(term, label) for term, tol_ in tols.items()
              for label in ("float32", "TF32 flags on")
              if any(errs[term, label].get(k, 0.0) > t
                     for k, t in tol_.items())]
    if failed:
        # Which side moved (ROADMAP §3): the CPU reference step itself
        # against the CPU's float64 step, then each side's float32 step
        # taken again against a float64 step.
        wide = recorded_train_step(
            _float64(Stage1App(cfgs["cpu"], torch.device("cpu"),
                               fg_bg=fg_bg)), batch,
            g_updated=g_ref.g_updated)
        ref_err = step_errors(wide, g_ref)
        off = [k for k, t in tols["G objective"].items()
               if ref_err.get(k, 0.0) > t]
        print(f"{tag} G objective, the CPU reference step against the "
              f"CPU's float64 step: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in ref_err.items())
              + f"; beyond the tolerances: {off or 'none'}", flush=True)
        for what, gap in _float32_gaps(cfgs, batch, fg_bg, g_ref).items():
            print(f"{tag} G objective, {what}: " + ", ".join(
                f"{k} {v:.3e}" for k, v in gap.items()), flush=True)
        raise AssertionError(f"card and CPU train steps disagree beyond "
                             f"the tolerances {failed}")
    guarded_forwards = "control: forwards guarded only, TF32"
    # (term, run, keys, whether every key must exceed its limit or one)
    controls = [("G objective", "control: past the guard, TF32", G_NETS,
                 all)]
    if d_arch:  # the check as a whole must fail a TF32 step
        controls = [("G objective", "control: past the guard, TF32",
                     tuple(tols["G objective"]), any)]
    else:
        controls.append(("L1 term", guarded_forwards, ("ID_AE",), all))
    if not (d_arch or df256):
        controls.append(("G objective", guarded_forwards,
                         ("Discriminator",), all))
    for term, label, keys, need in controls:
        if not need(errs[term, label].get(k, 0.0) > tols[term][k]
                    for k in keys):
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


S8_SOURCES = {"wgmma": "s8_conv_sm90.cu",
              "narrow_ci": "s8_conv_narrow_ci.cu",
              "narrow_co": "s8_conv_narrow_co.cu", "mma_sync": "s8_conv.cu"}


def _s8_route_entry(route, rows, per):
    """The kernels-line entry of one s8 route: its times, bound and
    yardsticks summed over its calls of one int8 batch. The mma_sync
    kernel, the yardstick, is entered with its times on every call of the
    batch, whatever their route."""
    yardstick = route == "mma_sync"
    mine = [r for r in rows if yardstick or r["route"] == route]

    def per_batch(key):
        vals = [r[key] for r in mine]
        if not mine or any(v is None for v in vals):
            return None
        return sum(v * r["launches_per_batch"] for v, r in zip(vals, mine))

    bound_by = max(("operations", "bytes"), key=lambda b: sum(
        r["bound_ms"] * r["launches_per_batch"] for r in mine
        if r["bound_by"] == b))
    routed = sum(r["launches_per_batch"] for r in mine
                 if r["route"] == route)
    return {"name": f"s8_conv ({route})", "route": "cuda",
            "source": f"dpig_tpu_torch/csrc/{S8_SOURCES[route]}",
            "replaces": "dpig_tpu/models/quant.py:71",
            "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_batch("mma_sync_ms" if yardstick else "ms"),
            "plain_ms": per_batch("plain_ms"),
            "bound_ms": per_batch("bound_ms"), "bound_by": bound_by,
            "library_ms": per_batch("int_mm_ms"),
            "library_call": "torch._int_mm on the im2col matrix (the "
                            "integer product alone); null where it refuses "
                            "a shape",
            "mma_sync_ms": per_batch("mma_sync_ms"),
            "cudnn_bf16_ms": per_batch("cudnn_bf16_ms"),
            "per": (f"all {sum(r['launches_per_batch'] for r in mine)} "
                    f"calls of {per}, {routed} of them routed here"
                    if yardstick else f"its {routed} calls of {per}"),
            "shapes": mine}


def phase_s8_conv():
    """The s8 conv on every conv shape one int8 model-12 batch at full
    Market width gives it (the generator and the FG/BG encoder, recorded
    from a real batch after calibration), on the route `plan` picks and on
    the mma_sync kernel too: each bit-equal to the
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
    """`_s8_calls_table` of the s8 conv calls of one `transfer_step` of
    the calibrated int8 `tester` on the device `batch`."""
    return _s8_calls_table(
        _record_s8_calls(lambda: tester.transfer_step(batch)), tag, per,
        reps, inner)


def _s8_differing(c):
    """One recorded s8 conv call on the route `plan` picks and on mma_sync
    against the plain version -> ({route: elements that differ}, max
    |diff|)."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    how = sc.plan(tuple(c["x8"].shape), tuple(c["w8"].shape), c["stride"])
    want = sc.s8_conv_plain(**c)
    differ, err = {}, 0.0
    for route in {how.route, "mma_sync"}:
        got = sc.s8_conv_cuda(**c, route=route)
        torch.cuda.synchronize()
        differ[route] = int((got != want).sum())
        err = max(err, float((got.float() - want.float()).abs().max()))
    return differ, err


def _s8_calls_table(calls, tag, per, reps=25, inner=20):
    """The recorded s8 conv `calls` of one int8 batch, grouped by shape:
    each bit-equal to the plain version on its route and on mma_sync,
    with the times of both kernels, the plain version, cuDNN's bf16 conv
    and `torch._int_mm`, the bound and its share, printed under `tag` ->
    (the routes' entries summed per batch, the number of calls).
    `reps` / `inner` set the CUDA-graph timing of the kernels and the
    yardsticks."""
    from dpig_tpu_torch.kernels import s8_conv as sc
    from dpig_tpu_torch.models.layers import conv2d_same

    shapes = {}
    for c in calls:
        shapes.setdefault(_s8_key(c), []).append(c)
    rows, worst = [], 0
    for key, group in shapes.items():
        c = group[0]
        stride = c["stride"]
        how = sc.plan(tuple(c["x8"].shape), tuple(c["w8"].shape), stride)
        differ, err = _s8_differing(c)
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
    used = {r["route"] for r in rows} | {"mma_sync"}
    entries = {r: _s8_route_entry(r, rows, per) for r in sc.ROUTES
               if r in used}
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
    total = {k: sum(r[k] * r["launches_per_batch"] for r in rows)
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


def _counted(fn):
    """fn() with the pose kernel's and the s8 conv's launch counts set to
    0 just before and read just after; stdout kept -> (result, pose
    launches, s8 launches by route, wall s, stdout)."""
    from dpig_tpu_torch.kernels import pose_raster
    from dpig_tpu_torch.kernels import s8_conv as sc
    pose_raster.launches = sc.launches = 0
    sc.launches_by_route.update(dict.fromkeys(sc.ROUTES, 0))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sys.stdout.write(out.getvalue())
    return (result, pose_raster.launches, dict(sc.launches_by_route), wall,
            out.getvalue())


def _run_cli_s8(argv):
    """`dpig_tpu_torch.main.main(argv)` under `_counted` -> (pose
    launches, s8 launches, s8 launches by route, wall s, stdout)."""
    from dpig_tpu_torch import main as port_main
    from dpig_tpu_torch.kernels import s8_conv as sc
    _, pose, by_route, wall, text = _counted(lambda: port_main.main(argv))
    return pose, sc.launches, by_route, wall, text


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


def _s8_routes(total, stem, rgb):
    """The s8 launches by route of `total` calls, `stem` of them pose stems
    (narrow_ci) and `rgb` of them to_rgb (narrow_co): the rest on wgmma,
    none on mma_sync."""
    return {"wgmma": total - stem - rgb, "narrow_ci": stem,
            "narrow_co": rgb, "mma_sync": 0}


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
    # path: (flags, batches, s8 launches of the generator, of them the
    # stem's and to_rgb's, encoder run per batch, pose launches per batch).
    # Calibration adds one int8 encoder pass (its embeddings) and the
    # self-check one int8 generator pass; the fallback runs the two named
    # layers (dec/Conv_13, to_rgb) in bf16, and the legacy graph has no s8
    # stem. The narrow_ci route takes the 18-channel stem, narrow_co the
    # 3-channel to_rgb, wgmma every other conv (all the encoder's).
    runs = {
        "model 12 transfer int8": (
            ["--model=12"], INT8_BATCHES, S8_GENERATOR_CONVS, 1, 1, True, 2),
        "model 11 sampling int8": (
            ["--model=11", "--sample_app=true", "--pose_source=sampled"],
            INT8_BATCHES, S8_GENERATOR_CONVS, 1, 1, False, 3),
        "model 12 int8 island fallback": (
            ["--model=12", f"--int8_fallback_layers={INT8_FALLBACK}"], 1,
            S8_GENERATOR_CONVS - 2, 1, 0, True, 2),
        "model 12 int8 legacy fallback": (
            ["--model=12", f"--int8_fallback_layers={INT8_FALLBACK}",
             "--int8_fallback_mode=legacy"], 1, S8_GENERATOR_CONVS - 3, 0,
            0, True, 2)}
    s8_launches, pose_launches = {}, {}
    for i, (path, (flags, n, gen, stem, rgb, enc, pose_per)) in enumerate(
            runs.items()):
        want_s8 = S8_ENCODER_CONVS + gen + n * (gen + (
            S8_ENCODER_CONVS if enc else 0))
        want_routes = _s8_routes(want_s8, (n + 1) * stem, (n + 1) * rgb)
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
# Market's d_stats limit is kept. Where the card's G-step loss error comes
# from (same card): its float32 step reads 3.5e-5 from its own float64
# step, the same with cuDNN's deterministic algorithms and 1.9e-5 with
# cuDNN off (PyTorch's im2col + cuBLAS convs), against the CPU's 1.1e-7;
# the TF32 flags change nothing and TF32 past the guard reads 2.85e-2. So
# no TF32 runs here: the card's float32 conv arithmetic, amplified by the
# D's BatchNorm over 2 nearly equal fakes (ROADMAP §3).
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
            # int8 encoder at 256; the stem on narrow_ci, to_rgb on
            # narrow_co
            want_s8 = (n + 1) * S8_GENERATOR_CONVS if int8 else 0
            want_routes = _s8_routes(want_s8, (n + 1) * int8, (n + 1) * int8)
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


# ------------------------------------------- the remaining CLI modes
DEMO_IMAGES, DEMO_PAIRS = 8, 10
D_ARCHS = ("DCGANRegion", "Patch", "FCDis")
D_ARCH_STEPS, D_ARCH_LOG_STEP = 3, 1
# Card vs CPU limits of one model-1 step per `--D_arch` (phase 7's method):
# TRAIN_PARITY_TOL, except the Patch D's gradient. On an NVIDIA H100 80GB
# HBM3 at 700 W two runs of this phase read, float32 (DCGANRegion / Patch
# / FCDis; the same with the TF32 flags on): G-step losses 2.6e-7 / 2.0e-7
# / 1.1e-7, Encoder 7.3e-4 / 7.7e-4 / 8.1e-4, ID_AE 1.7e-4 / 4.4e-4 /
# 2.4e-5, Discriminator 2.8e-6 to 3.2e-6 / 6.4e-6 and 9.6e-4 / 1.2e-5;
# past the float32 guard with TF32 on: losses 2.0e-5 / 4.3e-5 / 2.0e-5,
# Encoder 2.0e-2 / 2.6e-2 / 2.1e-2, Discriminator 1.5e-2 / 2.0e-2 to
# 2.3e-2 / 1.9e-3 to 2.2e-3. The Patch D's gradient is ill-conditioned at
# batch 2 on nearly equal fakes: float32 rounding in the fakes or in a
# sum order moves it by up to ~1e-3. Against each side's own float64 step
# the card read 5.8e-6 and then 9.6e-4, the CPU 3.9e-4 and then 2.6e-6,
# the card without cuDNN 2.1e-6 and 1.7e-6. Not TF32: the flags change
# nothing. Its limit is 5e-3, 5x from float32's 9.6e-4 and 4x from TF32's
# 2.0e-2.
D_ARCH_PARITY_TOL = {"DCGANRegion": TRAIN_PARITY_TOL,
                     "Patch": {**TRAIN_PARITY_TOL, "Discriminator": 5e-3},
                     "FCDis": TRAIN_PARITY_TOL}
INVERSION_STEPS, INVERSION_FEW = 300, 5
# Card vs CPU limits of the inversion (`--inverse_fg --inverse_bg`, batch
# 16 at full width, the same weights, batch and z0). Adam normalizes each
# coordinate's gradient, so a coordinate whose gradient is near its eps
# moves by what float32 makes of it, and the descent carries that: on an
# NVIDIA H100 80GB HBM3 at 700 W this phase read, after 5 steps, z 1.8e-4
# apart (the card 2.3e-5 and the CPU 1.6e-4 from a float64 run) and the
# losses 5.1e-7 relative; after 300, z 4.8e-2 apart (2.2e-2 and 4.9e-2
# from float64) and the losses 9.6e-5. At the tiny config the port's and
# the JAX package's float32 runs end 0.11 and 0.14 from a float64 run in z
# after 200 steps (tests/test_torch_inversion.py). So: z 1e-3 after 5
# steps, the losses 1e-5; after 300, the losses 2e-3 and z 0.5.
INVERSION_TOL = {"z_few": 1e-3, "loss_few": 1e-5, "z": 0.5, "loss": 2e-3}
# (model, batch) of the remat phase: batch 256 is the one the JAX package
# added --remat for (stage1_app.py:52-58); model 101 at the DF recipe's 6.
REMAT_RUNS = ((1, 16), (1, 256), (101, 6))
# The remat step's G-step losses against the plain step's from the same
# weights and batch (the same forward; the recompute comes after them):
# on an NVIDIA H100 80GB HBM3 at 700 W they read 0 at batch 16 and for
# model 101 at 6, and 4.4e-7 relative at batch 256, where cuDNN may pick
# other algorithms for the memory left: float32 rounding, held at 1e-5.
REMAT_LOSS_TOL = 1e-5


def _demo_inputs(root, h, w):
    """DEMO_IMAGES random h x w JPEGs with OpenPose-style pickles from a
    seed: one scored subset per image (one image with none), a few
    keypoints missing, and DEMO_PAIRS pairs (one naming an image without
    peaks) -> (img_dir, pair, peaks, subsets paths, the pairs a demo
    writes: both names with peaks and a subset)."""
    import pickle
    from PIL import Image
    rng = np.random.default_rng(21)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir)
    names = [f"p{i:02d}.jpg" for i in range(DEMO_IMAGES)]
    peaks, subsets = {}, {}
    for n in names:
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(img_dir, n))
        missing = set(rng.choice(18, 3, replace=False).tolist())
        peaks[n] = [[] if k in missing else
                    [(float(rng.integers(4, w - 4)),
                      float(rng.integers(4, h - 4)), 0.9, k)]
                    for k in range(18)]
        s = np.full((1, 20), -1.0)
        s[0, :18] = [k if k not in missing else -1 for k in range(18)]
        s[0, -2] = 1.0
        subsets[n] = s
    subsets[names[-1]] = np.zeros((0, 20))
    pairs = [(names[i % DEMO_IMAGES], names[(i + 3) % DEMO_IMAGES])
             for i in range(DEMO_PAIRS - 1)] + [(names[0], "absent.jpg")]
    written = sum(1 for a, b in pairs if a in peaks and b in peaks
                  and len(subsets[a]) and len(subsets[b]))
    paths = []
    for obj, fn in ((pairs, "pairs.p"), (peaks, "peaks.p"),
                    (subsets, "subsets.p")):
        paths.append(os.path.join(root, fn))
        with open(paths[-1], "wb") as f:
            pickle.dump(obj, f, protocol=2)
    return (img_dir, *paths, written)


def phase_demo(tmp):
    """`--test_one_by_one` through the CLI at full Market width on pairs
    written from a seed; the same demo on the CPU with the same (cold
    start) weights: the trees' names equal, pose and mask PNGs bit-equal,
    G within one level; g_raw and the D score of one pair card vs CPU
    within PARITY_TOL; ms per pair -> pose launches."""
    from PIL import Image
    from dpig_tpu_torch.apps import demo
    from dpig_tpu_torch.apps.testers import ConditionalTransferTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data import pose_tools as pt

    root = os.path.join(tmp, "demo")
    os.makedirs(root)
    cfg = Config(model_dir=os.path.join(root, "card"))
    h, w = cfg.img_H, cfg.img_W
    img_dir, pairs_p, peaks_p, subsets_p, expected = _demo_inputs(root, h,
                                                                  w)
    launches, wall = _run_cli([
        "--model=12", "--is_train=false", "--test_one_by_one=true",
        f"--demo_img_dir={img_dir}", f"--demo_pair_path={pairs_p}",
        f"--demo_all_peaks_path={peaks_p}",
        f"--demo_subsets_path={subsets_p}", f"--model_dir={cfg.model_dir}"])
    card_out = os.path.join(cfg.model_dir, "test_demo")
    written = len(os.listdir(os.path.join(card_out, "G")))

    card = ConditionalTransferTester(cfg)      # the CLI's weights (seed)
    cpu = ConditionalTransferTester(Config(
        platform="cpu", model_dir=os.path.join(root, "cpu")),
        params=card.cpu_state())
    t0 = time.perf_counter()
    demo.run_one_by_one(Config(model_dir=os.path.join(root, "timed")),
                        img_dir, pairs_p, peaks_p, subsets_p, tester=card)
    torch.cuda.synchronize()
    pair_ms = (time.perf_counter() - t0) * 1e3 / written
    cpu_out = demo.run_one_by_one(cpu.cfg, img_dir, pairs_p, peaks_p,
                                  subsets_p, tester=cpu)
    trees = [{d: sorted(os.listdir(os.path.join(o, d))) for d in demo.DIRS}
             for o in (card_out, cpu_out)]
    worst = {}
    for d, files in trees[0].items():
        for f in files:
            a, b = (np.asarray(Image.open(os.path.join(o, d, f)), np.int16)
                    for o in (card_out, cpu_out))
            worst[d] = max(worst.get(d, 0), int(np.abs(a - b).max()))

    import pickle
    with open(pairs_p, "rb") as f:
        a, b = pickle.load(f)[0]
    with open(peaks_p, "rb") as f:
        peaks = pickle.load(f)
    with open(subsets_p, "rb") as f:
        subsets = pickle.load(f)
    img = np.asarray(Image.open(os.path.join(img_dir, a)).convert("RGB"),
                     np.float32)
    batch = demo.pair_batch(img, pt.get_valid_peaks(peaks[a], subsets[a]),
                            pt.get_valid_peaks(peaks[b], subsets[b]), h, w)
    g_cpu, s_cpu = _raw_outputs(cpu, batch)
    g_card, s_card = _raw_outputs(card, batch)
    diff = (float((g_card - g_cpu).abs().max()),
            float((s_card - s_cpu).abs().max()))
    print(f"[demo] --test_one_by_one (CLI) at {h}x{w} hidden "
          f"{cfg.conv_hidden_num}: {DEMO_PAIRS} pairs, {written} written "
          f"(one name without peaks, one image without a subset), pose "
          f"kernel launches {launches} (expected {2 * written}), CLI wall "
          f"{wall:.1f} s; {pair_ms:.2f} ms per pair on a built tester "
          f"(transfer step, source pose, 7 PNGs); card vs CPU trees: "
          f"names equal {trees[0] == trees[1]}, max |diff| per tree "
          f"{worst}; one pair's (g_raw, score) max|diff| {diff[0]:.3e}, "
          f"{diff[1]:.3e} (tolerance {PARITY_TOL})", flush=True)
    if launches != 2 * written or written != expected:
        raise AssertionError(f"demo: {written} pairs written, {launches} "
                             "pose launches")
    if trees[0] != trees[1] or worst["G"] > 1 or any(
            v for d, v in worst.items() if d != "G"):
        raise AssertionError(f"demo trees differ: {worst}")
    if max(diff) > PARITY_TOL:
        raise AssertionError("demo: card and CPU disagree beyond the "
                             "tolerance")
    return {"--test_one_by_one demo": launches}


def phase_inversion(tmp):
    """`--inverse_fg --inverse_bg` through the CLI at full Market width,
    batch 16, INVERSION_STEPS Adam steps; the same inversion on a built
    tool (ms per Adam step), and card vs CPU from the same weights, batch
    and z0 after INVERSION_FEW steps and after INVERSION_STEPS, beside a
    float64 run of the mappers on the card (what float32 approximates)."""
    import copy
    from dpig_tpu_torch.apps.common import batch_to_device
    from dpig_tpu_torch.apps.inversion import InversionTool
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader

    model_dir = os.path.join(tmp, "inversion")
    os.makedirs(model_dir)
    launches, wall = _run_cli([
        "--model=11", "--is_train=false", "--inverse_fg=true",
        "--inverse_bg=true", "--synthetic_data=true",
        f"--model_dir={model_dir}"])
    saved = np.load(os.path.join(model_dir, "inverted_z.npz"))
    cfg = Config(model_dir=model_dir)
    card = InversionTool(cfg)
    host = next(SyntheticLoader(cfg.batch_size, cfg.img_H, cfg.img_W,
                                seed=cfg.random_seed))
    z0 = card.draw_noise(torch.Generator().manual_seed(cfg.random_seed),
                         cfg.batch_size)
    jb = batch_to_device(host, card.device)
    runs = {}
    for steps in (0, INVERSION_STEPS):
        card.invert(jb, z0, steps=steps)      # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[steps] = card.invert(jb, z0, steps=steps)
        torch.cuda.synchronize()
        runs[steps, "ms"] = (time.perf_counter() - t0) * 1e3
    step_ms = (runs[INVERSION_STEPS, "ms"] - runs[0, "ms"]) / INVERSION_STEPS

    cpu = InversionTool(Config(platform="cpu", model_dir=model_dir),
                        params=card.cpu_state())
    exact = copy.deepcopy(card)
    for mapper in exact.mappers.values():
        mapper.double()
        for m in mapper.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
    encode = exact._encode_app
    exact._encode_app = lambda batch: encode(batch).double()
    cb = batch_to_device(host, cpu.device)

    def zdist(a, b):
        return max(float((x.cpu().double() - y.cpu().double()).abs().max())
                   for x, y in zip(a[:2], b[:2]))

    res = {}
    for steps in (INVERSION_FEW, INVERSION_STEPS):
        got = card.invert(jb, z0, steps=steps)
        ref = cpu.invert(cb, z0, steps=steps)
        f64 = exact.invert(jb, {k: v.double() for k, v in z0.items()},
                           steps=steps)
        res[steps] = {"z": zdist(got, ref),
                      "loss": abs(float(got[2]) - float(ref[2]))
                      / float(ref[2]),
                      "card-f64 z": zdist(got, f64),
                      "cpu-f64 z": zdist(ref, f64),
                      "losses": (float(got[2]), float(ref[2]),
                                 float(f64[2]))}
    full = runs[INVERSION_STEPS]
    same = (np.array_equal(saved["z_fg"], full[0].cpu().numpy())
            and np.array_equal(saved["z_bg"], full[1].cpu().numpy()))
    print(f"[inversion] --inverse_fg --inverse_bg (CLI) at "
          f"{cfg.img_H}x{cfg.img_W} hidden {cfg.conv_hidden_num}, batch "
          f"{cfg.batch_size}, {INVERSION_STEPS} Adam steps: CLI wall "
          f"{wall:.1f} s, pose kernel launches {launches} (the inversion "
          f"renders no pose map, as in JAX); on a built tool "
          f"{runs[INVERSION_STEPS, 'ms']:.1f} ms in all, the encoder and "
          f"final loss {runs[0, 'ms']:.1f} ms, {step_ms:.3f} ms per Adam "
          f"step; inverted_z.npz equal to the built tool's run: {same}; "
          f"final loss {float(full[2]):.6f}", flush=True)
    for steps, r in res.items():
        print(f"[inversion] card vs CPU after {steps} steps: max|diff| z "
              f"{r['z']:.3e}, loss {r['loss']:.3e} relative; from the "
              f"float64 run: card z {r['card-f64 z']:.3e}, CPU z "
              f"{r['cpu-f64 z']:.3e}; losses card / CPU / float64 "
              f"{r['losses']}", flush=True)
    if launches:
        raise AssertionError(f"the inversion launched the pose kernel "
                             f"{launches} times")
    few, last = res[INVERSION_FEW], res[INVERSION_STEPS]
    if (few["z"] > INVERSION_TOL["z_few"]
            or few["loss"] > INVERSION_TOL["loss_few"]
            or last["z"] > INVERSION_TOL["z"]
            or last["loss"] > INVERSION_TOL["loss"]
            or not np.isfinite(float(full[2]))):
        raise AssertionError(f"inversion: card and CPU disagree beyond "
                             f"{INVERSION_TOL}")


def phase_d_arch(tmp):
    """Model 1 through the CLI with each `--D_arch` in float32 and bf16,
    D_ARCH_STEPS steps (phase 6's launch count, finite metrics, ms per
    step); then one step card vs CPU per arch (phase 7) -> pose launches
    per path."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.config import Config

    by_path = {}
    for arch in D_ARCHS:
        for dtype in ("float32", "bfloat16"):
            model_dir = os.path.join(tmp, f"d_{arch}_{dtype}")
            steps = []
            originals = _timed_steps({1: Stage1App}, {1: steps}, [0])
            try:
                launches, wall = _run_cli([
                    "--model=1", "--synthetic_data=true",
                    f"--D_arch={arch}", f"--compute_dtype={dtype}",
                    f"--max_step={D_ARCH_STEPS}",
                    f"--log_step={D_ARCH_LOG_STEP}",
                    f"--model_dir={model_dir}"])
            finally:
                Stage1App.train_step = originals[1]
            cfg = Config(model_dir=model_dir, max_step=D_ARCH_STEPS,
                         log_step=D_ARCH_LOG_STEP)
            expected = _expected_train_launches(cfg)
            print(f"[d_arch] model 1 --D_arch={arch} {dtype} (CLI), "
                  f"{D_ARCH_STEPS} steps of {cfg.batch_size}: ms per step "
                  f"{[round(s[0], 2) for s in steps]}, finite "
                  f"{all(s[2] for s in steps)}, pose kernel launches "
                  f"{launches} (expected {expected}), wall {wall:.1f} s",
                  flush=True)
            if launches != expected or len(steps) != D_ARCH_STEPS or not all(
                    s[2] for s in steps):
                raise AssertionError(f"--D_arch={arch} {dtype}: {steps}, "
                                     f"{launches} launches")
            by_path[f"model 1 D_arch={arch} {dtype}"] = launches
    for arch in D_ARCHS:
        phase_train_parity(os.path.join(tmp, f"d_parity_{arch}"),
                           {"D_arch": arch}, tag=f"[d_arch parity] {arch},",
                           tol=D_ARCH_PARITY_TOL[arch], d_arch=True)
    return by_path


def phase_remat(tmp):
    """Models 1 and 101 through the CLI with `--remat`; then one Stage-I
    step with and without it (model 1 at batch 16 and 256, model 101 at
    6) from the same weights and batch: ms per step (the second), the
    peak of torch.cuda.max_memory_allocated over both steps above what
    earlier phases hold (the nets, their optimizer state, the batch and
    the steps), the first step's losses against each other; batch 256
    without remat may not fit, which is recorded -> pose launches per
    path."""
    from dpig_tpu_torch.apps.common import batch_to_device
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.kernels import pose_raster

    by_path = {}
    for model, b in ((1, 16), (101, DF_TRAIN_BATCH)):
        size = [f"--img_H={DF['img_H']}", f"--img_W={DF['img_W']}"] if (
            model == 101) else []
        launches, wall = _run_cli([
            f"--model={model}", "--synthetic_data=true", "--remat=true",
            f"--batch_size={b}", "--max_step=2", "--log_step=1",
            f"--model_dir={os.path.join(tmp, f'remat_cli_{model}')}",
            *size])
        expected = _expected_train_launches(Config(max_step=2, log_step=1))
        print(f"[remat] model {model} --remat=true (CLI), 2 steps of {b}: "
              f"wall {wall:.1f} s, pose kernel launches {launches} "
              f"(expected {expected})", flush=True)
        if launches != expected:
            raise AssertionError(f"remat CLI: {launches} pose launches")
        by_path[f"model {model} --remat (CLI)"] = launches
    for model, b in REMAT_RUNS:
        size = DF if model == 101 else {}
        rows = {}
        for remat in (False, True):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()  # what earlier phases hold
            torch.cuda.reset_peak_memory_stats()
            app = Stage1App(Config(batch_size=b, remat=remat,
                                   model_dir=tmp, **size),
                            torch.device("cuda"), fg_bg=model == 1)
            state = app.init_state()
            batch = batch_to_device(next(SyntheticLoader(
                b, app.cfg.img_H, app.cfg.img_W, seed=7)), app.device)
            pose_raster.launches = 0
            try:
                first = {k: float(v) for k, v in
                         app.train_step(state, batch).items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                app.train_step(state, batch)
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError as e:
                if remat or b != 256:
                    raise
                rows[remat] = {"fits": False, "error": str(e)[:160]}
            else:
                rows[remat] = {
                    "fits": True, "first": first,
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "peak_GiB": (torch.cuda.max_memory_allocated() - base)
                    / 2 ** 30,
                    "launches": pose_raster.launches}
            del app, state, batch
            torch.cuda.empty_cache()
        plain, rem = rows[False], rows[True]
        gap = None
        if plain["fits"]:
            gap = max(abs(rem["first"][k] - v) / abs(v)
                      for k, v in plain["first"].items() if k != "d_loss")
        print(f"[remat] model {model} batch {b}: without remat "
              + (f"{plain['ms']:.1f} ms per step, peak "
                 f"{plain['peak_GiB']:.2f} GiB" if plain["fits"] else
                 f"does not fit ({plain['error']})")
              + f"; with remat {rem['ms']:.1f} ms, peak "
              f"{rem['peak_GiB']:.2f} GiB; pose kernel launches "
              f"{rem['launches']} for 2 steps; first step's G losses, "
              f"remat vs plain: {gap} relative (tolerance {REMAT_LOSS_TOL}); "
              f"d_loss {rem['first']['d_loss']}"
              + (f" vs {plain['first']['d_loss']}" if plain["fits"] else ""),
              flush=True)
        if rem["launches"] != 2 or (plain["fits"]
                                    and plain["launches"] != 2):
            raise AssertionError("remat: the pose kernel was not launched "
                                 "once per step")
        if gap is not None and gap > REMAT_LOSS_TOL:
            raise AssertionError("remat: the step's losses differ from the "
                                 "plain step's")
        by_path[f"model {model} remat step, batch {b}"] = rem["launches"]
    return by_path


# ------------------------------------------------------------------ DDP
# [ddp]: data parallelism across processes (dpig_tpu_torch/parallel/).
DDP_STEPS, DDP_RESUME_TO, DDP_LOG_STEP = 4, 6, 2
DDP_TIMED_STEPS = 1          # steps timed after the recorded one
DDP_RANKS_TIMEOUT = 480.0    # s, the two-rank group as a whole
# Two ranks of 8 rows against world 1 on 16, the whole step in float64
# (the embedding-stem sum, the nets' outputs and the ROI crop too): the
# card read at most 5.7e-15 on these keys (PERF.md §6), and the updated
# params at most 1.4e-10 apart; the same step with each rank's own
# BatchNorm statistics 8.3e-3 and up.
DDP_FLOAT64_TOL = {"g_step_losses": 1e-12, "d_loss": 1e-12, "Encoder": 1e-12,
                   "ID_AE": 1e-12, "Discriminator": 1e-12, "d_stats": 1e-12}
DDP_FLOAT64_UPDATE_TOL = 1e-8


def _ddp_cli(model_dir, max_step, nccl):
    """Model 1 through the CLI at full Market width, each step timed (a
    synchronize after it); with `nccl`, as rank 0 of a one-rank NCCL group
    (`--coordinator_address=127.0.0.1:<free port> --num_processes=1
    --process_id=0`). -> (ms per step, {(backend, world)} seen in the
    steps, pose launches, the collectives the steps reached)."""
    from dpig_tpu_torch import main as port_main
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.kernels import pose_raster
    from dpig_tpu_torch.parallel import dist

    argv = ["--model=1", "--synthetic_data=true", f"--max_step={max_step}",
            f"--log_step={DDP_LOG_STEP}", f"--model_dir={model_dir}"]
    if nccl:
        argv += [f"--coordinator_address=127.0.0.1:{dist.free_port()}",
                 "--num_processes=1", "--process_id=0"]
    step_ms, seen = [], set()
    calls = {"average_gradients": 0, "global_metrics": 0}
    saved = {k: getattr(dist, k) for k in calls}
    train_step = Stage1App.train_step

    def counting(name):
        def call(*args, **kw):
            calls[name] += dist.is_distributed()
            return saved[name](*args, **kw)
        return call

    def timed_step(app, state, batch):
        t0 = time.perf_counter()
        metrics = train_step(app, state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        seen.add((torch.distributed.get_backend() if dist.is_distributed()
                  else None, dist.world()))
        return metrics

    Stage1App.train_step = timed_step
    for k in calls:
        setattr(dist, k, counting(k))
    try:
        pose_raster.launches = 0
        port_main.main(argv)
        torch.cuda.synchronize()
        launches = pose_raster.launches
    finally:
        Stage1App.train_step = train_step
        for k, f in saved.items():
            setattr(dist, k, f)
    if dist.is_distributed():
        raise AssertionError("the CLI left its process group open")
    return step_ms, seen, launches, calls


def _params_of(nets):
    return {name: {k: v.detach().cpu().clone()
                   for k, v in m.state_dict().items()}
            for name, m in nets.items()}


def phase_ddp(tmp):
    """(a) Model 1 through the CLI at full Market width, batch 16, as rank
    0 of a one-rank NCCL group (every collective of the step runs), with
    a resume, beside the same run without a group (runs in turns: none,
    NCCL, NCCL resumed, none). (b) Two ranks sharing the one card on
    gloo (NCCL refuses two ranks on one device), asked for by argument,
    from the same weights, the D step and each critic iteration started
    where world 1's were: one full-width model-1 step on two batches of 8
    against the world-1 step on the batch of 16 in float64, the whole
    step (the step's arithmetic: metrics, gradients, the D's running
    statistics within DDP_FLOAT64_TOL, the updated params within
    DDP_FLOAT64_UPDATE_TOL, rank 1's record bit-equal to rank 0's; the
    same step with each rank's own BatchNorm statistics must break them);
    in float64 but for the float32 parts
    `to_float64` keeps by default, the embedding-stem sum and the nets'
    outputs, and with the outputs' alone (each within TRAIN_PARITY_TOL:
    where the float64 gap comes from); and in float32 (the averaged
    gradients the mean of the ranks' own bit for bit; no further from the
    float64 step than world 1's float32 step is, twice, on the G-step
    losses and gradients: cuDNN's
    float32 algorithms differ by batch size); one model-3 step (`fresh`)
    in float32 within STAGE2_PARITY_TOL, TF32 past the guard outside it.
    (c) One
    int8 model-12 batch over the two ranks, each on its 8 rows with the
    tables calibrated on the 16 (rank 0's given to both), against the
    world-1 batch within its own int8-vs-float32 gap; the s8 conv on
    every shape of a batch of 8, bit-equal to its plain version.
    The collectives probe runs in the same group: gloo takes the CUDA
    tensors `dist` hands it.
    -> (pose launches by path, s8 launches by path, the s8 entries at
    batch 8)."""
    from dpig_tpu_torch.apps.common import batch_to_device, select_device
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.apps.stage2_app import Stage2AppApp
    from dpig_tpu_torch.apps.testers import ConditionalTransferTester
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data.synthetic import SyntheticLoader
    from dpig_tpu_torch.kernels import pose_raster
    from dpig_tpu_torch.kernels import s8_conv as sc
    from dpig_tpu_torch.parallel import ranks
    from dpig_tpu_torch.train import checkpoint as ckpt
    from dpig_tpu_torch.train.parity import (recorded_train_step,
                                             step_errors, to_float64)

    # (a) ------------------------------------------------------------
    pose_by_path, s8_by_path, runs = {}, {}, {}
    cfg = Config(max_step=DDP_STEPS, log_step=DDP_LOG_STEP)
    expected = _expected_train_launches(cfg)
    for label, d, max_step, nccl in (
            ("no group", "ddp_plain_a", DDP_STEPS, False),
            ("NCCL world 1", "ddp_nccl", DDP_STEPS, True),
            ("NCCL world 1, resumed", "ddp_nccl", DDP_RESUME_TO, True),
            ("no group, again", "ddp_plain_b", DDP_STEPS, False)):
        model_dir = os.path.join(tmp, d)
        ms, seen, launches, calls = _ddp_cli(model_dir, max_step, nccl)
        n = len(ms)
        want_seen = {("nccl", 1)} if nccl else {(None, 1)}
        want_calls = 2 * n if nccl else 0
        print(f"[ddp] model 1 CLI, {label}: {n} steps, ms per step "
              f"{[round(x, 2) for x in ms]}, median after the first "
              f"{statistics.median(ms[1:]):.2f}; process group {seen}; "
              f"gradient all-reduces {calls['average_gradients']} "
              f"(expected {want_calls}), metric all-reduces "
              f"{calls['global_metrics']}; pose launches {launches}",
              flush=True)
        if seen != want_seen or calls["average_gradients"] != want_calls \
                or calls["global_metrics"] != (n if nccl else 0):
            raise AssertionError(f"[ddp] {label}: the steps did not run in "
                                 f"the process group asked for")
        if max_step == DDP_STEPS and launches != expected:
            raise AssertionError(f"[ddp] {label}: {launches} pose "
                                 f"launches, expected {expected}")
        if not launches:
            raise AssertionError(f"[ddp] {label}: no pose launch")
        runs[label] = ms
        pose_by_path[f"[ddp] model 1 CLI, {label}"] = launches
    nccl_dir = os.path.join(tmp, "ddp_nccl")
    with open(os.path.join(nccl_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line)["step"] for line in f]
    saved = sorted(os.listdir(os.path.join(nccl_dir, "ckpt")))
    stored = torch.load(os.path.join(ckpt.latest_checkpoint(nccl_dir),
                                     ckpt.STATE_FILE), map_location="cpu",
                        weights_only=True)
    want_logged = [s for s in range(DDP_RESUME_TO)
                   if s == 0 or s % DDP_LOG_STEP == DDP_LOG_STEP - 1]
    print(f"[ddp] NCCL run resumed from step {DDP_STEPS} to "
          f"{DDP_RESUME_TO}: {len(runs['NCCL world 1, resumed'])} steps, "
          f"metrics.jsonl steps {logged}, checkpoints {saved}, last at step "
          f"{stored['step']}", flush=True)
    if (len(runs["NCCL world 1, resumed"]) != DDP_RESUME_TO - DDP_STEPS
            or logged != want_logged or stored["step"] != DDP_RESUME_TO
            or saved != [f"step_{DDP_STEPS:08d}",
                         f"step_{DDP_RESUME_TO:08d}"]):
        raise AssertionError("[ddp] the NCCL run did not resume")
    plain = statistics.median(runs["no group"][1:]
                              + runs["no group, again"][1:])
    with_group = statistics.median(runs["NCCL world 1"][1:])
    print(f"[ddp] model 1, batch 16, ms per step after the first: no group "
          f"{plain:.2f} (both runs), NCCL world 1 {with_group:.2f}: "
          f"{with_group - plain:+.2f} ms ({with_group / plain - 1:+.2%})",
          flush=True)

    # (b) and (c): inputs and the world-1 references ------------------
    dev = select_device("")
    cfg16 = Config(batch_size=16, model_dir=os.path.join(tmp, "ddp_ranks"))
    h, w = cfg16.img_H, cfg16.img_W
    host16 = next(SyntheticLoader(16, h, w, seed=91))
    app = Stage1App(cfg16, dev)
    params1 = _params_of({"Encoder": app.encoder, "ID_AE": app.generator,
                          "Discriminator": app.disc})
    del app
    app = Stage1App(cfg16, dev, state=params1)
    one = recorded_train_step(app, host16)
    b16 = batch_to_device(host16, dev)
    one_ms = []
    for _ in range(DDP_TIMED_STEPS):
        t0 = time.perf_counter()
        app.train_step(one.state, b16)
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    del app, one.state
    one64 = recorded_train_step(to_float64(Stage1App(
        cfg16, dev, state=params1), stem=True, outputs=True), host16)
    one64_d = {k: v.detach().cpu()
               for k, v in one64.state.d_opt.params.items()}
    del one64.state
    parts32 = {}  # float64 but for to_float64's float32 parts
    for label, stem in (("the stem's sum and the outputs float32", False),
                        ("the outputs float32", True)):
        parts32[label] = recorded_train_step(to_float64(Stage1App(
            cfg16, dev, state=params1), stem=stem), host16)
        del parts32[label].state

    s2 = Stage2AppApp(cfg16, dev)
    frozen = _params_of(s2.frozen)
    params3 = _params_of({**s2.mappers, **s2.critics})
    loader = SyntheticLoader(16, h, w, seed=93)
    host3 = tuple(next(loader) for _ in range(s2.batches_per_step))
    noise = s2.step_noise(torch.Generator().manual_seed(5), 16).cpu()
    one3 = recorded_train_step(s2, host3, noise=noise)
    dev3 = tuple(batch_to_device(b, dev) for b in host3)
    one3_ms = []
    for _ in range(DDP_TIMED_STEPS):
        t0 = time.perf_counter()
        s2.train_step(one3.state, dev3, noise.to(dev))
        torch.cuda.synchronize()
        one3_ms.append((time.perf_counter() - t0) * 1e3)
    del s2, one3.state, dev3

    f32 = ConditionalTransferTester(Config(model_dir=cfg16.model_dir))
    state12 = f32.cpu_state()
    int8_cfg = dict(model_dir=cfg16.model_dir, inference_dtype="int8",
                    int8_selfcheck=False)
    pose_raster.launches = sc.launches = 0
    sc.launches_by_route = dict.fromkeys(sc.ROUTES, 0)
    t8 = ConditionalTransferTester(Config(**int8_cfg), params=state12)
    t8._inference_params(b16)
    images16 = t8.transfer_step(b16)[0].cpu()
    torch.cuda.synchronize()
    pose_by_path["[ddp] int8 model 12, world 1, batch 16"] = \
        pose_raster.launches
    s8_by_path["[ddp] int8 model 12, world 1, batch 16"] = dict(
        sc.launches_by_route)
    # the calibration's encoder pass, then the batch's encoder and
    # generator: the stem on narrow_ci, to_rgb on narrow_co
    want_routes = _s8_routes(2 * S8_ENCODER_CONVS + S8_GENERATOR_CONVS, 1,
                             1)
    if sc.launches_by_route != want_routes:
        raise AssertionError(f"[ddp] int8 world 1: s8 launches "
                             f"{sc.launches_by_route}, expected "
                             f"{want_routes}")
    gap = (images16 - f32.transfer_step(b16)[0].cpu()).abs()
    del f32
    torch.cuda.empty_cache()

    common1 = dict(cfg=dict(batch_size=16, model_dir=cfg16.model_dir),
                   params=params1, batch=host16)
    common3 = dict(cls="Stage2AppApp", cfg=common1["cfg"], frozen=frozen,
                   params=params3, batches=host3, noise=noise,
                   g_updated=one3.g_updated, d_clipped=one3.d_clipped)
    # rank 0 returns the records, rank 1 their digest (the disk's writes)
    errors_only = dict(lean=True, returns=("metrics", "arrays", "grads",
                                           "d_stats"))
    jobs = [("stage1", {**common1, "g_updated": one.g_updated,
                        "timed_steps": DDP_TIMED_STEPS, "local_grads": True,
                        "lean": True, "returns": (*errors_only["returns"],
                                                  "ms", "local_grads")}),
            ("stage1", {**common1, "g_updated": one64.g_updated,
                        "float64": True, "stem64": True, "outputs64": True,
                        "lean": True}),
            ("stage1", {**common1, "g_updated": one64.g_updated,
                        "float64": True, "stem64": True, "outputs64": True,
                        "local_bn": True, **errors_only}),
            *[("stage1", {**common1, "g_updated": rec.g_updated,
                          "float64": True, "stem64": "sum" not in label,
                          **errors_only})
              for label, rec in parts32.items()],
            ("stage2", {**common3, "timed_steps": DDP_TIMED_STEPS}),
            ("stage2", {**common3, "control": True}),
            ("int8_transfer", dict(cfg=int8_cfg, params=state12,
                                   batch=host16)),
            ("collectives", {"timed_numel": sum(
                v.numel() for k in ("Encoder", "ID_AE")
                for v in params1[k].values())})]
    t0 = time.perf_counter()
    outs = ranks.run_many(jobs, n=2, platform="", backend="gloo",
                          timeout=DDP_RANKS_TIMEOUT)
    wall = time.perf_counter() - t0
    print(f"[ddp] two ranks on one card (gloo over CUDA tensors, "
          f"asked for by argument): {len(jobs)} jobs in one group, "
          f"{wall:.1f} s with the processes' start-up", flush=True)

    def show(text, e):
        print(f"[ddp] {text}: " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in e.items()), flush=True)

    def over(e, tol):
        return [k for k, t in tol.items() if e.get(k, 0.0) > t]

    failures = []
    w32, w64, w64_local, *w64_parts32 = outs[:3 + len(parts32)]
    s3, s3_control, int8, probe = outs[3 + len(parts32):]
    for name, out in (("model 1", w32), ("model 1 float64", w64),
                      ("model 3 (fresh)", s3)):
        if out[0]["metrics"] != out[1]["metrics"]:
            failures.append(f"{name}: the ranks' metrics differ")
    lean = {"model 1 float32": w32, "model 1 float64": w64,
            **{f"model 1 float64 but {k}": o
               for k, o in zip(parts32, w64_parts32)}}
    for name, out in lean.items():  # then rank 0 stands for both
        same = out[0]["digest"] == out[1]["digest"]
        print(f"[ddp] {name}: rank 1's record (gradients, statistics, "
              f"updated params) bit-equal to rank 0's: {same}", flush=True)
        if not same:
            failures.append(f"{name}: the ranks' records differ")
    # model 1 in float64: the step's arithmetic, against world 1's in
    # float64; the fault the check must see: each rank's own BN statistics
    for r, o in enumerate(w64[:1]):
        e = step_errors(one64, ranks.as_record(o))
        show(f"model 1 float64, rank {r} of 2 (batch 8) against world 1 "
             f"(batch 16)", e)
        updates = [(o["g_updated"], one64.g_updated, "G"),
                   (o["d_params"], one64_d, "D")]
        moved = {what: float(torch.cat([(got[k] - v).abs().reshape(-1)
                                        for k, v in want.items()]).max())
                 for got, want, what in updates}
        print(f"[ddp] model 1 float64, rank {r}: updated params max|diff| "
              f"{moved} (limit {DDP_FLOAT64_UPDATE_TOL})", flush=True)
        if over(e, DDP_FLOAT64_TOL) or max(
                moved.values()) > DDP_FLOAT64_UPDATE_TOL:
            failures.append(f"model 1 float64 rank {r}: "
                            f"{over(e, DDP_FLOAT64_TOL)} {moved}")
    for r, o in enumerate(w64_local[:1]):
        e = step_errors(one64, ranks.as_record(o))
        show(f"control: model 1 float64, rank {r}, the D normalized by the "
             f"rank's own batch statistics (the ranks' running statistics "
             f"differ)", e)
        if not over(e, DDP_FLOAT64_TOL):
            failures.append(f"model 1 rank {r}: per-rank BatchNorm passes "
                            "every limit")
    # the same with float32 parts: the stem's sum (a cuBLAS product over
    # the batch's rows: 8 rows may round otherwise than 16) and the nets'
    # outputs, from which the losses are computed
    for (label, ref), out in zip(parts32.items(), w64_parts32):
        for r, o in enumerate(out[:1]):
            e = step_errors(ref, ranks.as_record(o))
            show(f"model 1 float64 but {label}, rank {r} of 2 against "
                 f"world 1 the same", e)
            if over(e, TRAIN_PARITY_TOL):
                failures.append(f"model 1 float64 but {label}, rank {r}: "
                                f"{over(e, TRAIN_PARITY_TOL)}")
    # model 1 in float32: the all-reduce exact, and world 2 no further from
    # the float64 step than world 1 is (cuDNN's float32 algorithms differ
    # by batch size and the first ROI-tower stage amplifies their rounding)
    gap1 = step_errors(one64, one)
    show("model 1 float32, world 1 (batch 16) against world 1 in float64",
         gap1)
    for r, o in enumerate(w32[:1]):
        local = [x["local_grads"] for x in w32]
        exact = all(torch.equal(o["grads"][k], (local[0][k] + local[1][k])
                                / 2) for k in o["grads"])
        e64 = step_errors(one64, ranks.as_record(o))
        show(f"model 1 float32, rank {r} of 2 against world 1 in float64",
             e64)
        show(f"model 1 float32, rank {r} of 2 against world 1 in float32",
             step_errors(one, ranks.as_record(o)))
        print(f"[ddp] model 1 float32, rank {r}: the averaged gradients equal "
              f"the mean of the ranks' own, bit for bit: {exact}", flush=True)
        worse = [k for k in ("g_step_losses", "Encoder", "ID_AE")
                 if e64[k] > max(2 * gap1[k], TRAIN_PARITY_TOL[k])]
        if worse or not exact:
            failures.append(f"model 1 float32 rank {r}: {worse}, exact "
                            f"all-reduce {exact}")
    # model 3 in float32, with the TF32 control of phase 11
    tol3 = {k: STAGE2_PARITY_TOL for k in step_errors(one3, one3)}
    for label, out in (("float32", s3),
                       ("control: TF32 past the guard", s3_control)):
        for r, o in enumerate(out):
            e = step_errors(one3, ranks.as_record(o))
            show(f"model 3 (fresh), rank {r} of 2 (batch 8) against world 1 "
                 f"(batch 16), {label}", e)
            if label == "float32" and over(e, tol3):
                failures.append(f"model 3 rank {r}: {over(e, tol3)}")
            if label != "float32" and not over(e, tol3):
                failures.append(f"model 3 rank {r}: a TF32 step passes "
                                "every limit")
    for name, ms1, out in (("model 1", one_ms, w32), ("model 3 (fresh)",
                                                      one3_ms, s3)):
        two_ms = [statistics.median(o["ms"]) for o in out]
        print(f"[ddp] {name} float32: ms per step, world 1 on 16 rows "
              f"{[round(x, 2) for x in ms1]}; two ranks on 8 rows each, "
              f"sharing the card "
              f"{[[round(x, 2) for x in o['ms']] for o in out]} (the slower "
              f"rank's median {max(two_ms):.2f}, "
              f"{max(two_ms) / statistics.median(ms1):.2f}x world 1)",
              flush=True)
    for r, o in enumerate(w32):  # model 3's step renders no pose map
        pose_by_path[f"[ddp] model 1 step, rank {r} of 2"] = \
            o["pose_launches"]
    if not all(o["pose_launches"] for o in w32):
        failures.append("model 1 on the ranks launched no pose kernel")

    for r, o in enumerate(int8):
        rows = images16[8 * r:8 * r + 8]
        diff = (o["images"] - rows).abs()
        print(f"[ddp] int8 model 12, rank {r} of 2 (8 rows, rank 0's "
              f"tables) against world 1's rows: max|diff| "
              f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}, "
              f"{int((diff > 0).sum())} of {diff.numel()} values differ; "
              f"limit: world 1's int8-vs-float32 gap, max "
              f"{float(gap.max()):.3e}, mean {float(gap.mean()):.3e}; "
              f"{o['ms'][0]:.1f} ms; s8 launches {o['s8_launches']}, pose "
              f"launches {o['pose_launches']}", flush=True)
        if float(diff.max()) > float(gap.max()) or \
                float(diff.mean()) > float(gap.mean()):
            failures.append(f"int8 rank {r} beyond the int8 gap")
        if o["s8_launches"] != want_routes or not o["pose_launches"]:
            failures.append(f"int8 rank {r}: s8 launches "
                            f"{o['s8_launches']}, expected {want_routes}, "
                            f"pose launches {o['pose_launches']}")
        pose_by_path[f"[ddp] int8 model 12, rank {r} of 2"] = \
            o["pose_launches"]
        s8_by_path[f"[ddp] int8 model 12, rank {r} of 2"] = o["s8_launches"]
    print(f"[ddp] one gloo all-reduce of the G gradients' "
          f"{jobs[-1][1]['timed_numel']} float32 values "
          f"({4 * jobs[-1][1]['timed_numel'] / 1e6:.1f} MB) between the two "
          f"ranks on the card: ms "
          f"{[round(x, 2) for x in probe[0]['all_reduce_ms']]}", flush=True)
    for r, o in enumerate(probe):
        print(f"[ddp] gloo collectives on CUDA tensors, each called "
              f"directly, rank {r}: {o['collectives']} (the ones "
              f"dpig_tpu_torch/parallel/dist.py hands the device's "
              f"tensors to)", flush=True)
        if any(v != "ok" for v in o["collectives"].values()):
            failures.append("gloo refuses or gets wrong a collective the "
                            "port hands it CUDA tensors for")
    if failures:
        raise AssertionError("[ddp] " + "; ".join(failures))

    b8 = {k: v[:8] for k, v in b16.items()}
    entries, n_calls = _s8_table(t8, b8, "[ddp s8 conv]",
                                 "one int8 model-12 batch of 8 (a rank's "
                                 "rows)", reps=10, inner=10)
    if n_calls != S8_ENCODER_CONVS + S8_GENERATOR_CONVS:
        raise AssertionError(f"[ddp] {n_calls} s8 launches at batch 8")
    return pose_by_path, s8_by_path, entries


# ------------------------------------------------ scoring and the int8 gate
# Card vs CPU limit on every value `eval/score.py` reports: both sides
# score in float64, the card's window sums and means in other orders.
SCORE_TOL = 1e-9
# The gate at full width: Market train steps (bs64, bfloat16, fast D
# step) and its pool, the 256 ones (bs16); check/sweep/gate score
# QUALITY_BATCHES - 1 held-out batches after the calibration one; the
# sweep (six schemes) scores SWEEP_BATCHES - 1 (cut from 3 for time).
QUALITY_STEPS, QUALITY_POOL = 10, 8
QUALITY_256_STEPS, QUALITY_256_POOL = 4, 4
QUALITY_BATCHES, SWEEP_BATCHES = 4, 2
GATE_KEYS = ("ssim_int8_float", "ssim_to_target_float",
             "ssim_to_target_int8", "delta")


def phase_score(model_dir):
    """`python -m dpig_tpu_torch.eval.score 1 <model_dir> test_result`
    (and `--mask`) on phase 4's model-12 tree at full Market width, on the
    card; the same on the CPU: every value within SCORE_TOL and the
    score.txt / score_mask.txt texts equal; images scored per second."""
    from dpig_tpu_torch.eval import score
    root = os.path.join(model_dir, "test_result")
    for masked in (False, True):
        flags = ["--mask"] if masked else []
        name = "score_mask.txt" if masked else "score.txt"
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            score.main(["1", model_dir, "test_result", *flags])
        wall = time.perf_counter() - t0
        with open(os.path.join(root, name)) as f:
            card_txt = f.read()
        if out.getvalue().splitlines()[0] != score.IS_SKIPPED:
            raise AssertionError("[score] no IS-skipped line")
        with contextlib.redirect_stdout(io.StringIO()):
            card = score.score_stage1(model_dir, "test_result", masked)
            cpu = score.score_stage1(model_dir, "test_result", masked,
                                     platform="cpu")
        with open(os.path.join(root, name)) as f:
            cpu_txt = f.read()
        g, _ = score._load_dir(os.path.join(root, "G"))
        x, _ = score._load_dir(os.path.join(root, "x_target"))
        m = score._load_dir(os.path.join(root, "mask"))[0] if masked \
            else None
        rates = {}
        for dev in ("cuda", "cpu"):
            score.per_image(g, x, m, torch.device(dev))  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            score.per_image(g, x, m, torch.device(dev))
            torch.cuda.synchronize()
            rates[dev] = len(g) / (time.perf_counter() - t0)
        err = max(abs(card[k] - cpu[k]) for k in card)
        print(f"[score] stage 1{' --mask' if masked else ''} on the model-12 "
              f"tree ({len(g)} pairs at 128x64): {card_txt.strip()!r}; card "
              f"vs CPU max|diff| {err:.3e} (limit {SCORE_TOL}), texts equal "
              f"{card_txt == cpu_txt}; the CLI on the card {wall:.2f} s "
              f"wall (PIL reads included); scoring alone {rates['cuda']:.0f} "
              f"images/s on the card, {rates['cpu']:.0f} on the CPU",
              flush=True)
        if not err <= SCORE_TOL or card_txt != cpu_txt:
            raise AssertionError("[score] card and CPU disagree")


def _gate_launches(kind, steps=0):
    """(s8 launches, of them the stem's on narrow_ci and to_rgb's on
    narrow_co, pose launches) one gate path must make, with
    QUALITY_BATCHES held-out batches (SWEEP_BATCHES for the sweep): the
    first calibrates (the float stats forward: no s8), each other one
    renders its pose and runs the int8 generator (G convs: one stem, one to_rgb); --transfer adds the
    int8 encoder (E convs, all wgmma) on every batch; --per_layer runs the
    legacy graph (no s8 stem: G - 1 convs, one to_rgb) twice whole and
    once without each of the other G - 1 table layers (to_rgb among them);
    the sweep runs 4 schemes whole and two tail fallbacks that leave 3
    layers out (to_rgb among them), the legacy one running the rest
    without the stem."""
    g, e, n = S8_GENERATOR_CONVS, S8_ENCODER_CONVS, QUALITY_BATCHES - 1
    legacy = g - 1
    if kind == "sweep":
        n = SWEEP_BATCHES - 1
    return {"train": (0, 0, 0, steps),
            "check": (n * g, n, n, n + 1),
            "check --transfer": (e + n * (e + g), n, n, n + 1),
            "check --per_layer": (n * g + 2 * legacy + (g - 1) * (legacy - 1),
                                  n, n + 2 + (g - 2), n + 2),
            "sweep": (4 * n * g + n * (legacy - 3) + n * (g - 3),
                      4 * n + n, 4 * n, 6 * (n + 1)),
            "gate": (n * g, n, n, n + 1)}[kind]


def phase_quality(tmp, df_entries):
    """The int8 gate (`python -m dpig_tpu_torch.eval.int8_quality`) at full
    width: Market train / check / --transfer / --per_layer / sweep / gate,
    then --size=256 train / check / sweep / gate, each path's launches;
    the s8 conv on every call of one gate batch at both sizes bit-equal,
    the Market batch's timed, the 256 batch's held to the shapes of
    `df_entries` ([df256 s8]'s, timed there); card vs CPU check at batch
    2 -> (pose launches by path, s8 launches by path, the s8 entries of
    the Market batch)."""
    from dpig_tpu_torch.apps.stage1_app import Stage1App
    from dpig_tpu_torch.eval import int8_quality as pq

    step, times = Stage1App.train_step, []

    def timed_step(self, *args, **kw):
        t0 = time.perf_counter()
        out = step(self, *args, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    pose_by_path, s8_by_path, results = {}, {}, {}
    sizes = {"Market": ([], os.path.join(tmp, "gate"), QUALITY_STEPS,
                        QUALITY_POOL, 64),
             "256": (["--size=256"], os.path.join(tmp, "gate256"),
                     QUALITY_256_STEPS, QUALITY_256_POOL, 16)}
    for size, (flags, mdir, steps, pool, bs) in sizes.items():
        overrides = dict(pq.DF256) if flags else {}
        runs = {"train": lambda: pq.main(["train", str(steps), mdir,
                                          f"--pool={pool}", *flags]),
                "check": lambda: pq.main(["check", mdir, *flags])}
        if not flags:
            runs["check --transfer"] = lambda: pq.main(
                ["check", mdir, "--transfer"])
            runs["check --per_layer"] = lambda: pq.main(
                ["check", mdir, "--per_layer"])
        runs["sweep"] = lambda: pq.sweep(mdir, SWEEP_BATCHES,
                                         cfg_overrides=overrides)
        runs["gate"] = lambda: pq.main(["gate", mdir, *flags])
        for kind, run in runs.items():
            times.clear()
            Stage1App.train_step = timed_step
            try:
                result, pose, s8, wall, text = _counted(run)
            finally:
                Stage1App.train_step = step
            path = f"[quality] {size} {kind}"
            want_s8, want_ci, want_co, want_pose = _gate_launches(kind,
                                                                  steps)
            got = (sum(s8.values()), s8["narrow_ci"], s8["narrow_co"],
                   s8["mma_sync"], pose)
            print(f"{path}: {wall:.1f} s wall; s8 conv launches {s8} "
                  f"(expected {want_s8}, {want_ci} on narrow_ci, {want_co} "
                  f"on narrow_co, 0 on mma_sync), pose kernel launches "
                  f"{pose} (expected {want_pose})", flush=True)
            if got != (want_s8, want_ci, want_co, 0, want_pose):
                raise AssertionError(f"{path}: launches {got}")
            pose_by_path[path], s8_by_path[path] = pose, s8
            if kind == "train":
                ms = statistics.median(times[1:]) * 1e3
                print(f"{path}: {steps} steps of {bs}, "
                      f"{ms:.2f} ms per step after the first (median; first "
                      f"{times[0] * 1e3:.1f}), {bs / ms * 1e3:.1f} images/s",
                      flush=True)
            elif kind == "sweep":
                if tuple(result) != ("absmax", "percentile 99.9",
                                     "per-channel (default)",
                                     "tail-fallback (legacy)",
                                     "tail-fallback (island)", "entropy"):
                    raise AssertionError(f"{path}: rows {list(result)}")
                results[size, kind] = result
            elif kind == "gate":
                verdict = "[PASS]" in text
                if verdict != (result == 0) or ("[FAIL]" in text) == verdict:
                    raise AssertionError(f"{path}: exit code {result}, "
                                         f"verdict line {verdict}")
                results[size, kind] = verdict
        print(f"[quality] {size} gate verdict on {steps}-step weights: "
              f"{'PASS' if results[size, 'gate'] else 'FAIL'}", flush=True)

    # every s8 shape of one gate batch: Market bs64 with --transfer (the
    # first E calls are the calibration batch's encoder pass), bit-equal
    # and timed
    mdir = sizes["Market"][1]
    with contextlib.redirect_stdout(io.StringIO()):
        calls = _record_s8_calls(lambda: pq.check(mdir, n_batches=2,
                                                  transfer=True))
    entries, n_calls = _s8_calls_table(
        calls[S8_ENCODER_CONVS:], "[quality s8] Market",
        "one int8 gate batch of 64 (--transfer: encoder and generator)",
        reps=5, inner=3)
    del calls
    if n_calls != S8_GENERATOR_CONVS + S8_ENCODER_CONVS:
        raise AssertionError(f"[quality s8] Market: {n_calls} calls")
    # 256 at bs16: the calls of phase 16's model-1001 batch, shape for
    # shape (timed there); each checked bit-equal here on both routes
    with contextlib.redirect_stdout(io.StringIO()):
        calls = _record_s8_calls(lambda: pq.check(
            sizes["256"][1], n_batches=2, cfg_overrides=dict(pq.DF256)))
    keys = collections.Counter(_s8_key(c) for c in calls)
    df_keys = {(tuple(r["x"]), tuple(r["w"]), r["stride"], r["out"],
                r["res"]): r["launches_per_batch"]
               for e in df_entries.values() for r in e["shapes"]}
    differ = [_s8_differing(c)[0] for c in calls]
    worst = max(n for d in differ for n in d.values())
    print(f"[quality s8] 256 one int8 gate batch of 16: {len(calls)} calls "
          f"on {len(keys)} shapes, the shapes and counts of [df256 s8]'s "
          f"model-1001 batch {dict(keys) == df_keys}; elements differing "
          f"from the plain version on both routes {worst}", flush=True)
    del calls
    if dict(keys) != df_keys or worst:
        raise AssertionError("[quality s8] 256: calls differ from "
                             "[df256 s8]'s or from the plain version")

    small = {"batch_size": 2}
    with contextlib.redirect_stdout(io.StringIO()):
        card, pose, s8, _, _ = _counted(lambda: pq.check(
            mdir, n_batches=2, cfg_overrides=small))
        cpu = pq.check(mdir, n_batches=2,
                       cfg_overrides=dict(small, platform="cpu"))
    path = "[quality] Market check, batch 2"
    pose_by_path[path], s8_by_path[path] = pose, s8
    # half the gap: a card path that quietly ran float would read
    # SSIM(int8, float) = 1, one whole gap off
    limit = (1.0 - cpu["ssim_int8_float"]) / 2
    diff = {k: abs(card[k] - cpu[k]) for k in GATE_KEYS}
    print(f"[quality] card vs CPU check, batch 2 at full Market width, "
          f"n_batches 2, same checkpoint: card "
          f"{ {k: round(card[k], 6) for k in GATE_KEYS} }, CPU "
          f"{ {k: round(cpu[k], 6) for k in GATE_KEYS} }, |diff| "
          f"{ {k: f'{v:.2e}' for k, v in diff.items()} }; limit half the "
          f"CPU's int8-vs-float SSIM gap {limit:.4e}; launches s8 {s8}, "
          f"pose {pose}", flush=True)
    if not 0.0 < limit or max(diff.values()) > limit or pose != 2 or \
            sum(s8.values()) != S8_GENERATOR_CONVS:
        raise AssertionError("[quality] card and CPU checks disagree")
    return pose_by_path, s8_by_path, entries


# ------------------------------------------------ converters, demo, A/B
CONVERT_IDS, CONVERT_CAMS, CONVERT_PER_CAM = 8, 2, 6
CONVERT_DF_IDS, CONVERT_DF_PER_ID = 3, 4
CONVERT_MAX_PAIRS = 48        # Market train (x2 with the flip) and test
CONVERT_RCV_PAIRS = 24
CONVERT_STEPS, CONVERT_TEST_BATCHES = 3, 2
PIPELINE_SCALE = 0.05         # steps_scale of apps/pipeline_demo.py
CRITIC_AB_STEPS, CRITIC_AB_BATCH = 30, 16
CRITIC_AB_PARITY_STEPS, CRITIC_AB_PARITY_BATCH = 3, 4


def _openpose_set(root, rng, names, h, w, df=False):
    """JPEGs of noise and OpenPose pickles for `names`, as
    tests/test_convert.py:70-95 writes them (one subset per image, its
    ids 0..17, score 1): with two keypoints missing in every third image,
    and one image without peaks. -> (img_dir, pose_dir)."""
    img_dir, pose_dir = os.path.join(root, "imgs"), os.path.join(root,
                                                                  "pose")
    os.makedirs(img_dir)
    os.makedirs(pose_dir)
    from PIL import Image
    all_peaks, subsets = {}, {}
    for i, n in enumerate(names):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(os.path.join(img_dir, n))
        if i == 1:
            continue
        all_peaks[n] = [[] if (i % 3 == 0 and k in (9, 10)) else
                        [(float(rng.integers(2, w - 2)),
                          float(rng.integers(2, h - 2)), 0.9, k)]
                        for k in range(18)]
        s = np.zeros((1, 20))
        s[0, :18] = np.arange(18)
        s[0, -2] = 1.0
        subsets[n] = s
    tag = "_DeepFashion" if df else ""
    for stem, obj in (("all_peaks_dic", all_peaks), ("subsets_dic", subsets)):
        with open(os.path.join(pose_dir, f"{stem}{tag}.p"), "wb") as f:
            pickle.dump(obj, f, protocol=2)
    return img_dir, pose_dir


def _records_agree(dataset_dir, h, w, keys) -> tuple:
    """Every record of every shard: the native scanner (CRCs verified in
    C++) equal to the plain reader, tfr_parse bit-equal to the plain
    decoder. The plain reader's Python CRC is left to `[data]`: over the
    256x256 records it took ~28 s of this phase's ~54."""
    from dpig_tpu_torch.data import loader as dl
    from dpig_tpu_torch.data import tfrecord
    n, failures = 0, []
    for path in tfrecord.list_shards(dataset_dir, ""):
        records = list(tfrecord.read_records(path, verify_crc=True))
        if records != list(tfrecord.read_records(path, native_scan=False)):
            failures.append(f"native and plain readers differ on {path}")
        for rec in records:
            if not _same_batches(
                    [dl.parse_example(rec, h, w, parser="native", **keys)],
                    [dl.parse_example(rec, h, w, parser="plain", **keys)]):
                failures.append(f"{path} record {n}: tfr_parse and the "
                                "plain decoder differ")
            n += 1
    return n, failures


def phase_convert(tmp):
    """Phase 24: the dataset converters (`python -m
    dpig_tpu_torch.data.convert.run`) on this host at full width: Market
    128x64 (train with its flip shard, test), DeepFashion 256x256 (its
    region masks) and the rcv converter on a MaskRCNN-remapped pickle;
    every record read and parsed natively and plainly alike; the test
    split's batches equal in every worker mode; then models 1 and 12
    through the CLI on the Market records and one model-101 step on the
    DeepFashion ones -> pose launches by path."""
    from dpig_tpu_torch.config import Config
    from dpig_tpu_torch.data import loader as dl
    from dpig_tpu_torch.data import pose_tools as pt
    from dpig_tpu_torch.data.convert import run as convert

    rng = np.random.default_rng(15)
    root = os.path.join(tmp, "convert")
    data_dir = os.path.join(root, "data")
    names = [f"{pid:04d}_c{cam}s1_{pid * 100 + cam * 10 + j:06d}_00.jpg"
             for pid in range(1, CONVERT_IDS + 1)
             for cam in range(1, CONVERT_CAMS + 1)
             for j in range(CONVERT_PER_CAM)]
    market = _openpose_set(os.path.join(root, "market"), rng, names,
                           MARKET["h"], MARKET["w"])
    df_names = [f"id{pid:08d}_{j:02d}_{j % 4 + 1}_front.jpg"
                for pid in range(CONVERT_DF_IDS)
                for j in range(CONVERT_DF_PER_ID)]
    df = _openpose_set(os.path.join(root, "df"), rng, df_names, 256, 256,
                       df=True)
    rcv_pkl = os.path.join(root, "rcv.p")
    rcv = {}
    for n in names:
        crs = np.stack([rng.integers(2, MARKET["w"] - 2, 17),
                        rng.integers(2, MARKET["h"] - 2, 17)]).astype(float)
        crs[:, rng.choice(17, 2, replace=False)] = 0  # undetected joints
        rcv[n] = pt.maskrcnn_to_openpose_rcv(crs)
    with open(rcv_pkl, "wb") as f:
        pickle.dump(rcv, f, protocol=2)

    runs = {"market train": ("market", *market, "Market1501",
                             dict(split="train", max_pairs=CONVERT_MAX_PAIRS)),
            "market test": ("market", *market, "Market1501",
                            dict(split="test", max_pairs=CONVERT_MAX_PAIRS)),
            "df train": ("df", *df, "DF", dict(split="train")),
            "rcv train": ("rcv", market[0], rcv_pkl, "RCV",
                          dict(split="train", flip_augment=False,
                               max_pairs=CONVERT_RCV_PAIRS))}
    written = {}
    for label, (kind, img_dir, pose, out, kw) in runs.items():
        t0 = time.perf_counter()
        n = convert.run(kind, img_dir, pose, os.path.join(data_dir, out),
                        **kw)
        sec = time.perf_counter() - t0
        written[label] = n
        print(f"[convert] {label}: {n} records (flip shard included for "
              f"train) in {sec:.2f} s, {sec * 1e3 / n:.2f} host ms per "
              f"converted pair", flush=True)
    sizes = {"Market1501": (MARKET["h"], MARKET["w"], dl.MARKET_KEYS),
             "DF": (256, 256, dl.DF_KEYS),
             "RCV": (MARKET["h"], MARKET["w"], dl.MARKET_KEYS)}
    failures, n_records = [], 0
    for out, (h, w, keys) in sizes.items():
        n, bad = _records_agree(os.path.join(data_dir, out), h, w, keys)
        n_records += n
        failures += bad
    if n_records != sum(written.values()):
        failures.append(f"{n_records} records read, "
                        f"{sum(written.values())} written")
    print(f"[convert] {n_records} records: CRCs verified by the native "
          f"scanner, the records equal to the plain reader's, tfr_parse bit-equal to the "
          f"plain decoder on every key: {not failures}", flush=True)

    ds = os.path.join(data_dir, "Market1501")

    def test_split(workers, mode):
        return dl.TFRecordPairLoader(ds, "test", 16, MARKET["h"],
                                     MARKET["w"], dataset="Market1501",
                                     shuffle=False, num_workers=workers,
                                     worker_mode=mode)

    ref = _drain(test_split(0, "thread"))
    same = {f"{n} {m}": _same_batches(_drain(test_split(n, m)), ref)
            for n, m in ((LOADER_WORKERS, "thread"), (2, "process"))}
    print(f"[convert] Market test split: {len(ref)} batches of 16, "
          f"identical in order with 0 workers and {same}", flush=True)
    if len(ref) != written["market test"] // 16 or not all(same.values()):
        failures.append(f"test split batches {len(ref)}, {same}")

    common = [f"--data_dir={data_dir}", f"--num_worker={LOADER_WORKERS}"]
    cli = {"model 1 on converted records": (
               ["--model=1", "--dataset=Market1501",
                f"--max_step={CONVERT_STEPS}", "--log_step=1"],
               _expected_train_launches(Config(max_step=CONVERT_STEPS,
                                               log_step=1))),
           "model 12 on converted records": (
               ["--model=12", "--is_train=false", "--dataset=Market1501",
                f"--test_batch_num={CONVERT_TEST_BATCHES}"],
               2 * CONVERT_TEST_BATCHES),
           "model 101 on converted DeepFashion records": (
               ["--model=101", "--dataset=DF", "--img_H=256", "--img_W=256",
                f"--batch_size={DF_TRAIN_BATCH}", "--max_step=1",
                "--log_step=1"],
               _expected_train_launches(Config(max_step=1, log_step=1)))}
    launches = {}
    for i, (path, (argv, want)) in enumerate(cli.items()):
        got, wall = _run_cli([*argv, *common,
                              f"--model_dir={root}/cli{i}"])
        launches[path] = got
        print(f"[convert] {path} (CLI, {' '.join(argv)}): wall {wall:.1f} "
              f"s, pose kernel launches {got} (expected {want})",
              flush=True)
        if got != want:
            failures.append(f"{path}: {got} pose launches, expected {want}")
    if failures:
        raise AssertionError("[convert] " + "; ".join(failures))
    return launches


def phase_pipeline(tmp):
    """Phase 25: `python -m dpig_tpu_torch.apps.pipeline_demo` on the card
    at steps_scale PIPELINE_SCALE: stick people drawn, converted, models
    1 -> 2 -> 3 -> 4 trained, testers 12 / 11 / 13, scored; results.json
    printed, the Stage-I L1 must fall; wall ms per step of each stage and
    pose launches of each stage and tester -> launches by path."""
    from dpig_tpu_torch.apps import pipeline_demo, testers
    from dpig_tpu_torch.kernels import pose_raster
    from dpig_tpu_torch.train.harness import Trainer

    record = {}

    def counted(fn, path_of):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            pose_raster.launches = 0
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kw)
            finally:
                torch.cuda.synchronize()
                record[path_of(self)] = (pose_raster.launches,
                                         time.perf_counter() - t0,
                                         self.cfg.max_step)
        return run

    patched = [(Trainer, "train", lambda t: f"pipeline model {t.cfg.model}")]
    patched += [(cls, "run", lambda t: f"pipeline tester {t.cfg.model}")
                for cls in (testers.ConditionalTransferTester,
                            testers.FullSamplingTester,
                            testers.FactorSamplingTester)]
    originals = [(cls, name, getattr(cls, name)) for cls, name, _ in patched]
    for cls, name, path_of in patched:
        setattr(cls, name, counted(getattr(cls, name), path_of))
    root = os.path.join(tmp, "pipeline")
    t0 = time.perf_counter()
    try:
        results = pipeline_demo.main([root, str(PIPELINE_SCALE)])
    finally:
        for cls, name, fn in originals:
            setattr(cls, name, fn)
    wall = time.perf_counter() - t0
    with open(os.path.join(root, "results.json")) as f:
        print(f"[pipeline] results.json: {json.dumps(json.load(f))}",
              flush=True)
    for path, (n, sec, steps) in record.items():
        per = (f", {sec * 1e3 / steps:.2f} wall ms per step (the fixed "
               f"previews and the final checkpoint included)"
               if "model" in path else "")
        print(f"[pipeline] {path}: {sec:.2f} s{per}, {steps or '-'} steps, "
              f"pose kernel launches {n}", flush=True)
    print(f"[pipeline] steps_scale {PIPELINE_SCALE}: the whole demo in "
          f"{wall:.1f} s; Stage-I L1 {results['stage1_first_L1']:.4f} -> "
          f"{results['stage1_final_L1']:.4f}, transfer SSIM "
          f"{results['ssim_G_x_mean']:.4f}", flush=True)
    launches = {p: n for p, (n, _, _) in record.items()}
    if len(record) != 7 or not all(launches.values()):
        raise AssertionError(f"[pipeline] pose launches by path {launches}")
    if not all(math.isfinite(v) for v in results.values()) or not (
            results["stage1_final_L1"] < results["stage1_first_L1"]):
        raise AssertionError(f"[pipeline] results {results}")
    return launches


def phase_critic_ab():
    """Phase 26: `python -m dpig_tpu_torch.apps.critic_batch_ab` on the
    card, CRITIC_AB_STEPS steps of batch CRITIC_AB_BATCH in each mode (the
    W tails and moment gaps printed), then 3 steps of batch 4 in each mode
    on the card and on the CPU from the same seed: each W tail within
    STAGE2_PARITY_TOL absolute, each moment gap within it relative ->
    pose launches (the A/B renders no pose map)."""
    from dpig_tpu_torch.apps import critic_batch_ab as ab
    from dpig_tpu_torch.kernels import pose_raster

    pose_raster.launches = 0
    t0 = time.perf_counter()
    res = ab.main([str(CRITIC_AB_STEPS), str(CRITIC_AB_BATCH), "0"])
    torch.cuda.synchronize()
    launches = pose_raster.launches
    print(f"[critic ab] {CRITIC_AB_STEPS} steps of batch {CRITIC_AB_BATCH} "
          f"a mode on the card in {time.perf_counter() - t0:.1f} s: " +
          "; ".join(f"{m} " + ", ".join(f"{k} {v:.5f}" for k, v in r.items())
                    for m, r in res.items()) +
          f"; pose kernel launches {launches}", flush=True)
    diffs = {}
    for mode in ("reused", "fresh"):
        card = ab.run(mode, CRITIC_AB_PARITY_STEPS, CRITIC_AB_PARITY_BATCH)
        cpu = ab.run(mode, CRITIC_AB_PARITY_STEPS, CRITIC_AB_PARITY_BATCH,
                     platform="cpu")
        diffs[mode] = {k: abs(card[k] - v) / (1.0 if k.startswith("W_")
                                              else abs(v))
                       for k, v in cpu.items()}
    print(f"[critic ab] card vs CPU, {CRITIC_AB_PARITY_STEPS} steps of "
          f"batch {CRITIC_AB_PARITY_BATCH}, same seed (W tails: abs diff; "
          f"gaps: relative): " + "; ".join(
              f"{m} " + ", ".join(f"{k} {v:.2e}" for k, v in d.items())
              for m, d in diffs.items()) +
          f"; tolerance {STAGE2_PARITY_TOL}", flush=True)
    if any(v > STAGE2_PARITY_TOL for d in diffs.values() for v in d.values()):
        raise AssertionError("[critic ab] card and CPU disagree")
    if any(not math.isfinite(v) for r in res.values() for v in r.values()):
        raise AssertionError(f"[critic ab] {res}")
    return {"critic A/B (both modes)": launches}


# ---------------------------------------------------------- TF1 import
TF1_BATCHES = 2
TF1_SERVE = {  # CLI flags -> the sub-trees the tester takes from them
    "model 12": (["--model=12"], ("Encoder", "ID_AE")),
    "model 11": (["--model=11", "--sample_app=true",
                  "--pose_source=sampled"],
                 ("Encoder", "ID_AE", "PoseAE", "PoseGaussian",
                  "Gaussian_FC_Fg", "Gaussian_FC_Bg"))}


def _tree_files(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def phase_tf1_import(tmp):
    """A TF1 checkpoint of every scope at full Market width (a seeded
    template of the testers' nets named as the reference names them:
    slim scopes in creation order, the D's tflib names with Output.W in
    NCHW rows and its BatchNorm moving statistics, plus optimizer slots
    the reader drops), written by `tf1_bundle.write_bundle`; `python -m
    dpig_tpu_torch.train.tf1_import` on it (no TensorFlow here): every
    imported tensor bit-equal to its source; models 12 and 11 through the
    CLI from the imported checkpoint with the --pretrained_* flags,
    TF1_BATCHES batches each, their PNG trees byte-equal to the same
    testers' run on the source weights given directly; pose launches;
    the bundle's bytes, write / read / import seconds and read rate ->
    pose launches by path."""
    from dpig_tpu_torch.apps import testers
    from dpig_tpu_torch.config import Config, get_config
    from dpig_tpu_torch.main import make_loader
    from dpig_tpu_torch.train import checkpoint as ckpt
    from dpig_tpu_torch.train import tf1_bundle, tf1_import

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    source = tf1_import.template_state(Config(
        model_dir=os.path.join(tmp, "tf1_src"), random_seed=11))
    var = tf1_import.reference_variables(source, 128, 64)
    var["ID_AE/G/Conv/weights/Adam"] = np.zeros(8, np.float32)
    var["Discriminator.1.Filters/RMSProp_1"] = np.zeros(8, np.float32)
    var["beta1_power"] = np.float32(0.9)
    t0 = time.perf_counter()
    prefix = tf1_bundle.write_bundle(
        os.path.join(tmp, "tf1", "model.ckpt-1000"), var)
    t_write = time.perf_counter() - t0
    out = os.path.join(tmp, "tf1_imported")
    sizes = tf1_import.main([f"--ckpt_path={prefix}", f"--model_dir={out}"])
    tree = ckpt.load_tree(out)
    unequal = [f"{sub}/{n}" for sub, tensors in source.items()
               for n, t in tensors.items()
               if not torch.equal((tree["g_params"].get(sub) or {
                   **tree["d_params"][sub], **tree["d_stats"][sub]})[n], t)]
    n_tensors = sum(len(t) for t in source.values())
    rate = sizes["bundle_bytes"] / sizes["read_s"] / 1e6
    print(f"[tf1 import] {card}: a {sizes['bundle_bytes']} byte bundle "
          f"({len(var)} variables, {n_tensors} port tensors in "
          f"{len(source)} sub-trees) written in {t_write:.3f} s, read in "
          f"{sizes['read_s']:.3f} s ({rate:.1f} MB/s, CRCs checked, warm "
          f"page cache), imported in {sizes['import_s']:.3f} s; tensors "
          f"unequal to their source: {unequal or 'none'}", flush=True)
    if unequal or tree["step"] != 0:
        raise AssertionError(f"[tf1 import] {unequal[:5]}")

    by_path, differ = {}, {}
    flags = ["--is_train=false", "--synthetic_data=true",
             f"--test_batch_num={TF1_BATCHES}"]
    pretrained = [f"--pretrained_{k}={out}" for k in (
        "path", "poseAE_path", "appSample_path", "poseSample_path")]
    for name, (argv, subs) in TF1_SERVE.items():
        cli_dir = os.path.join(tmp, f"tf1_{name[-2:]}_cli")
        launches, wall = _run_cli([*argv, *flags, *pretrained,
                                   f"--model_dir={cli_dir}"])
        direct_dir = os.path.join(tmp, f"tf1_{name[-2:]}_source")
        cfg = get_config([*argv, *flags, f"--model_dir={direct_dir}"])
        cls = (testers.ConditionalTransferTester if cfg.model == 12
               else testers.FullSamplingTester)
        tester = cls(cfg, params={k: source[k] for k in subs})
        with contextlib.closing(make_loader(cfg)) as loader:
            kw = {} if cfg.model == 12 else {"pose_source": "sampled"}
            tester.run(loader, **kw)
        del tester
        got, want = _tree_files(cli_dir), _tree_files(direct_dir)
        got.pop("params.json", None)
        differ[name] = sorted(k for k in set(got) | set(want)
                              if got.get(k) != want.get(k))
        per_batch = 2 if cfg.model == 12 else 3
        print(f"[tf1 import] {name} through the CLI from the imported "
              f"checkpoint, {TF1_BATCHES} batches of {cfg.batch_size}: "
              f"{wall:.1f} s wall; "
              f"{len(got)} files, differing from the source weights' run: "
              f"{differ[name] or 'none'}; pose kernel launches {launches} "
              f"(expected {per_batch * TF1_BATCHES})", flush=True)
        if differ[name] or not got or launches != per_batch * TF1_BATCHES:
            raise AssertionError(f"[tf1 import] {name}: {differ[name][:5]}, "
                                 f"{launches} launches")
        by_path[f"[tf1 import] {name} from the imported checkpoint"] = \
            launches
    return by_path


ZOO_BATCH = 16
# [zoo]'s card vs CPU check at batch 2, float32, TF32 off, on two errors:
# max |diff| of the outputs over their largest |value| (for a critic
# step, of its Wasserstein term and penalty, held at the gradients' floor:
# the penalty is a gradient's norm), and ||diff|| / ||grad|| over
# the gradients of sum(out * W) w.r.t. every parameter and input (for a
# critic step, of its loss w.r.t. the critic's parameters). Each is read
# against the CPU's float64 run of the same module, weights and inputs:
# the card's float32 must be within ZOO_PARITY_TOL of it, or at most
# ZOO_FLOAT32_FACTOR times as far as the CPU's float32. The floors are
# PARITY_TOL and TRAIN_PARITY_TOL's G-gradient limit; a wiring fault
# reads O(1e-1). Card against CPU float32 is printed, but is no limit:
# at batch 2 the deep nets' gradients are ill-conditioned in float32
# (this phase on an NVIDIA H100 80GB HBM3 at 700 W): from the CPU's
# float64 the ResnetGenerator's read 7.3e-3 on the CPU and 9.7e-3
# on the card, the ResnetDiscriminator's 1.0e-2 / 2.0e-3, the
# PlainDecoder's 1.3e-4 / 9.1e-4 (9.0e-4 with cuDNN off); the
# DCGANGenerator's 8.8e-7 / 1.4e-4, where cuDNN's float32 5x5 convs are
# the gap (5.6e-7 with cuDNN off).
ZOO_PARITY_TOL = {"out": 1e-4, "grad": 5e-3}
ZOO_FLOAT32_FACTOR = 4.0


def _zoo_modules():
    """(name, make, inputs(batch, gen), call) of every [zoo] module; the
    weights come from a seeded init with each 1-D parameter moved off it,
    so that a bias or a scale counts in the parity."""
    from dpig_tpu_torch.models import discriminators as disc
    from dpig_tpu_torch.models import encoders, generator, zoo

    def noise(dim):
        return lambda b, g: [torch.randn(b, dim, generator=g)]

    def images(h, w, c=3):
        return lambda b, g: [torch.rand(b, h, w, c, generator=g) * 2 - 1]

    attr = disc.DCGANDiscriminatorAttr(8, 4, 640, attr_num=27, dim=64,
                                       keep_prob=0.5)

    def attr_inputs(b, g):
        masks = [torch.rand(s, generator=g) < 0.5
                 for s in attr.keep_mask_shapes(b)]
        return [torch.randn(b, 8, 4, 640, generator=g), masks]

    plain = lambda m, *xs: m(*xs)  # noqa: E731
    return [
        ("ResnetGenerator", lambda: zoo.ResnetGenerator(
            128, 128, 64, dim=64, blocks_per_scale=6), noise(128), plain),
        ("ResnetDiscriminator", lambda: disc.ResnetDiscriminator(
            128, 64, dim=64, blocks_per_scale=6), images(128, 64), plain),
        ("MultiplicativeDCGANDiscriminator",
         lambda: disc.MultiplicativeDCGANDiscriminator(128, 64, dim=64),
         images(128, 64), plain),
        ("DCGANDiscriminatorAttr", lambda: attr, attr_inputs,
         lambda m, x, masks: m(x, keep_masks=masks)),
        ("DCGANGenerator", lambda: zoo.DCGANGenerator(128, 64, 64, dim=64),
         noise(128), plain),
        ("FCGenerator", lambda: zoo.FCGenerator(128, 128 * 64 * 3),
         noise(128), plain),
        ("PlainEncoder", lambda: encoders.PlainEncoder(
            128, 64, 3 + 18, z_num=64, repeat_num=5, hidden_num=128),
         lambda b, g: images(128, 64)(b, g) + images(128, 64, 18)(b, g),
         plain),
        ("PlainDecoder", lambda: generator.PlainDecoder(
            64, 128, 64, repeat_num=5, hidden_num=128), noise(64), plain),
        *[(f"{arch} wgan-gp", functools.partial(
            disc.get_discriminator, arch, 128, 64, mode="wgan-gp"),
           images(128, 64), plain)
          for arch in ("DCGAN", "DCGANRegion", "Patch")],
    ]


def _zoo_init(make, seed):
    from dpig_tpu_torch.models.layers import init_weights
    m = make()
    g = torch.Generator().manual_seed(seed)
    init_weights(m, g)
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 1:
                p.add_(torch.rand(p.shape, generator=g) * 0.4 - 0.2)
    return m


def _to(xs, dev):
    return [[t.to(dev) for t in x] if isinstance(x, list) else x.to(dev)
            for x in xs]


def _float_inputs(xs):
    return [x for x in xs if torch.is_tensor(x) and x.is_floating_point()]


def _event_ms(fn, reps=3):
    """Device ms of one call by CUDA events around `reps` eager calls after
    a warm-up (the launch gaps of a host-bound call included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _out_grads(m, call, xs, weight_seed=13):
    """The output and the gradients of sum(out * W) w.r.t. m's parameters
    and the float inputs, as CPU tensors."""
    xs = [x.detach().requires_grad_(True)
          if torch.is_tensor(x) and x.is_floating_point() else x for x in xs]
    out = call(m, *xs)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        weight_seed)).to(out.device)
    grads = torch.autograd.grad((out * w).sum(), list(m.parameters())
                                + _float_inputs(xs))
    return out.detach().cpu(), [t.cpu() for t in grads]


def _float64(m):
    """A float64 copy of module `m`, its compute dtype float64 too."""
    import copy
    m64 = copy.deepcopy(m).double()
    for sub in m64.modules():
        if isinstance(getattr(sub, "dtype", None), torch.dtype):
            sub.dtype = torch.float64
    return m64


def _f64(xs):
    return [x.double() if torch.is_tensor(x) and x.is_floating_point()
            else x for x in xs]


def _zoo_held(tag, card, cpu, cpu64, tol=ZOO_PARITY_TOL):
    """[zoo]'s check of one module's (out, grads) readings: see
    ZOO_PARITY_TOL. Prints and returns the errors; raises past them."""
    direct = _rel(card, cpu)
    got, ref = _rel(card, cpu64), _rel(cpu, cpu64)
    limits = [max(t, ZOO_FLOAT32_FACTOR * r)
              for t, r in zip(tol.values(), ref)]
    print(f"[zoo]   {tag} card vs CPU at batch 2: out {direct[0]:.3e}, "
          f"grads {direct[1]:.3e}; from the CPU's float64: card "
          f"{got[0]:.3e} / {got[1]:.3e}, CPU float32 {ref[0]:.3e} / "
          f"{ref[1]:.3e} (limits {limits[0]:.3e} / {limits[1]:.3e})",
          flush=True)
    if not all(g <= lim for g, lim in zip(got, limits)):
        raise AssertionError(f"[zoo] {tag}: card {got} from float64, "
                             f"limits {limits}")
    return direct


def _rel(got, want):
    """(max |diff| / max |want| of the outputs, ||diff|| / ||want|| over
    the gradient lists)."""
    (o1, g1), (o0, g0) = got, want
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(g1, g0))
    den = sum(float((b.double() ** 2).sum()) for b in g0)
    return (float((o1 - o0).abs().max() / o0.abs().max()),
            (num / den) ** 0.5)


def _zoo_critic_step(m, real, fake, alpha):
    """One WGAN-GP critic step: (its [Wasserstein term, penalty] as a CPU
    tensor, its parameter gradients as CPU tensors), the penalty's double
    backward through `m`."""
    from dpig_tpu_torch.losses import gan
    d_real, d_fake = m(real), m(fake)
    loss = gan.d_loss("wgan-gp", d_real, d_fake, critic_fn=m,
                      real_data=real, fake_data=fake, alpha=alpha)
    grads = torch.autograd.grad(loss, list(m.parameters()))
    w = (d_fake.mean() - d_real.mean()).detach()
    terms = torch.stack([w, (loss.detach() - w) / gan.GP_LAMBDA])
    return terms.double().cpu(), [t.cpu() for t in grads]


def phase_zoo(m1_dir):
    """[zoo] (phase 28): see the module docstring."""
    import copy
    from dpig_tpu_torch.losses import gan
    from dpig_tpu_torch.models import discriminators as disc
    from dpig_tpu_torch.ops import ssim
    from dpig_tpu_torch.utils import plot

    card = torch.device("cuda")
    worst = {"out": 0.0, "grad": 0.0}
    for i, (name, make, inputs, call) in enumerate(_zoo_modules()):
        m = _zoo_init(make, 20 + i)
        xs = inputs(ZOO_BATCH, torch.Generator().manual_seed(40 + i))
        mc, xc = copy.deepcopy(m).to(card), _to(xs, card)
        with torch.no_grad():
            out = call(mc, *xc)
            fwd = _graph_ms(lambda: call(mc, *xc), reps=5, inner=3)
        params = list(mc.parameters())
        both = _event_ms(lambda: torch.autograd.grad(
            call(mc, *xc).float().square().mean(), params))
        small = [[t[:2] for t in x] if isinstance(x, list) else x[:2]
                 for x in xs]
        finite = bool(torch.isfinite(out).all())
        print(f"[zoo] {name}: {sum(p.numel() for p in params)} params, out "
              f"{tuple(out.shape)} finite={finite}; forward "
              f"{fwd:.3f} device ms, forward+backward {both:.3f} at batch "
              f"{ZOO_BATCH}", flush=True)
        if not finite:
            raise AssertionError(f"[zoo] {name}: outputs not finite")
        errs = _zoo_held(name, _out_grads(mc, call, _to(small, card)),
                         _out_grads(m, call, small),
                         _out_grads(_float64(m), call, _f64(small)))
        worst = {"out": max(worst["out"], errs[0]),
                 "grad": max(worst["grad"], errs[1])}
        del mc, xc, out

    g = torch.Generator().manual_seed(60)
    for fn, (h, w) in ((ssim.ssim, (128, 64)), (ssim.ssim, (256, 256)),
                       (ssim.ms_ssim, (256, 256))):
        a = torch.rand(ZOO_BATCH, h, w, 1, generator=g)
        b = (a + 0.1 * torch.randn(a.shape, generator=g)).clamp(0, 1)
        ac, bc = a.to(card), b.to(card)
        value = float(fn(ac, bc))
        ms = _event_ms(lambda: fn(ac, bc), reps=10)
        diff = abs(float(fn(ac[:2], bc[:2])) - float(fn(a[:2], b[:2])))
        print(f"[zoo] {fn.__name__} {h}x{w} batch {ZOO_BATCH}: {value:.6f}; "
              f"{ms:.3f} device ms; card vs CPU at batch 2: {diff:.3e}",
              flush=True)
        if not math.isfinite(value) or diff > ZOO_PARITY_TOL["out"]:
            raise AssertionError(f"[zoo] {fn.__name__} {h}x{w}: {value}, "
                                 f"card vs CPU {diff}")

    for name, make in (
            ("DCGAN wgan-gp", lambda: disc.get_discriminator(
                "DCGAN", 128, 64, mode="wgan-gp")),
            ("ResnetDiscriminator", lambda: disc.ResnetDiscriminator(
                128, 64, dim=64, blocks_per_scale=6))):
        m = _zoo_init(make, 70)
        g = torch.Generator().manual_seed(71)
        real, fake = (torch.rand(ZOO_BATCH, 128, 64, 3, generator=g) * 2 - 1
                      for _ in range(2))
        alpha = torch.rand(ZOO_BATCH, 1, 1, 1, generator=g)
        mc = copy.deepcopy(m).to(card)
        rc, fc, ac = real.to(card), fake.to(card), alpha.to(card)
        (w, gp), _ = _zoo_critic_step(mc, rc, fc, ac)
        ms = _event_ms(lambda: _zoo_critic_step(mc, rc, fc, ac))
        print(f"[zoo] WGAN-GP critic step, {name}: W term {w:.6f}, penalty "
              f"{gp:.6f} (loss W + {gan.GP_LAMBDA} x penalty) at batch "
              f"{ZOO_BATCH}, {ms:.3f} device ms", flush=True)
        if not (math.isfinite(w) and math.isfinite(gp)):
            raise AssertionError(f"[zoo] critic step {name}: {w}, {gp}")
        steps = [_zoo_critic_step(mc, rc[:2], fc[:2], ac[:2]),
                 _zoo_critic_step(m, real[:2], fake[:2], alpha[:2]),
                 _zoo_critic_step(_float64(m), *_f64(
                     [real[:2], fake[:2], alpha[:2]]))]
        print(f"[zoo]   penalty at batch 2: card {float(steps[0][0][1]):.6f}"
              f", CPU {float(steps[1][0][1]):.6f}, CPU float64 "
              f"{float(steps[2][0][1]):.6f}", flush=True)
        # the penalty is the norm of a gradient (of the critic w.r.t. its
        # input): it is held at the gradients' floor
        _zoo_held(f"critic step {name} ((W, penalty), critic grads)",
                  *steps, tol={"out": ZOO_PARITY_TOL["grad"],
                               "grad": ZOO_PARITY_TOL["grad"]})
        del mc

    series = plot.load_metrics(m1_dir)
    with open(os.path.join(m1_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    want_steps = [s for s in range(TRAIN_STEPS)
                  if s == 0 or s % TRAIN_LOG_STEP == TRAIN_LOG_STEP - 1]
    agree = set(series) == set(logged[0]) - {"step"} and all(
        v == [(r["step"], r[k]) for r in logged] for k, v in series.items())
    print(f"[zoo] load_metrics on [train]'s metrics.jsonl: {len(series)} "
          f"series, steps {[s for s, _ in series['L1Loss']]} (logged "
          f"{want_steps}), equal to the records: {agree}; worst card vs CPU "
          f"{worst}", flush=True)
    if not agree or [s for s, _ in series["L1Loss"]] != want_steps:
        raise AssertionError(f"[zoo] load_metrics {series}")


def _timed(phase):
    """`phase`, printing the seconds each call of it took."""
    @functools.wraps(phase)
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return phase(*args, **kw)
        finally:
            print(f"[time] {phase.__name__}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return run


def main() -> int:
    for k in [k for k in globals() if k.startswith("phase_")]:
        globals()[k] = _timed(globals()[k])
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
        modes = {**phase_demo(tmp), **phase_d_arch(tmp),
                 **phase_remat(tmp)}
        phase_inversion(tmp)
        ddp_pose, ddp_s8, ddp_entries = phase_ddp(tmp)
        phase_score(os.path.join(tmp, "m12"))
        q_pose, q_s8, q_entries = phase_quality(tmp, df_entries)
        converted = phase_convert(tmp)
        pipeline = phase_pipeline(tmp)
        critic_ab = phase_critic_ab()
        tf1 = phase_tf1_import(tmp)
        phase_zoo(os.path.join(tmp, "m1"))
    by_path = {"model 12 transfer": model12, **sampling,
               "model 1 training": train, **stage2, **data, **bf16,
               **int8_pose, **df_train, **df_pose, **modes, **ddp_pose,
               **q_pose, **converted, **pipeline, **critic_ab, **tf1}
    for path in (*df_train, *df_pose, *modes, *q_pose, *converted,
                 *pipeline, *tf1):
        if not by_path[path]:
            raise AssertionError(f"the pose kernel was not launched on "
                                 f"{path}")
    kernel["launches"] = sum(by_path.values())
    kernel["launches_by_path"] = by_path
    s8_by_path.update(df_s8)
    s8_by_path.update(ddp_s8)
    s8_by_path.update(q_s8)
    # the routes `plan` gives the main paths' calls: each must have been
    # launched there; mma_sync, the yardstick, is timed on every call
    planned = {r["route"] for sub in (s8, df_entries, ddp_entries, q_entries)
               for r in sub["mma_sync"]["shapes"]}
    for route, entry in s8.items():
        for key, sub in (("df256", df_entries), ("ddp batch 8", ddp_entries),
                         ("gate Market batch 64", q_entries)):
            entry[key] = {k: sub[route][k] for k in (
                "per", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "mma_sync_ms", "cudnn_bf16_ms", "max_abs_err",
                "shapes")}
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       sub[route]["max_abs_err"])
        entry["launches_by_path"] = {p: n[route]
                                     for p, n in s8_by_path.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if route in planned and not entry["launches"]:
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
