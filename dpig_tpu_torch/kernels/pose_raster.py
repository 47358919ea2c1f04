"""Wrapper of the CUDA pose-disc rasterizer (`csrc/pose_raster.cu`).

Replaces the Pallas TPU kernel `dpig_tpu/ops/pose_pallas.py:
render_pose_maps_pallas` (pallas_call at :72). The kernel is bound by the
bytes it writes: B*H*W*K*4, 9.44 MB at the Market shape (B=16, 128x64,
K=18), 2.8 us at the H100's 3.35 TB/s. So it spends almost nothing per
element: one block per output row decodes each keypoint once into the
column span its disc covers on that row (an integer square root, no
float), and every thread stores 16 bytes at a time, peeling scalar heads
and tails where a row of W*K floats is not 16-byte aligned. The source's
note has the details.

`render_pose_maps_cuda` checks its input, allocates the output with
`torch.empty`, launches on the current stream and raises if the launch
fails. It takes CUDA tensors only: CPU tensors go to
`ops.pose.render_pose_maps_plain` through `ops.pose.render_pose_maps`.
It accepts the sizes at which the plain version's int32 distance test
cannot overflow, so the two agree bit for bit on every input it takes.
`launches` counts the launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

launches = 0
MAX_KEYPOINTS = 6144  # K * 8 bytes of spans in the 48 KB of shared memory

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("pose_raster").dpig_pose_raster
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def render_pose_maps_cuda(rcv: torch.Tensor, img_h: int, img_w: int,
                          keypoint_num: int = 18, radius: int = 4,
                          normalized: bool = False) -> torch.Tensor:
    """rcv [B, K*3] or [B, K, 3] float32 on the card -> [B, H, W, K]
    float32 in {-1, +1}. The NHWC output permuted to NCHW is a
    channels_last view that a conv reads without a copy."""
    global launches
    if not rcv.is_cuda:
        raise ValueError("render_pose_maps_cuda takes a CUDA tensor; CPU "
                         "tensors go through ops.pose.render_pose_maps")
    if rcv.dtype != torch.float32:
        raise TypeError(f"rcv must be float32, got {rcv.dtype}")
    b = rcv.shape[0]
    if rcv.numel() != b * keypoint_num * 3:
        raise ValueError(f"rcv shape {tuple(rcv.shape)} is not "
                         f"[B, {keypoint_num}*3] or [B, {keypoint_num}, 3]")
    if not rcv.is_contiguous():
        raise ValueError("rcv must be contiguous")
    if not 0 <= radius <= 46340:  # radius^2 fits in int32
        raise ValueError(f"radius must be in [0, 46340], got {radius}")
    if (b * img_h * img_w * keypoint_num >= 2 ** 31
            or (img_h - 1) ** 2 + (img_w - 1) ** 2 >= 2 ** 31
            or keypoint_num > MAX_KEYPOINTS):
        raise ValueError("the output must be under 2^31 elements, "
                         "(H-1)^2 + (W-1)^2 under 2^31 and K at most "
                         f"{MAX_KEYPOINTS}")
    out = torch.empty((b, img_h, img_w, keypoint_num), dtype=torch.float32,
                      device=rcv.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(rcv.device):
        stream = torch.cuda.current_stream(rcv.device).cuda_stream
        err = _kernel()(rcv.data_ptr(), out.data_ptr(), b, img_h, img_w,
                        keypoint_num, radius, int(normalized), stream)
    if err != 0:
        raise RuntimeError(f"pose_raster launch failed: cudaError {err}")
    launches += 1
    return out
