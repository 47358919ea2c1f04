// Pose-disc rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dpig_tpu/ops/pose_pallas.py:
// render_pose_maps_pallas (body `_kernel`, pallas_call at :72). Output
// channel k of pixel (h, w) is +1 when keypoint k is visible, in bounds and
// (h - r_k)^2 + (w - c_k)^2 <= radius^2, else -1.
//
// Bound: writes. The kernel reads B*K*3 floats and writes B*H*W*K floats;
// at the Market shape (B=16, 128x64, K=18) that is 9.44 MB written per
// call, 2.8 us at the H100's 3.35 TB/s, near launch latency. This simple
// form spends more than that on index arithmetic (three divisions by
// runtime sizes per element); PERF.md has its measured time and the
// row-per-block design that would remove them.
//
// Design: one launch per call, one thread per output element of the
// contiguous [B,H,W,K] float32 output, so neighbouring threads store to
// neighbouring addresses (fully coalesced 128-byte stores per warp). The
// TPU kernel's host-side per-lane tables are gone: each thread reads its
// keypoint (r, c, v) straight from rcv [B,K,3] (the 216 bytes of a sample
// sit in L1 after the first warp touches them). Coordinates go to integers
// first: denormalization uses explicitly rounded float intrinsics in the
// JAX order ((r + 1) / 2 * H, clip, floor), raw coords truncate, and the
// distance test is integer arithmetic, so no float contraction can move a
// disc edge and the output is bit-equal to the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

__global__ void pose_raster_kernel(const float* __restrict__ rcv,
                                   float* __restrict__ out, int total, int H,
                                   int W, int K, int radius2,
                                   int normalized) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int k = idx % K;
  int t = idx / K;
  const int w = t % W;
  t /= W;
  const int h = t % H;
  const int b = t / H;

  const float* p = rcv + (b * K + k) * 3;
  const float rf = __ldg(p);
  const float cf = __ldg(p + 1);
  const float vf = __ldg(p + 2);

  int r, c;
  bool in_bounds;
  if (normalized) {
    // (x + 1) / 2 * S, clipped to [0, S - 1], floored (ops/pose.py:28-31,75-76).
    float rr = __fmul_rn(__fdiv_rn(__fadd_rn(rf, 1.0f), 2.0f), (float)H);
    float cc = __fmul_rn(__fdiv_rn(__fadd_rn(cf, 1.0f), 2.0f), (float)W);
    rr = fminf(fmaxf(rr, 0.0f), (float)H - 1.0f);
    cc = fminf(fmaxf(cc, 0.0f), (float)W - 1.0f);
    r = __float2int_rd(rr);
    c = __float2int_rd(cc);
    in_bounds = true;
  } else {
    // Truncate toward zero; out-of-image keypoints are dropped (pose.py:81-83).
    r = __float2int_rz(rf);
    c = __float2int_rz(cf);
    in_bounds = r >= 0 && r < H && c >= 0 && c < W;
  }
  bool on = false;
  if (vf > 0.0f && in_bounds) {
    const int dr = h - r;
    const int dc = w - c;
    on = dr * dr + dc * dc <= radius2;
  }
  out[idx] = on ? 1.0f : -1.0f;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() so the caller can raise.
extern "C" int dpig_pose_raster(const float* rcv, float* out, int B, int H,
                                int W, int K, int radius, int normalized,
                                cudaStream_t stream) {
  const int total = B * H * W * K;
  if (total > 0) {
    const int threads = 256;
    const int blocks = (total + threads - 1) / threads;
    pose_raster_kernel<<<blocks, threads, 0, stream>>>(
        rcv, out, total, H, W, K, radius * radius, normalized);
  }
  return static_cast<int>(cudaGetLastError());
}
