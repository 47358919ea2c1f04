// Pose-disc rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dpig_tpu/ops/pose_pallas.py:
// render_pose_maps_pallas (body `_kernel`, pallas_call at :72). Output
// channel k of pixel (h, w) is +1 when keypoint k is visible, in bounds and
// (h - r_k)^2 + (w - c_k)^2 <= radius^2, else -1.
//
// Bound: bytes. The kernel reads B*K*3 floats and writes B*H*W*K floats:
// 9.44 MB at the Market shape (B=16, 128x64, K=18), 2.8 us at the H100's
// 3.35 TB/s. An element needs only a compare, so the design's job is to
// spend next to nothing per element beyond its share of a store: no
// division by a runtime size and no keypoint decode per element.
//
// Design:
// - One block per output row (b, h), W*K contiguous floats.
// - Keypoints are decoded once per row, not per element: thread k turns
//   keypoint k into the column span [c - s, c + s] that its disc covers on
//   this row, s = isqrt(R^2 - dr^2) with dr = h - r (empty when invisible,
//   out of bounds or |dr| > R), into shared memory. The integer square root
//   makes `lo <= w <= hi` equal to dr^2 + dc^2 <= R^2 for every integer
//   input; no float rounding can move a disc edge.
// - Every thread writes 16 bytes at a time: thread t takes float4 t, t+T,
//   ... of the row, finds (w, k) of its first element with one division
//   and steps k, wrapping to w + 1, after that. Per element that leaves
//   two compares against the span table and a select. A row starts on a
//   16-byte boundary only when W*K % 4 == 0, so scalar stores peel a head
//   up to the first boundary and a tail; the row is never rounded.
// - Plain (write-back) stores: the generator's input concat reads the map
//   right after, and the Market map fits the 50 MB L2.
// What is left above a plain fill of the same bytes is mostly the block's
// start: no store can issue before its keypoints are read and decoded. A
// shared-memory staged row, with float4 or TMA bulk stores, did not beat
// this form on the card (PERF.md, Findings).
//
// Coordinates, in JAX's order (dpig_tpu/ops/pose.py:render_pose_maps):
// normalized ones are (x + 1) / 2 * S, clipped to [0, S - 1], floored;
// raw ones truncate toward zero and out-of-image keypoints are dropped.
// The float steps use the rounded intrinsics __fadd_rn, __fdiv_rn and
// __fmul_rn, which nvcc never contracts into an FMA, so the clipped value,
// exact edges such as S - 1 included, is the one XLA computes. Moving the
// decode from per element to per keypoint changes none of these steps.
// __float2int_rd / __float2int_rz give NaN -> 0 and saturate, as XLA's
// float -> int32 conversion does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Largest s with s * s <= q, for 0 <= q < 2^31: exact, bit by bit.
__device__ __forceinline__ int isqrt(int q) {
  unsigned x = static_cast<unsigned>(q), res = 0, bit = 1u << 30;
  while (bit > x) bit >>= 2;
  while (bit != 0) {
    if (x >= res + bit) {
      x -= res + bit;
      res = (res >> 1) + bit;
    } else {
      res >>= 1;
    }
    bit >>= 2;
  }
  return static_cast<int>(res);
}

// The columns [lo, hi] of row h inside keypoint p's disc; lo > hi if none.
__device__ __forceinline__ int2 keypoint_span(const float* p, int h, int H,
                                              int W, int radius2,
                                              int normalized) {
  const float rf = __ldg(p);
  const float cf = __ldg(p + 1);
  const float vf = __ldg(p + 2);
  int r, c;
  bool in_bounds;
  if (normalized) {
    float rr = __fmul_rn(__fdiv_rn(__fadd_rn(rf, 1.0f), 2.0f), (float)H);
    float cc = __fmul_rn(__fdiv_rn(__fadd_rn(cf, 1.0f), 2.0f), (float)W);
    rr = fminf(fmaxf(rr, 0.0f), (float)H - 1.0f);  // fmaxf: NaN -> 0
    cc = fminf(fmaxf(cc, 0.0f), (float)W - 1.0f);
    r = __float2int_rd(rr);
    c = __float2int_rd(cc);
    in_bounds = true;
  } else {
    r = __float2int_rz(rf);
    c = __float2int_rz(cf);
    in_bounds = r >= 0 && r < H && c >= 0 && c < W;
  }
  int2 span = make_int2(1, 0);
  if (vf > 0.0f && in_bounds) {
    const int dr = h - r;
    const int q = radius2 - dr * dr;
    if (q >= 0) {
      const int s = isqrt(q);
      span = make_int2(c - s, c + s);
    }
  }
  return span;
}

__device__ __forceinline__ float pixel(const int2* span, int w, int k) {
  const int2 s = span[k];
  return (s.x <= w && w <= s.y) ? 1.0f : -1.0f;
}

__global__ void __launch_bounds__(kThreads)
pose_raster_kernel(const float* __restrict__ rcv, float* __restrict__ out,
                   int H, int W, int K, int radius2, int normalized) {
  extern __shared__ int2 span[];  // [K]
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int t = threadIdx.x;
  for (int k = t; k < K; k += blockDim.x)
    span[k] = keypoint_span(rcv + (static_cast<size_t>(b) * K + k) * 3, h, H,
                            W, radius2, normalized);

  // Row layout: `head` scalars up to the first 16-byte boundary, `nvec`
  // float4s, then the scalar tail from `tail`.
  const int WK = W * K;
  float* row = out + static_cast<size_t>(blockIdx.x) * WK;
  const int past =  // floats since the last 16-byte boundary
      static_cast<int>(reinterpret_cast<uintptr_t>(row) >> 2) & 3;
  const int head = min((4 - past) & 3, WK);
  const int nvec = (WK - head) >> 2;
  const int tail = head + 4 * nvec;
  // (w, k) of this thread's first float4, and the step to its next one.
  const int e = head + 4 * t;
  int w = e / K;
  int k = e - w * K;
  const int step = 4 * blockDim.x;
  const int dw = step / K;
  const int dk = step - dw * K;
  __syncthreads();

  if (t < head) row[t] = pixel(span, t / K, t % K);
  if (tail + t < WK)
    row[tail + t] = pixel(span, (tail + t) / K, (tail + t) % K);

  float4* vec = reinterpret_cast<float4*>(row + head);
  for (int v = t; v < nvec; v += blockDim.x) {
    float o[4];
    int ww = w, kk = k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = pixel(span, ww, kk);
      if (++kk == K) {
        kk = 0;
        ++ww;
      }
    }
    vec[v] = make_float4(o[0], o[1], o[2], o[3]);
    w += dw;
    k += dk;
    if (k >= K) {
      k -= K;
      ++w;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() so the caller can raise.
extern "C" int dpig_pose_raster(const float* rcv, float* out, int B, int H,
                                int W, int K, int radius, int normalized,
                                cudaStream_t stream) {
  if (B > 0 && H > 0 && W > 0 && K > 0) {
    pose_raster_kernel<<<B * H, kThreads, K * sizeof(int2), stream>>>(
        rcv, out, H, W, K, radius * radius, normalized);
  }
  return static_cast<int>(cudaGetLastError());
}
