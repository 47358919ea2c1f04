// s8 x s8 -> int32 convolution with a requantizing epilogue, for Hopper
// (sm_90a): wgmma fed by an asynchronous shared-memory ring, split-K for
// the small-M tail.
//
// Replaces the same XLA code as csrc/s8_conv.cu (the JAX package's
// `jax.lax.conv_general_dilated(..., preferred_element_type=int32)` in
// dpig_tpu/models/quant.py, `_qconv` / `_qconv_raw` :63-104, and the
// epilogues fused around it: `qconv` :297-339, `roi_fgbg_forward`
// :848-858) and computes what s8_conv.cu computes, bit for bit: for NHWC
// s8 x [B,H,W,Ci], weights w [Co,k,k,Ci] (k = 1 or 3), stride 1 or 2 and
// XLA's SAME pads (pad_t, pad_l given, the far side takes the rest),
//   acc = sum_{r,s,ci} x[b, oh*st-pad_t+r, ow*st-pad_l+s, ci] * w[co,r,s,ci]
//   y = acc*factor[co] + bias[co]; relu; + res*res_scale[co] (s8) or + res
//   (bf16); out = clip(rint(y/out_scale[co]), -127, 127) as s8, or bf16(y),
//   or y as float32,
// each float step one IEEE operation rounded to nearest even, in that
// order, never contracted into an FMA. The wrapper
// (dpig_tpu_torch/kernels/s8_conv.py, `plan`) sends a call here when
// Ci % 64 == 0 and Co >= 8: every conv of the Market generator and
// encoder but the 18-channel pose stem and the 3-channel to_rgb, which
// stay on s8_conv.cu.
//
// What bounds it on an H100: at the Market shapes the 3x3 convs do
// 2*M*N*K = 1-155 GOP on 0.5-50 MB, far above the card's ratio of 1979
// TOP/s to 3.35 TB/s, so the bound is the dense s8 tensor rate, which
// only wgmma reaches. What holds this kernel below it, from %globaltimer
// stamps per block (NVIDIA H100 80GB HBM3): the epilogue, which takes a
// quarter to nearly all of the main loop's time with nothing to overlap
// it (one block fills an SM); and, for 256 x 128 tiles, the A gather
// (1.37 us a stage against the tensor rate's 0.56; a 128 x 256 tile's
// main loop runs at 0.73, 77% of that rate). Overlapping the epilogue (a
// persistent block whose consumer warpgroups alternate) and TMA's im2col
// mode for A are the next steps. The design:
//
// - Implicit GEMM: M = B*Ho*Wo output pixels, N = Co, K = k*k*Ci in
//   (r, s, ci) order, cut into stages of 128 K-bytes: one tap x 128
//   channels when Ci % 128 == 0, two taps x 64 channels when Ci == 64 (a
//   stage may straddle taps; every 16-byte chunk lies in one tap since
//   Ci % 16 == 0). A block computes a BM x BN tile, 128 x 256 or
//   128 x 128 (the N tile that pads Co least) or, for a 128-wide N tile
//   with enough tiles to fill the card, 256 x 128: twice the MMA work per
//   stage for the same per-stage latency of the ring (the wrapper's
//   `plan` chooses).
// - 384 threads: warpgroup 0 produces, warpgroups 1 and 2 consume BM/2
//   rows each (setmaxnreg moves registers from the producer, 64, to the
//   consumers, 216: 64 x 256 or 2 x 64 x 128 int32 accumulators are 128
//   registers).
// - A ring of 4 stages in shared memory, each A (BM x 128 B) and B
//   (BN x 128 B), both K-major with the 128-byte swizzle (16-byte chunk c
//   of row r at r*128 + ((c ^ (r % 8)) * 16), tiles 1024-aligned), and a
//   full and an empty mbarrier per stage.
//   B, the weights [Co, K], comes by TMA (2-D tiled, box 128 x BN, the
//   same swizzle, out-of-range rows and K zero-filled). A is gathered by
//   the producer's 128 threads with 16-byte cp.async, src-size 0 where
//   the tap falls in the SAME padding or past K: the hardware writes the
//   zeros. Each thread owns one 16-byte column and BM/16 rows of A; it
//   decodes its rows' (b, ih0, iw0) once and steps its (r, s, ci) per
//   stage by adds, so the inner loop has no division. It arrives on a
//   stage's full barrier two stages later, after cp.async.wait_group and
//   a proxy fence, so the async proxy (wgmma) sees the generic-proxy
//   writes; the TMA's bytes complete the same barrier (129 arrivals).
// - Consumers: wgmma.mma_async m64nBNk32 s8 x s8 -> s32, A and B from the
//   descriptors (128-byte swizzle, stride 1024 B between 8-row groups;
//   the k32 step adds 32 B to the start address), 4 per stage, one
//   commit group per stage; wait_group 1 frees the stage before it.
// - Split-K for the tail (tile grid below the 132 SMs): blockIdx.z takes
//   stages [z*T/S, (z+1)*T/S) of the T stages and stores its int32
//   partial tile, straight from the accumulators, into its own slice of a
//   workspace [S, M, Co] (every element has one writer: no atomics, no
//   zeroing); a second launch, s8_conv_split_k_finish, adds the S slices
//   (int32 sums are exact in any order) and runs the epilogue once per
//   output, one thread per 8 channels of a row, over every SM. A first
//   design with red.global.add into one zeroed [M, Co] sum and a ticket
//   per tile spent most of a 100 us tail call in the atomics on an H100.
//   The wrapper allocates the workspace (torch.empty).
// - Epilogue: the accumulators go through shared memory (the ring, free by
//   then); the consumers give back registers (setmaxnreg 216 -> 160) so
//   the producer can take some (64 -> 160) and all 384 threads finish the
//   tile, each 8 consecutive channels of two rows at a time, its
//   channels' factor / bias / scales in registers, with 8- to 32-byte
//   coalesced loads of the residual and stores of the output where
//   Co % 8 == 0 and the pointers are 16-byte aligned, element by element
//   otherwise. It is a third to a half of a large conv's time (measured
//   with timestamps on an H100), because nothing overlaps it: one block
//   fills an SM. So its arithmetic is kept branch-free: the residual kind
//   is a template parameter, and the requantizing division runs only for
//   values near a rounding boundary (requant8).
// The largest |acc| at the Market shapes is 127*127*9216 < 2^31, so any
// tiling, K order and split gives the same int32 sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace {

constexpr int BK = 128;  // K-bytes per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
// A producer thread arrives on a stage's full barrier LAG stages after
// issuing it. LAG <= STAGES - 2, or the ring deadlocks: the consumers free
// a stage only after waiting on the one after it.
constexpr int LAG = 2;
constexpr int THREADS = 384;

struct Params {
  const int8_t* x;
  const float* factor;
  const float* bias;
  const void* res;
  int res_kind;  // 0 none, 1 s8, 2 bf16
  const float* res_scale;
  void* out;
  int out_kind;  // 0 s8, 1 bf16, 2 f32
  const float* out_scale;
  int relu;
  int vec;       // 8-channel vector loads and stores
  int* ws;       // split-K: int32 [split, M, Co] partial sums
  int B, H, W, Ci, Ho, Wo, Co, ks, stride, pad_t, pad_l;
  int M, K, stages, split;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Spins on a phase; a wait of more than 2^35 clocks (~19 s) traps, so a
// fault in the ring's protocol is a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 35)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO 64 x 16 B; LBO unused by this layout, 1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_m64n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256(int (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// One consumer thread's 8 output channels: their scales and bias, and an
// approximate reciprocal of the output scale (requant8).
struct Chan {
  float f[8], b[8], rs[8], os[8], inv[8];
};

// All loads first, then the reciprocals: no branch between the loads, so
// their latencies overlap. rcp.approx is within 2^-23 relative; a scale
// that is not a normal finite number gets NaN, which sends every value of
// its channel to the division in requant8.
__device__ __forceinline__ void load_chan(const Params& p, int n, Chan& c) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int co = min(n + e, p.Co - 1);
    c.f[e] = p.factor[co];
    c.b[e] = p.bias[co];
    c.rs[e] = p.res_kind == 1 ? p.res_scale[co] : 0.0f;
    c.os[e] = p.out_kind == 0 ? p.out_scale[co] : 1.0f;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float r;
    asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(c.os[e]));
    const float a = fabsf(c.os[e]);
    c.inv[e] = a >= 1.17549435e-38f && a <= 3.40282347e+38f
                   ? r : __int_as_float(0x7fc00000);
  }
}

// clip(rint(y / os), -127, 127) with y / os rounded once (IEEE division),
// as the plain version computes it, for 8 values. The division is the
// epilogue's most expensive step (a call with a slow path, and a branch
// that keeps the compiler from interleaving the values), so it runs only
// where it can matter: q0 = y * inv (inv within 2^-23, the product
// rounded once) is within 2^-22 * |y/os| of the rounded quotient, under
// 3.1e-5 while |q0| < 130. Where q0 lies more than 1e-3 from a
// half-integer, both round to the same integer; where |q0| >= 130, both
// clip to the same +-127. Near a half-integer, or for NaN, the division
// decides. Returns the 8 s8 values packed in .x / .y.
__device__ __forceinline__ bool needs_division(float q0) {
  const float a = fabsf(q0);
  return !(a >= 130.0f) && !(fabsf(a - floorf(a) - 0.5f) > 1e-3f);
}

__device__ __forceinline__ uint2 requant8(const float (&y)[8],
                                          const Chan& c) {
  float q[8];
  bool slow = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float q0 = __fmul_rn(y[e], c.inv[e]);
    slow |= needs_division(q0);
    q[e] = fabsf(q0) >= 130.0f ? copysignf(127.0f, q0) : rintf(q0);
  }
  if (slow) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (needs_division(__fmul_rn(y[e], c.inv[e]))) {
        q[e] = rintf(__fdiv_rn(y[e], c.os[e]));
      }
    }
  }
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t b = static_cast<uint8_t>(
        static_cast<int8_t>(fminf(fmaxf(q[e], -127.0f), 127.0f)));
    if (e < 4) lo |= b << (8 * e); else hi |= b << (8 * (e - 4));
  }
  return make_uint2(lo, hi);
}

// The residual kind (Params::res_kind) is a template parameter of the
// epilogue: as a run-time value its tests put a branch around every
// output's residual step, and the branches kept the compiler from
// interleaving the 8 (or 16) independent outputs of a thread, which left
// the epilogue as long as the main loop of a large conv.

// The residual of up to 8 channels at `base`: s8 values packed in .x / .y,
// or bf16 values in .x-.w (zeros past nval).
template <int RES>
__device__ __forceinline__ uint4 load_res8(const Params& p, long long base,
                                           int nval) {
  if (RES == 0) return make_uint4(0, 0, 0, 0);
  if (p.vec) {
    if (RES == 1) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          static_cast<const int8_t*>(p.res) + base);
      return make_uint4(v.x, v.y, 0, 0);
    }
    return *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.res) + base);
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (e >= nval) break;
    if (RES == 1) {
      w[e >> 2] |= static_cast<uint32_t>(
                       static_cast<const uint8_t*>(p.res)[base + e])
                   << (8 * (e & 3));
    } else {
      w[e >> 1] |= static_cast<uint32_t>(
                       static_cast<const uint16_t*>(p.res)[base + e])
                   << (16 * (e & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// y = acc*factor + bias; relu; + the residual rv (load_res8), in
// s8_conv.cu's `store_out` order, each step rounded once.
template <int RES>
__device__ __forceinline__ void finish8(const Params& p, const int (&a)[8],
                                        const Chan& c, uint4 rv,
                                        float (&y)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    y[e] = __fadd_rn(__fmul_rn(__int2float_rn(a[e]), c.f[e]), c.b[e]);
    if (p.relu) y[e] = fmaxf(y[e], 0.0f);
    if (RES == 1) {
      const int8_t v = static_cast<int8_t>((e < 4 ? rv.x : rv.y) >>
                                           (8 * (e & 3)));
      y[e] = __fadd_rn(y[e], __fmul_rn(static_cast<float>(v), c.rs[e]));
    } else if (RES == 2) {
      const uint32_t w = e < 2 ? rv.x : e < 4 ? rv.y : e < 6 ? rv.z : rv.w;
      y[e] = __fadd_rn(y[e], __uint_as_float(e & 1 ? w & 0xFFFF0000u
                                                   : w << 16));
    }
  }
}

// Stores the 8 outputs at `base` (the first nval of them) as s8, bf16 or
// float32.
__device__ __forceinline__ void store8(const Params& p, long long base,
                                       int nval, const float (&y)[8],
                                       const Chan& c) {
  if (p.out_kind == 0) {
    const uint2 q = requant8(y, c);
    int8_t* o = static_cast<int8_t*>(p.out) + base;
    if (p.vec) {
      *reinterpret_cast<uint2*>(o) = q;
      return;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e >= nval) break;
      o[e] = static_cast<int8_t>((e < 4 ? q.x : q.y) >> (8 * (e & 3)));
    }
  } else if (p.out_kind == 1) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      w[e >> 1] = static_cast<uint32_t>(
                      __bfloat16_as_ushort(__float2bfloat16_rn(y[e]))) |
                  (static_cast<uint32_t>(__bfloat16_as_ushort(
                       __float2bfloat16_rn(y[e + 1]))) << 16);
    }
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + base;
    if (p.vec) {
      *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e >= nval) break;
      reinterpret_cast<uint16_t*>(o)[e] =
          static_cast<uint16_t>(w[e >> 1] >> (16 * (e & 1)));
    }
  } else {
    float* o = static_cast<float*>(p.out) + base;
    if (p.vec) {
      reinterpret_cast<float4*>(o)[0] = make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(y[4], y[5], y[6], y[7]);
      return;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (e >= nval) break;
      o[e] = y[e];
    }
  }
}

// Output channels n .. n+7 of R rows m[r] (m[r] < 0: no row; the channels
// below Co) from their sums a[r] and residuals rv[r] (load_res_rows).
template <int RES, int R>
__device__ __forceinline__ void epilogue_rows(const Params& p,
                                              const int (&m)[R], int n,
                                              const int (&a)[R][8],
                                              const uint4 (&rv)[R],
                                              const Chan& c) {
  const int nval = min(8, p.Co - n);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (m[r] < 0) continue;
    float y[8];
    finish8<RES>(p, a[r], c, rv[r], y);
    store8(p, static_cast<long long>(m[r]) * p.Co + n, nval, y, c);
  }
}

// The residuals of rows m[r] (load_res8; zeros where m[r] < 0).
template <int RES, int R>
__device__ __forceinline__ void load_res_rows(const Params& p,
                                              const int (&m)[R], int n,
                                              uint4 (&rv)[R]) {
  const int nval = min(8, p.Co - n);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rv[r] = m[r] < 0 ? make_uint4(0, 0, 0, 0)
                     : load_res8<RES>(
                           p, static_cast<long long>(m[r]) * p.Co + n, nval);
  }
}

// The epilogue of a block's BM x BN int32 tile in shared memory (rows
// padded to BN + 8 ints), by NT threads: thread t finishes the 8 channels
// of group t % (BN/8) on every (NT/(BN/8))-th row, two rows at a time.
template <int BM, int BN, int NT, int RES>
__device__ __forceinline__ void tile_epilogue_res(const Params& p,
                                                  const int* tile, int m0,
                                                  int n0, int t) {
  constexpr int LDT = BN + 8;
  constexpr int GROUPS = BN / 8;
  constexpr int ROW_STEP = NT / GROUPS;
  const int n = n0 + (t % GROUPS) * 8;
  if (n >= p.Co) return;
  // rows row0 + (2i + r) * ROW_STEP, two at a time; the residual of the
  // next two is loaded before this two's arithmetic, to hide its latency
  auto rows = [&](int row, int (&m)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + r * ROW_STEP;
      m[r] = rr < BM && m0 + rr < p.M ? m0 + rr : -1;
    }
  };
  int m[2];
  uint4 rv[2];
  rows(t / GROUPS, m);
  load_res_rows<RES, 2>(p, m, n, rv);
  Chan ch;
  load_chan(p, n, ch);
  for (int row = t / GROUPS; m[0] >= 0; row += 2 * ROW_STEP) {
    int a[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int4* v = reinterpret_cast<const int4*>(
          tile + (m[r] < 0 ? 0 : row + r * ROW_STEP) * LDT + n - n0);
      const int4 lo = v[0], hi = v[1];
      a[r][0] = lo.x; a[r][1] = lo.y; a[r][2] = lo.z; a[r][3] = lo.w;
      a[r][4] = hi.x; a[r][5] = hi.y; a[r][6] = hi.z; a[r][7] = hi.w;
    }
    int mn[2];
    uint4 rvn[2];
    rows(row + 2 * ROW_STEP, mn);
    load_res_rows<RES, 2>(p, mn, n, rvn);
    epilogue_rows<RES, 2>(p, m, n, a, rv, ch);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = mn[r];
      rv[r] = rvn[r];
    }
  }
}

template <int BM, int BN, int NT>
__device__ __forceinline__ void tile_epilogue(const Params& p,
                                              const int* tile, int m0,
                                              int n0, int t) {
  if (p.res_kind == 1) {
    tile_epilogue_res<BM, BN, NT, 1>(p, tile, m0, n0, t);
  } else if (p.res_kind == 2) {
    tile_epilogue_res<BM, BN, NT, 2>(p, tile, m0, n0, t);
  } else {
    tile_epilogue_res<BM, BN, NT, 0>(p, tile, m0, n0, t);
  }
}

template <int BM, int BN, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    s8_conv_sm90_kernel(const __grid_constant__ CUtensorMap wmap,
                        const Params p) {
  constexpr int A_BYTES = BM * BK;
  constexpr int B_BYTES = BN * BK;
  constexpr int RPT = BM / 16;  // A rows a producer thread gathers
  constexpr int MT = BM / 128;  // m64 blocks of a consumer warpgroup
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  // full[s] at bars + 8s, empty[s] at bars + 8(STAGES + s)
  const uint32_t bars = sbase + STAGES * STAGE_BYTES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int s_begin = static_cast<int>(
      static_cast<long long>(blockIdx.z) * p.stages / p.split);
  const int nst = static_cast<int>(static_cast<long long>(blockIdx.z + 1) *
                                   p.stages / p.split) - s_begin;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 128 + 1);     // A arrivals + the TMA's
      mbar_init(bars + 8 * (STAGES + s), 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 64;\n");
    const int c = tid & 7;    // this thread's 16-byte column of the tile
    const int r0 = tid >> 3;  // and its rows r0 + 16j, j < RPT
    // Rows r0 + 16j: (b, oh, ow) by division for the first, then stepped.
    int rowoff[RPT], hw[RPT];
    int ow = (m0 + r0) % p.Wo;
    int oh = (m0 + r0) / p.Wo;
    int b = oh / p.Ho;
    oh -= b * p.Ho;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (m0 + r0 + 16 * j < p.M) {
        const int ih0 = oh * p.stride - p.pad_t;
        const int iw0 = ow * p.stride - p.pad_l;
        rowoff[j] = ((b * p.H + ih0) * p.W + iw0) * p.Ci;
        hw[j] = static_cast<int>((static_cast<uint32_t>(ih0) << 16) |
                                 (static_cast<uint32_t>(iw0) & 0xFFFFu));
      } else {  // past M: ih0 = -16384, never inside the image
        rowoff[j] = 0;
        hw[j] = static_cast<int>(0xC0000000u);
      }
      for (ow += 16; ow >= p.Wo; ow -= p.Wo) {
        if (++oh == p.Ho) {
          oh = 0;
          ++b;
        }
      }
    }
    const int k = s_begin * BK + c * 16;
    const int tap = k / p.Ci;
    int ci = k - tap * p.Ci;
    int r = tap / p.ks;
    int s = tap - r * p.ks;
    // rows r0 + 16j share r0 % 8, so one swizzled column for all of them
    const uint32_t a_off = r0 * BK + ((c ^ (r0 & 7)) << 4);
    for (int i = 0; i < nst; ++i) {
      const int st = i % STAGES;
      mbar_wait(bars + 8 * (STAGES + st), ((i / STAGES) & 1) ^ 1);
      const uint32_t a_s = sbase + st * STAGE_BYTES;
      if (tid == 0) {
        mbar_arrive_tx(bars + 8 * st, B_BYTES);
        tma_load_2d(a_s + A_BYTES, &wmap, bars + 8 * st, (s_begin + i) * BK,
                    n0);
      }
      const bool kin = r < p.ks;
      const int toff = (r * p.W + s) * p.Ci + ci;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int ih = (hw[j] >> 16) + r;
        const int iw = static_cast<int16_t>(hw[j] & 0xFFFF) + s;
        const bool ok = kin && static_cast<unsigned>(ih) < unsigned(p.H) &&
                        static_cast<unsigned>(iw) < unsigned(p.W);
        cp_async16(a_s + a_off + j * 16 * BK,
                   ok ? p.x + (rowoff[j] + toff) : p.x, ok ? 16u : 0u);
      }
      cp_async_commit();
      ci += BK;  // the next stage's chunk: step (r, s, ci) by 128 bytes
      while (ci >= p.Ci) {
        ci -= p.Ci;
        if (++s == p.ks) {
          s = 0;
          ++r;
        }
      }
      if (i >= LAG) {
        cp_async_wait<LAG>();
        fence_proxy_async();
        mbar_arrive(bars + 8 * ((i - LAG) % STAGES));
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int i = nst > LAG ? nst - LAG : 0; i < nst; ++i) {
      mbar_arrive(bars + 8 * (i % STAGES));
    }
    if (SPLIT) return;
    // the epilogue, with the consumers (registers from their setmaxnreg.dec)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    named_sync(2, THREADS);
    tile_epilogue<BM, BN, THREADS>(p, reinterpret_cast<const int*>(smem), m0,
                                   n0, tid);
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
  const int cw = (tid >> 7) - 1;  // warpgroup 0 or 1: rows cw * BM/2 ..
  const int lane = tid & 31;
  constexpr int NACC = BN / 2;
  int acc[MT][NACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[mt][i] = 0;
  for (int i = 0; i < nst; ++i) {
    const int st = i % STAGES;
    mbar_wait(bars + 8 * st, (i / STAGES) & 1);
    const uint32_t a_s = sbase + st * STAGE_BYTES + cw * (BM / 2) * BK;
    const uint32_t b_s = sbase + st * STAGE_BYTES + A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint64_t da = sw128_desc(a_s + mt * 64 * BK + kk);
        if constexpr (BN == 256) {
          wgmma_m64n256(acc[mt], da, sw128_desc(b_s + kk));
        } else {
          wgmma_m64n128(acc[mt], da, sw128_desc(b_s + kk));
        }
      }
    }
    wg_commit();
    wg_wait<1>();  // the stage before this one is read: free it
    if (i > 0 && lane == 0) {
      mbar_arrive(bars + 8 * (STAGES + (i - 1) % STAGES));
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NACC; ++i)
      asm volatile("" : "+r"(acc[mt][i])::"memory");

  // m64nNk32 accumulators: d[4j + 2h + e] is row 16*warp + lane/4 + 8h,
  // column 8j + 2*(lane % 4) + e of the m64 block's 64 x BN.
  const int warp_row = cw * (BM / 2) + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int lane_col = (lane & 3) * 2;
  if (SPLIT) {
    // This block's partial sums into its own slice ws[z] [M, Co], straight
    // from the accumulators. Every element of the slice has one writer;
    // s8_conv_split_k_finish adds the slices.
    int* ws = p.ws + static_cast<long long>(blockIdx.z) * p.M * p.Co;
    const bool pairs = (p.Co & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp_row + mt * 64 + 8 * h;
        if (m >= p.M) continue;
        int* row = ws + static_cast<long long>(m) * p.Co;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int co = n0 + 8 * j + lane_col;
          const int v0 = acc[mt][4 * j + 2 * h];
          const int v1 = acc[mt][4 * j + 2 * h + 1];
          if (pairs && co < p.Co) {
            *reinterpret_cast<int2*>(row + co) = make_int2(v0, v1);
          } else {
            if (co < p.Co) row[co] = v0;
            if (co + 1 < p.Co) row[co + 1] = v1;
          }
        }
      }
    }
    return;
  }

  // Epilogue. Both warpgroups are past their last wgmma, so the ring is
  // free: the int32 tile goes there, rows padded by 8 ints. Then the
  // consumers give back registers, the producer takes some, and all 384
  // threads finish the tile (the float epilogue is latency-bound, and 8
  // warps alone left the SM idle for a third of a large conv's time).
  named_sync(1, 256);
  int* tile = reinterpret_cast<int*>(smem);
  constexpr int LDT = BN + 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      int* t0 = tile + (warp_row + mt * 64) * LDT + j * 8 + lane_col;
      *reinterpret_cast<int2*>(t0) =
          make_int2(acc[mt][4 * j], acc[mt][4 * j + 1]);
      *reinterpret_cast<int2*>(t0 + 8 * LDT) =
          make_int2(acc[mt][4 * j + 2], acc[mt][4 * j + 3]);
    }
  }
  asm volatile("setmaxnreg.dec.sync.aligned.u32 160;\n");
  named_sync(2, THREADS);
  tile_epilogue<BM, BN, THREADS>(p, tile, m0, n0, tid);
}

// Split-K's second launch: one thread per 8 channels of an output row adds
// the split slices of the workspace (int32, exact in any order) and runs
// the epilogue once on the full sum.
__global__ void __launch_bounds__(256)
    s8_conv_split_k_finish(const Params p) {
  const int groups = (p.Co + 7) / 8;
  const long long id =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= static_cast<long long>(p.M) * groups) return;
  const int m = static_cast<int>(id / groups);
  const int n = static_cast<int>(id - static_cast<long long>(m) * groups) * 8;
  const long long slice = static_cast<long long>(p.M) * p.Co;
  const int* w = p.ws + static_cast<long long>(m) * p.Co + n;
  int a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (p.vec) {  // Co % 8 == 0: two 16-byte loads a slice
    for (int z = 0; z < p.split; ++z) {
      const int4* v = reinterpret_cast<const int4*>(w + z * slice);
      const int4 lo = __ldcg(v), hi = __ldcg(v + 1);
      a[0] += lo.x; a[1] += lo.y; a[2] += lo.z; a[3] += lo.w;
      a[4] += hi.x; a[5] += hi.y; a[6] += hi.z; a[7] += hi.w;
    }
  } else {
    for (int z = 0; z < p.split; ++z) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (n + e < p.Co) a[e] += __ldcg(w + z * slice + e);
      }
    }
  }
  Chan ch;
  load_chan(p, n, ch);
  const int mm[1] = {m};
  const int aa[1][8] = {{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]}};
  uint4 rv[1];
  if (p.res_kind == 1) {
    load_res_rows<1, 1>(p, mm, n, rv);
    epilogue_rows<1, 1>(p, mm, n, aa, rv, ch);
  } else if (p.res_kind == 2) {
    load_res_rows<2, 1>(p, mm, n, rv);
    epilogue_rows<2, 1>(p, mm, n, aa, rv, ch);
  } else {
    load_res_rows<0, 1>(p, mm, n, rv);
    epilogue_rows<0, 1>(p, mm, n, aa, rv, ch);
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda.
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
    }
  }
  return fn;
}

template <int BM, int BN, bool SPLIT>
int launch(const CUtensorMap& map, const Params& p, cudaStream_t stream) {
  constexpr int SMEM = STAGES * (BM * BK + BN * BK) + 16 * STAGES + 1024;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        s8_conv_sm90_kernel<BM, BN, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid((p.Co + BN - 1) / BN, (p.M + BM - 1) / BM, p.split);
  s8_conv_sm90_kernel<BM, BN, SPLIT><<<grid, THREADS, SMEM, stream>>>(map, p);
  if (SPLIT) {
    const long long threads =
        static_cast<long long>(p.M) * ((p.Co + 7) / 8);
    s8_conv_split_k_finish<<<static_cast<unsigned>((threads + 255) / 256),
                             256, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0, a cudaError_t, -1 when the driver has no
// cuTensorMapEncodeTiled, or -1000 - CUresult when it refuses the map.
// `workspace`: split > 1 only, split*M*Co int32 (need not be zeroed).
extern "C" int dpig_s8_conv_sm90(const void* x, const void* w,
                                 const float* factor, const float* bias,
                                 const void* res, int res_kind,
                                 const float* res_scale, void* out,
                                 int out_kind, const float* out_scale,
                                 int relu, int B, int H, int W, int Ci,
                                 int Ho, int Wo, int Co, int ks, int stride,
                                 int pad_t, int pad_l, int bm, int bn,
                                 int split, void* workspace,
                                 cudaStream_t stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.factor = factor;
  p.bias = bias;
  p.res = res;
  p.res_kind = res_kind;
  p.res_scale = res_scale;
  p.out = out;
  p.out_kind = out_kind;
  p.out_scale = out_scale;
  p.relu = relu;
  p.B = B; p.H = H; p.W = W; p.Ci = Ci; p.Ho = Ho; p.Wo = Wo; p.Co = Co;
  p.ks = ks; p.stride = stride; p.pad_t = pad_t; p.pad_l = pad_l;
  p.M = B * Ho * Wo;
  p.K = ks * ks * Ci;
  p.stages = (p.K + BK - 1) / BK;
  p.split = split;
  if (Ci % 16 != 0 || (bn != 128 && bn != 256) || split < 1 ||
      (bm != 128 && (bm != 256 || bn != 128 || split > 1)) ||
      split > p.stages || (split > 1 && workspace == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.vec = Co % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(res) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(workspace) % 16 == 0;
  p.ws = static_cast<int*>(workspace);

  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return -1;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.K),
                              static_cast<cuuint64_t>(Co)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult cr = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return -1000 - static_cast<int>(cr);
  if (bm == 256) return launch<256, 128, false>(map, p, stream);
  if (bn == 256) {
    return split > 1 ? launch<128, 256, true>(map, p, stream)
                     : launch<128, 256, false>(map, p, stream);
  }
  return split > 1 ? launch<128, 128, true>(map, p, stream)
                   : launch<128, 128, false>(map, p, stream);
}
