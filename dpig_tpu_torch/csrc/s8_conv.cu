// s8 x s8 -> int32 convolution with a requantizing epilogue, for sm_90a.
//
// Replaces XLA code of the JAX package's int8 serving path, not a Pallas
// kernel: `jax.lax.conv_general_dilated(..., preferred_element_type=int32)`
// in dpig_tpu/models/quant.py (`_qconv` / `_qconv_raw`, :63-104) and the
// epilogues fused around it (`qconv` :297-339, the int8 stem :350-359,
// `to_rgb` :456-461, `roi_fgbg_forward` :848-858). The wrapper and the
// plain version are in dpig_tpu_torch/kernels/s8_conv.py.
//
// What it computes, for NHWC s8 input x [B,H,W,Ci], weights w [Co,k,k,Ci]
// (k = 1 or 3), stride 1 or 2 and XLA's SAME pads (pad_t, pad_l given; the
// far side pads whatever is left, the asymmetric stride-2 case included):
//   acc = sum_{r,s,ci} x[b, oh*st-pad_t+r, ow*st-pad_l+s, ci] * w[co,r,s,ci]
//   y = acc*factor[co] + bias[co]; relu; + res*res_scale[co] (s8) or + res
//   (bf16); out = clip(rint(y/out_scale[co]), -127, 127) as s8, or bf16(y),
//   or y as float32.
// Every float step is one IEEE operation rounded to nearest even
// (__fmul_rn / __fadd_rn / __fdiv_rn, never contracted into an FMA), in
// the plain version's order, so the two agree bit for bit.
//
// Design: an implicit GEMM, M = B*Ho*Wo output pixels, N = Co, K = k*k*Ci
// in (r, s, ci) order, so a 16-byte run of K is 16 channels of one input
// pixel. A block of 4 warps computes a 64 x 64 tile of the output; its
// 64-deep K slices of A (gathered from the input with the SAME padding
// as zeros) and B (the weights, K contiguous per output channel) are staged
// in shared memory, rows padded to 80 bytes so the fragment loads hit 32
// distinct banks. Each warp computes 32 x 32 with mma.sync m16n8k32 s8
// (int32 accumulators, exact). While the tensor cores work on one slice,
// the next one's global loads are in flight in registers (when Ci is a
// multiple of 16 and the pointers 16-byte aligned: every conv of the
// Market generator and encoder but the 18-channel pose stem, whose slices
// are gathered byte by byte).
//
// What bounds it on an H100: at the Market shapes the 3x3 convs do
// 2*M*N*K = 19-155 GFLOP of s8 work on 2-50 MB, far above the card's
// ratio of 1979 TOP/s to 3.35 TB/s, so the bound is the s8 tensor-core
// rate. mma.sync reaches a fraction of it (wgmma and TMA are what reach
// the rest); that redesign is later work, this kernel is the simple one
// that is right.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // row pitch of the shared tiles, in bytes
constexpr int THREADS = 128;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* factor;
  const float* bias;
  const void* res;
  int res_kind;  // 0 none, 1 s8, 2 bf16
  const float* res_scale;
  void* out;
  int out_kind;  // 0 s8, 1 bf16, 2 f32
  const float* out_scale;
  int relu;
  int B, H, W, Ci, Ho, Wo, Co, ks, stride, pad_t, pad_l;
  int M, K;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The input pixel (b, oh, ow) of output row m, as the offset of its
// top-left tap and its top-left coordinates; valid = m < M.
struct Row {
  int base;  // b*H*W
  int ih0, iw0;
  bool valid;
};

__device__ __forceinline__ Row decode_row(const Params& p, int m) {
  Row r;
  r.valid = m < p.M;
  int mm = r.valid ? m : 0;
  int ow = mm % p.Wo;
  int t = mm / p.Wo;
  int oh = t % p.Ho;
  int b = t / p.Ho;
  r.base = b * p.H * p.W;
  r.ih0 = oh * p.stride - p.pad_t;
  r.iw0 = ow * p.stride - p.pad_l;
  return r;
}

// 16 bytes of A: channels ci..ci+15 of one tap (k multiple of 16).
__device__ __forceinline__ int4 load_a16(const Params& p, const Row& r,
                                         int k) {
  int4 v = make_int4(0, 0, 0, 0);
  if (!r.valid || k >= p.K) return v;
  int tap = k / p.Ci;
  int ci = k - tap * p.Ci;
  int ih = r.ih0 + tap / p.ks;
  int iw = r.iw0 + tap % p.ks;
  if (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W) return v;
  return __ldg(reinterpret_cast<const int4*>(
      p.x + (static_cast<long long>(r.base + ih * p.W + iw) * p.Ci + ci)));
}

__device__ __forceinline__ int4 load_b16(const Params& p, int co, int k) {
  if (co >= p.Co || k >= p.K) return make_int4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const int4*>(
      p.w + (static_cast<long long>(co) * p.K + k)));
}

__device__ __forceinline__ int8_t load_a1(const Params& p, const Row& r,
                                          int k) {
  if (!r.valid || k >= p.K) return 0;
  int tap = k / p.Ci;
  int ci = k - tap * p.Ci;
  int ih = r.ih0 + tap / p.ks;
  int iw = r.iw0 + tap % p.ks;
  if (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W) return 0;
  return p.x[static_cast<long long>(r.base + ih * p.W + iw) * p.Ci + ci];
}

__device__ __forceinline__ void store_out(const Params& p, int m, int co,
                                          int acc) {
  long long idx = static_cast<long long>(m) * p.Co + co;
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), p.factor[co]),
                      p.bias[co]);
  if (p.relu) y = fmaxf(y, 0.0f);
  if (p.res_kind == 1) {
    float r = static_cast<float>(static_cast<const int8_t*>(p.res)[idx]);
    y = __fadd_rn(y, __fmul_rn(r, p.res_scale[co]));
  } else if (p.res_kind == 2) {
    y = __fadd_rn(y, __bfloat162float(
                         static_cast<const __nv_bfloat16*>(p.res)[idx]));
  }
  if (p.out_kind == 0) {
    float q = rintf(__fdiv_rn(y, p.out_scale[co]));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    static_cast<int8_t*>(p.out)[idx] = static_cast<int8_t>(q);
  } else if (p.out_kind == 1) {
    static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(p.out)[idx] = y;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    s8_conv_kernel(const Params p) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  // Loader roles. VEC: rows ld_row and ld_row + 32 of each tile, 16 bytes
  // at column ld_col. Bytes: row tid/2, 32 bytes from column (tid&1)*32.
  const int ld_row = VEC ? (tid >> 2) : (tid >> 1);
  const int ld_col = VEC ? (tid & 3) * 16 : (tid & 1) * 32;
  Row ra = decode_row(p, m0 + ld_row);
  Row rb = decode_row(p, m0 + ld_row + 32);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (p.K + BK - 1) / BK;
  int4 pa0, pa1, pb0, pb1;
  if (VEC) {
    pa0 = load_a16(p, ra, ld_col);
    pa1 = load_a16(p, rb, ld_col);
    pb0 = load_b16(p, n0 + ld_row, ld_col);
    pb1 = load_b16(p, n0 + ld_row + 32, ld_col);
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * BK;
    if (VEC) {
      *reinterpret_cast<int4*>(&As[ld_row * LDS + ld_col]) = pa0;
      *reinterpret_cast<int4*>(&As[(ld_row + 32) * LDS + ld_col]) = pa1;
      *reinterpret_cast<int4*>(&Bs[ld_row * LDS + ld_col]) = pb0;
      *reinterpret_cast<int4*>(&Bs[(ld_row + 32) * LDS + ld_col]) = pb1;
    } else {
      const int co = n0 + ld_row;
      for (int j = 0; j < 32; ++j) {
        const int k = k0 + ld_col + j;
        As[ld_row * LDS + ld_col + j] = load_a1(p, ra, k);
        Bs[ld_row * LDS + ld_col + j] =
            (co < p.Co && k < p.K)
                ? p.w[static_cast<long long>(co) * p.K + k] : int8_t(0);
      }
    }
    __syncthreads();
    if (VEC && kt + 1 < ktiles) {  // the next slice's loads, in flight
      const int kn = k0 + BK + ld_col;
      pa0 = load_a16(p, ra, kn);
      pa1 = load_a16(p, rb, kn);
      pb0 = load_b16(p, n0 + ld_row, kn);
      pb1 = load_b16(p, n0 + ld_row + 32, kn);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* base = &As[(wm + mt * 16 + gid) * LDS + kk + tig * 4];
        a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* base = &Bs[(wn + nt * 8 + gid) * LDS + kk + tig * 4];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  // acc[mt][nt]: e = 0,1 at row gid, e = 2,3 at row gid + 8; column
  // tig*2 + (e & 1) of the n8 tile.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mt * 16 + gid + (e >> 1) * 8;
        const int co = n0 + wn + nt * 8 + tig * 2 + (e & 1);
        if (m < p.M && co < p.Co) store_out(p, m, co, acc[mt][nt][e]);
      }
}

}  // namespace

extern "C" int dpig_s8_conv(const void* x, const void* w,
                            const float* factor, const float* bias,
                            const void* res, int res_kind,
                            const float* res_scale, void* out, int out_kind,
                            const float* out_scale, int relu, int B, int H,
                            int W, int Ci, int Ho, int Wo, int Co, int ks,
                            int stride, int pad_t, int pad_l,
                            cudaStream_t stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
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
  dim3 grid((p.M + BM - 1) / BM, (Co + BN - 1) / BN);
  const bool vec = Ci % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec) {
    s8_conv_kernel<true><<<grid, THREADS, 0, stream>>>(p);
  } else {
    s8_conv_kernel<false><<<grid, THREADS, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
