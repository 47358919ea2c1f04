// s8 x s8 -> int32 convolution to a few output channels (Co < 8) with a
// requantizing epilogue, for Hopper (sm_90a): the int8 generator's
// `to_rgb`, 3x3 256 -> 3 channels.
//
// Replaces the same XLA code as csrc/s8_conv.cu (the JAX package's
// `jax.lax.conv_general_dilated(..., preferred_element_type=int32)` in
// dpig_tpu/models/quant.py, `_qconv_raw` :100, with `to_rgb`'s epilogue
// :456-461) and computes what s8_conv.cu computes, bit for bit: for NHWC
// s8 x [B,H,W,Ci], weights w [Co,k,k,Ci] (k = 1 or 3), stride 1 and SAME
// pads (pad_t, pad_l given),
//   acc = sum_{r,s,ci} x[b, oh-pad_t+r, ow-pad_l+s, ci] * w[co,r,s,ci]
//   y = acc*factor[co] + bias[co]; relu; + res*res_scale[co] (s8) or + res
//   (bf16); out = clip(rint(y/out_scale[co]), -127, 127) as s8, or bf16(y),
//   or y as float32,
// each float step one IEEE operation rounded to nearest even, in that
// order, never contracted into an FMA. The wrapper
// (dpig_tpu_torch/kernels/s8_conv.py, `plan`) sends a call here when the
// stride is 1, Co < 8, Ci % 16 == 0 and Ci <= 256.
//
// What bounds it on an H100: reading the input once. At the Market
// `to_rgb` (B=16, 128x64, Ci 256, float32 out) that is 33.5 MB against 1.6
// MB out and 1.8 GOP: 10.5 us at 3.35 TB/s. The older kernel (s8_conv.cu)
// padded N to 64 (61 of 64 columns zero) and gathered each input byte from
// global memory for each of the 9 taps. The design:
//
// - A block owns a strip of tw output columns (a multiple of 16, at most
//   64) of th consecutive output rows of one image (the wrapper's `plan`
//   picks th so the strips fill the SMs in as few waves as it can, with
//   little halo). It walks down the strip with a ring of k + 2 input rows
//   in shared memory: each row (its tw + k - 1 pixels, the SAME padding
//   as zeros) is copied once with 16-byte cp.async, two rows ahead of the
//   one the block computes, so the input crosses from L2 once, plus
//   (th + k - 1) / th for the halo rows.
// - N stays at 8, not 64: mma.sync m16n8k32 with Co of the 8 columns used
//   (3 at to_rgb). dp4a on the CUDA cores would do no padded work, but it
//   issues one instruction per 4 products of one output channel: 226 M
//   instructions at the Market shape, about 15 us on the 132 SMs, more
//   than the bound, where the 3-of-8 MMAs take about 5 us of tensor time.
// - Each input byte is read from shared memory once per kernel row, not
//   once per tap: warp w owns k32 chunk w (of ceil(Ci/32) <= 8; with
//   Ci % 32 == 16 the last chunk reads 16 bytes past a pixel's channels,
//   which meet zero weights) of every tap, its B fragments in registers
//   (loaded once per block). For each kernel row kr it loads
//   windows of 16 consecutive input pixels (one ldmatrix.x4 each) and
//   multiplies each by the k column taps' weights into k sums per window,
//   indexed by input pixel: D_kc[q] = x[q] . w[kr, kc]. The output pixel
//   o takes D_0[o] + D_1[o+1] + D_2[o+2], the shifted rows brought over by
//   warp shuffles (a window's last rows from the next window). So a row of
//   tw outputs costs ceil((tw + k - 1) / 16) loads of A per kernel row and
//   chunk where a load per tap and m16 tile would cost 3 times as many;
//   the MMAs grow by that window's overlap (5 windows against 4 at tw 64).
//   An input pixel is Ci bytes, padded by 16 where Ci/16 is even, so 8
//   consecutive pixels fall on 8 distinct bank groups.
// - The 8 warps' int32 partial sums of a row meet in shared memory; the
//   block adds them (exact) and runs the epilogue, one thread per output,
//   the row's tw*Co outputs contiguous in `out`.
// The largest |acc| is 127*127*9*256 < 2^31, so the padded K changes no
// sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int AHEAD = 2;  // input rows in flight ahead of the computed one
constexpr int MAX_MT = 4; // output m16 tiles per row: tw <= 64
// outputs of a row per thread: tw * Co <= 64 * 7 over THREADS
constexpr int OUTS = (16 * MAX_MT * 7 + THREADS - 1) / THREADS;

// One output of a row: its index in the row's tw * Co (-1: none), its
// offset in a warp's partial sums and its channel.
struct Out {
  int o, part, co;
};

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
  int B, H, W, Ci, Ho, Wo, Co, pad_t, pad_l;
  int th, tw;           // output rows and columns of a block's strip
  int ncb, nrb;         // column strips, row strips per image
  int hw;               // input pixels of a ring row: tw + k - 1
  int pitch;            // bytes of one input pixel in the ring
  int slot;             // bytes of one ring row
  int kst;              // k32 chunks of a pixel: ceil(Ci / 32)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows g + S and g + 8 + S of the 32 rows (x: an m16 tile's int32 sums
// by rows 0-15, xn: the next tile's) for this thread's g = gid, in the
// mma accumulator layout (e 0,1: row gid; e 2,3: row gid + 8).
template <int S>
__device__ __forceinline__ void shifted(const int (&x)[4], const int (&xn)[4],
                                        int gid, int (&y)[4]) {
  const int src = (threadIdx.x + 4 * S) & 31;  // gid + S mod 8, same tig
  const int a0 = __shfl_sync(0xffffffffu, x[0], src);
  const int a1 = __shfl_sync(0xffffffffu, x[1], src);
  const int a2 = __shfl_sync(0xffffffffu, x[2], src);
  const int a3 = __shfl_sync(0xffffffffu, x[3], src);
  const int n0 = __shfl_sync(0xffffffffu, xn[0], src);
  const int n1 = __shfl_sync(0xffffffffu, xn[1], src);
  const bool wrap = gid + S >= 8;
  y[0] = wrap ? a2 : a0;
  y[1] = wrap ? a3 : a1;
  y[2] = wrap ? n0 : a2;
  y[3] = wrap ? n1 : a3;
}

// cp.async of input row ih of image b, pixels ow0 - pad_l .. + hw - 1,
// into a ring slot; pixels in the SAME padding are written as zeros.
__device__ __forceinline__ void load_row(const Params& p, uint8_t* slot,
                                         int b, int ih, int ow0) {
  const int chunks = p.Ci >> 4;
  const bool row_ok = ih >= 0 && ih < p.H;
  const long long row = (static_cast<long long>(b) * p.H + ih) * p.W;
  for (int i = threadIdx.x; i < p.hw * chunks; i += THREADS) {
    const int hc = i / chunks, q = i - hc * chunks;
    const int iw = ow0 - p.pad_l + hc;
    const bool ok = row_ok && iw >= 0 && iw < p.W;
    const int8_t* src = ok ? p.x + (row + iw) * p.Ci + 16 * q : p.x;
    cp_async16(smem_u32(slot + hc * p.pitch + 16 * q), src, ok ? 16u : 0u);
  }
}

template <int KS>
__global__ void __launch_bounds__(THREADS, 2)
    s8_conv_narrow_co_kernel(const Params p) {
  constexpr int TAPS = KS * KS;
  constexpr int SLOTS = KS + AHEAD;
  constexpr int WIN = MAX_MT + (KS > 1);  // input windows of a row, at most
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  int* part = reinterpret_cast<int*>(smem + SLOTS * p.slot);  // [8][tw][8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  int t = blockIdx.x;
  const int ow0 = (t % p.ncb) * p.tw;
  t /= p.ncb;
  const int oh_begin = (t % p.nrb) * p.th;
  const int b = t / p.nrb;
  const int nrows = min(p.th, p.Ho - oh_begin);
  const int n_in = nrows + KS - 1;  // input rows oh_begin - pad_t + i
  const int ih0 = oh_begin - p.pad_t;

  // Rows 0 .. SLOTS-2 in flight while the weights load.
#pragma unroll
  for (int i = 0; i < SLOTS - 1; ++i) {
    if (i < n_in) load_row(p, ring + i * p.slot, b, ih0 + i, ow0);
    cp_async_commit();
  }

  // bf[tap] holds, for output channel gid, bytes tig*4..+3 (.x) and
  // 16 + tig*4..+3 (.y) of k32 chunk `warp` of the tap; zero past Co and
  // past Ci.
  uint32_t bf[TAPS][2];
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = warp * 32 + 16 * h + 4 * tig + e;
        if (gid < p.Co && ci < p.Ci) {
          v |= static_cast<uint32_t>(static_cast<uint8_t>(
                   p.w[(gid * TAPS + tap) * p.Ci + ci])) << (8 * e);
        }
      }
      bf[tap][h] = v;
    }

  // This thread's outputs of every row: o = tid + THREADS * u of the
  // row's valid columns times Co, its pixel's slot in `part`, its channel.
  Out outs[OUTS];
#pragma unroll
  for (int u = 0; u < OUTS; ++u) {
    const int o = tid + THREADS * u;
    const int px = o / p.Co, co = o - px * p.Co;
    outs[u].o = o < min(p.tw, p.Wo - ow0) * p.Co ? o : -1;
    outs[u].part = px * 8 + co;
    outs[u].co = co;
  }

  const int n_mt = p.tw >> 4;                  // output m16 tiles
  const int n_win = (p.tw + KS - 1 + 15) >> 4;  // input windows
  const uint32_t ring_s = smem_u32(ring);
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;
  for (int j = 0; j < nrows; ++j) {
    const int i = j + SLOTS - 1;
    if (i < n_in) {
      load_row(p, ring + (i % SLOTS) * p.slot, b, ih0 + i, ow0);
    }
    cp_async_commit();
    cp_async_wait<AHEAD>();
    __syncthreads();

    // d[m][kc]: input window m (pixels 16m .. 16m+15 of the ring row)
    // times column tap kc, summed over kernel rows, this warp's chunk
    int d[WIN][KS][4];
#pragma unroll
    for (int m = 0; m < WIN; ++m)
#pragma unroll
      for (int kc = 0; kc < KS; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[m][kc][e] = 0;
    if (warp < p.kst) {
#pragma unroll
      for (int kr = 0; kr < KS; ++kr) {
        const uint32_t base = ring_s + ((j + kr) % SLOTS) * p.slot +
                              warp * 32 + lhalf * 16 + lrow * p.pitch;
#pragma unroll
        for (int m = 0; m < WIN; ++m) {
          if (m < n_win) {
            uint32_t a[4];
            ldsm_x4(a, base + m * 16 * p.pitch);
#pragma unroll
            for (int kc = 0; kc < KS; ++kc) {
              mma_s8(d[m][kc], a, bf[kr * KS + kc][0], bf[kr * KS + kc][1]);
            }
          }
        }
      }
    }
    // output pixel 16m + row: d[m][0][row] + d[m][1][row + 1] +
    // d[m][2][row + 2]; e 0,1: row gid, e 2,3: row gid + 8, columns
    // 2*tig + (e & 1)
#pragma unroll
    for (int m = 0; m < MAX_MT; ++m) {
      if (m < n_mt) {
        int o[4] = {d[m][0][0], d[m][0][1], d[m][0][2], d[m][0][3]};
        if constexpr (KS == 3) {
          int s1[4], s2[4];
          shifted<1>(d[m][1], d[m + 1][1], gid, s1);
          shifted<2>(d[m][2], d[m + 1][2], gid, s2);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] += s1[e] + s2[e];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<int2*>(
              part + ((warp * p.tw + m * 16 + gid + 8 * h) << 3) +
              2 * tig) = make_int2(o[2 * h], o[2 * h + 1]);
        }
      }
    }
    __syncthreads();

    const long long m0 =
        (static_cast<long long>(b) * p.Ho + oh_begin + j) * p.Wo + ow0;
#pragma unroll
    for (int u = 0; u < OUTS; ++u) {
      const Out& q = outs[u];
      if (q.o < 0) continue;
      int sum = 0;
#pragma unroll
      for (int w8 = 0; w8 < WARPS; ++w8) sum += part[w8 * p.tw * 8 + q.part];
      const long long idx = m0 * p.Co + q.o;
      float y = __fadd_rn(__fmul_rn(__int2float_rn(sum), p.factor[q.co]),
                          p.bias[q.co]);
      if (p.relu) y = fmaxf(y, 0.0f);
      if (p.res_kind == 1) {
        const float r =
            static_cast<float>(static_cast<const int8_t*>(p.res)[idx]);
        y = __fadd_rn(y, __fmul_rn(r, p.res_scale[q.co]));
      } else if (p.res_kind == 2) {
        y = __fadd_rn(y, __bfloat162float(
                             static_cast<const __nv_bfloat16*>(p.res)[idx]));
      }
      if (p.out_kind == 0) {
        const float v = rintf(__fdiv_rn(y, p.out_scale[q.co]));
        static_cast<int8_t*>(p.out)[idx] =
            static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
      } else if (p.out_kind == 1) {
        static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(y);
      } else {
        static_cast<float*>(p.out)[idx] = y;
      }
    }
  }
  cp_async_wait<0>();
}

template <int KS>
int launch(const Params& p, int blocks, int smem, cudaStream_t stream) {
  static int attr = 0;  // the largest dynamic shared memory allowed so far
  if (smem > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        s8_conv_narrow_co_kernel<KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = smem;
  }
  s8_conv_narrow_co_kernel<KS><<<blocks, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `th` x `tw`: a block's strip of output rows and columns (tw a multiple
// of 16, at most 64), as kernels/s8_conv.py:plan gives it.
extern "C" int dpig_s8_conv_narrow_co(const void* x, const void* w,
                                      const float* factor, const float* bias,
                                      const void* res, int res_kind,
                                      const float* res_scale, void* out,
                                      int out_kind, const float* out_scale,
                                      int relu, int B, int H, int W, int Ci,
                                      int Ho, int Wo, int Co, int ks,
                                      int stride, int pad_t, int pad_l,
                                      int th, int tw, cudaStream_t stream) {
  Params p;
  p.kst = (Ci + 31) / 32;
  if (stride != 1 || (ks != 1 && ks != 3) || Ci < 16 || Ci % 16 != 0 ||
      p.kst > WARPS || Co < 1 || Co >= 8 || th < 1 || tw < 16 ||
      tw % 16 != 0 || tw > 16 * MAX_MT || Ho != H || Wo != W ||
      out_kind < 0 || out_kind > 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  p.pad_t = pad_t; p.pad_l = pad_l;
  p.th = th; p.tw = tw;
  p.ncb = (Wo + tw - 1) / tw;
  p.nrb = (Ho + th - 1) / th;
  p.hw = tw + ks - 1;
  // an odd number of 16-byte chunks per pixel: 8 consecutive pixels on 8
  // distinct bank groups
  p.pitch = (Ci / 16) % 2 ? Ci : Ci + 16;
  // + 16: with Ci % 32 == 16 the last chunk reads 16 bytes past the last
  // pixel
  p.slot = (p.hw * p.pitch + 16 + 127) / 128 * 128;
  // The last input window reads up to 16 * ceil(hw / 16) pixels, into the
  // next slot (or past the partial sums): rows that meet only outputs past
  // tw, so their bytes need only exist.
  const int overrun = ((p.hw + 15) / 16 * 16 - p.hw) * p.pitch;
  const int smem = (ks + AHEAD) * p.slot + WARPS * tw * 8 * 4 + overrun;
  const int blocks = B * p.nrb * p.ncb;
  return ks == 3 ? launch<3>(p, blocks, smem, stream)
                 : launch<1>(p, blocks, smem, stream);
}
