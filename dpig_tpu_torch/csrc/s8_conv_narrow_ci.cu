// s8 x s8 -> int32 convolution of a narrow input (Ci <= 32) with a
// requantizing epilogue, for Hopper (sm_90a): the int8 generator's pose
// stem, 3x3 18 -> 128 channels.
//
// Replaces the same XLA code as csrc/s8_conv.cu (the JAX package's
// `jax.lax.conv_general_dilated(..., preferred_element_type=int32)` in
// dpig_tpu/models/quant.py, `_qconv_raw` :100, with the int8 stem's
// epilogue :350-359) and computes what s8_conv.cu computes, bit for bit:
// for NHWC s8 x [B,H,W,Ci], weights w [Co,k,k,Ci] (k = 1 or 3), stride 1
// and SAME pads (pad_t, pad_l given),
//   acc = sum_{r,s,ci} x[b, oh-pad_t+r, ow-pad_l+s, ci] * w[co,r,s,ci]
//   y = acc*factor[co] + bias[co]; relu; + res*res_scale[co] (s8) or + res
//   (bf16); out = clip(rint(y/out_scale[co]), -127, 127) as s8, or bf16(y),
//   or y as float32,
// each float step one IEEE operation rounded to nearest even, in that
// order, never contracted into an FMA. The wrapper
// (dpig_tpu_torch/kernels/s8_conv.py, `plan`) sends a call here when the
// stride is 1, Ci <= 32 and 8 <= Co <= 256.
//
// What bounds it on an H100: the output. At the Market stem (B=16, 128x64,
// Co 128, float32 out) the kernel reads 2.4 MB and writes 67 MB, against
// 5.4 GOP of s8 work: the bound is the store at 3.35 TB/s (20.7 us). The
// older kernel (s8_conv.cu) gathered the 18-channel input byte by byte for
// each of the 9 taps and left in scattered 4-byte stores. The design:
//
// - A persistent grid (as many blocks as fit on the SMs) walks over output
//   tiles of th rows x tw columns (tw a multiple of 16, th*tw = 128 pixels,
//   64 where Co > 128) with all Co channels.
// - Stage the input once: the tile's input rows with their halo are
//   copied with 16-byte cp.async, as the aligned span of each NHWC row
//   ("raw", double-buffered: the next tile's rows are in flight while this
//   one computes), then laid out as a halo tile of 32 bytes per pixel, the
//   Ci channels zero-padded to 32, the SAME padding as zeros. A pixel's two
//   16-byte halves swap places where bit 2 of its column is set, so an
//   ldmatrix of 8 consecutive pixels hits 8 distinct bank groups.
// - K = taps x 32 (each tap's channels padded to 32): one mma.sync
//   m16n8k32 step per tap. The rows of an m16 tile are 16 consecutive
//   output pixels of one row, so a tap's A fragment is one ldmatrix.x4 of
//   16 consecutive halo pixels, shifted by the tap. A warp owns 32 output
//   channels and keeps their weights for every tap in registers (loaded
//   once per block: taps x 4 n8 tiles x 2 registers); ceil(Co/32) warps
//   cover Co, and max(1, 8/that) groups of them split the tile's pixels.
// - Write the output in full lines: each m16 tile's epilogue (per-channel
//   factor / bias / scales read once per block into shared memory) goes to
//   a staging tile in shared memory (rows padded so the fragment writes
//   spread over the banks), and the block copies it out with 16-byte
//   stores, each pixel's Co*4 bytes (512 at the stem) contiguous, where
//   Co times the element size is a multiple of 16 and `out` is 16-byte
//   aligned; element by element otherwise. (Bulk copies from a
//   double-buffered staging tile, which need tiles of half the size to
//   fit two blocks on an SM, ran slower on an H100: the smaller tile's
//   halo and barriers cost more than the copies saved.)
// What holds it below the bound (an H100, parts of the kernel cut out in
// turn): the MMAs with their A loads take about as long as the store
// bound (K padded from 18 to 32 per tap costs 16/9 of the work), and the
// tile's barriers let the two blocks of an SM overlap them with the
// stores only in part.
// The largest |acc| is 127*127*9*32 < 2^31, so the padded K changes no sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int PIX = 32;          // bytes of one pixel in the halo tile
constexpr int MAX_THREADS = 256;

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
  int th, tw;           // output tile rows and columns
  int ncb, nrb, tiles;  // column tiles, row tiles per image, all tiles
  int cw, wm;           // warps over Co (32 channels each), over pixels
  int hh, hw;           // halo tile rows th+k-1 and columns tw+k-1
  int raw_row;          // bytes of one raw input row in shared memory
  int pitch;            // bytes of one staged output pixel
  int vec;              // 16-byte copy-out
  long long xbytes;     // B*H*W*Ci
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

struct Tile {
  int b, oh0, ow0;
};

__device__ __forceinline__ Tile decode_tile(const Params& p, int t) {
  Tile tl;
  tl.ow0 = (t % p.ncb) * p.tw;
  t /= p.ncb;
  tl.oh0 = (t % p.nrb) * p.th;
  tl.b = t / p.nrb;
  return tl;
}

// Halo row hr of a tile in x: its first byte rounded down to 16 (x is
// 16-byte aligned) and its 16-byte chunk count, 0 for a row in the padding.
struct RawRow {
  long long lo;
  int n;
};

__device__ __forceinline__ RawRow raw_span(const Params& p, const Tile& tl,
                                           int hr) {
  RawRow r{0, 0};
  const int ih = tl.oh0 - p.pad_t + hr;
  const int c0 = max(tl.ow0 - p.pad_l, 0);
  const int c1 = min(tl.ow0 - p.pad_l + p.hw, p.W);
  if (ih < 0 || ih >= p.H || c0 >= c1) return r;
  const long long row = (static_cast<long long>(tl.b) * p.H + ih) * p.W;
  r.lo = ((row + c0) * p.Ci) & ~15LL;
  r.n = static_cast<int>(((row + c1) * p.Ci - r.lo + 15) >> 4);
  return r;
}

// cp.async of a tile's raw input rows into `dst` (hh rows of raw_row
// bytes); the chunk that ends past x's last byte reads only up to it.
__device__ __forceinline__ void load_raw(const Params& p, uint8_t* dst,
                                         int t) {
  const Tile tl = decode_tile(p, t);
  for (int hr = 0; hr < p.hh; ++hr) {
    const RawRow r = raw_span(p, tl, hr);
    for (int q = threadIdx.x; q < r.n; q += blockDim.x) {
      const long long off = r.lo + 16LL * q;
      const long long left = p.xbytes - off;
      cp_async16(smem_u32(dst + hr * p.raw_row + 16 * q), p.x + off,
                 left < 16 ? static_cast<uint32_t>(left) : 16u);
    }
  }
}

// The raw rows -> the halo tile: 32 bytes per pixel, channels past Ci and
// pixels in the SAME padding zero, the 16-byte halves of columns with bit
// 2 set swapped. One pixel per thread and step: 9 aligned words of the raw
// row funnel-shifted to the pixel's first byte (raw rows keep 48 bytes of
// slack for the overshoot).
__device__ __forceinline__ void expand(const Params& p, const uint8_t* raw,
                                       uint8_t* halo, int t) {
  const Tile tl = decode_tile(p, t);
  for (int i = threadIdx.x; i < p.hh * p.hw; i += blockDim.x) {
    const int hr = i / p.hw, hc = i - hr * p.hw;
    const int ih = tl.oh0 - p.pad_t + hr;
    const int iw = tl.ow0 - p.pad_l + hc;
    uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) {
      const int off = static_cast<int>(
          ((static_cast<long long>(tl.b) * p.H + ih) * p.W + iw) * p.Ci -
          raw_span(p, tl, hr).lo);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          raw + hr * p.raw_row + (off & ~3));
      const int sh = (off & 3) * 8;
      uint32_t w[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) w[k] = src[k];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int nb = p.Ci - 4 * k;  // valid bytes of word k
        const uint32_t word = __funnelshift_r(w[k], w[k + 1], sh);
        v[k] = nb >= 4 ? word
               : nb <= 0 ? 0u : word & ((1u << (8 * nb)) - 1u);
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(halo + i * PIX);
    const int swap = (hc >> 2) & 1;
    dst[swap] = make_uint4(v[0], v[1], v[2], v[3]);
    dst[swap ^ 1] = make_uint4(v[4], v[5], v[6], v[7]);
  }
}

// y = acc*factor + bias; relu; + the residual at `idx` (RES 1: s8 times
// rs, 2: bf16; idx < 0: outside the output), in the plain version's order,
// each step rounded once.
template <int RES>
__device__ __forceinline__ float finish(const Params& p, int acc, float f,
                                        float b, float rs, long long idx) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), f), b);
  if (p.relu) y = fmaxf(y, 0.0f);
  if (RES == 1 && idx >= 0) {
    const float r =
        static_cast<float>(static_cast<const int8_t*>(p.res)[idx]);
    y = __fadd_rn(y, __fmul_rn(r, rs));
  } else if (RES == 2 && idx >= 0) {
    y = __fadd_rn(y, __bfloat162float(
                         static_cast<const __nv_bfloat16*>(p.res)[idx]));
  }
  return y;
}

template <int OUT>
__device__ __forceinline__ void stage2(uint8_t* dst, float y0, float y1,
                                       float os0, float os1) {
  if (OUT == 0) {
    const float q0 = fminf(fmaxf(rintf(__fdiv_rn(y0, os0)), -127.0f), 127.0f);
    const float q1 = fminf(fmaxf(rintf(__fdiv_rn(y1, os1)), -127.0f), 127.0f);
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(
        static_cast<uint8_t>(static_cast<int8_t>(q0)) |
        (static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q1)))
         << 8));
  } else if (OUT == 1) {
    *reinterpret_cast<uint32_t*>(dst) =
        static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(y0))) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(y1)))
         << 16);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
  }
}

// The staged tile -> out: 16-byte chunks of each valid pixel's Co outputs
// (thread t copies chunk t % cpr of every (NT / cpr)-th pixel, stepping
// its row and column by adds), or element by element.
template <int OUT>
__device__ __forceinline__ void copy_out(const Params& p,
                                         const uint8_t* stage, int t) {
  constexpr int ELEM = OUT == 0 ? 1 : OUT == 1 ? 2 : 4;
  const Tile tl = decode_tile(p, t);
  const int row_bytes = p.Co * ELEM;
  uint8_t* out = static_cast<uint8_t*>(p.out);
  if (p.vec) {
    const int cpr = row_bytes >> 4;
    const int step = blockDim.x / cpr;
    const int q = threadIdx.x % cpr;
    int px = threadIdx.x / cpr;
    if (px >= step) return;
    int r = px / p.tw, c = px - r * p.tw;
    const int dr = step / p.tw, dc = step - dr * p.tw;
    while (r < p.th && tl.oh0 + r < p.Ho) {
      if (tl.ow0 + c < p.Wo) {
        const long long m =
            (static_cast<long long>(tl.b) * p.Ho + tl.oh0 + r) * p.Wo +
            tl.ow0 + c;
        *reinterpret_cast<uint4*>(out + m * row_bytes + 16 * q) =
            *reinterpret_cast<const uint4*>(stage + px * p.pitch + 16 * q);
      }
      px += step;
      r += dr;
      c += dc;
      if (c >= p.tw) {
        c -= p.tw;
        ++r;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < p.th * p.tw * p.Co; i += blockDim.x) {
    const int px = i / p.Co, co = i - px * p.Co;
    const int oh = tl.oh0 + px / p.tw, ow = tl.ow0 + px % p.tw;
    if (oh >= p.Ho || ow >= p.Wo) continue;
    const long long m = (static_cast<long long>(tl.b) * p.Ho + oh) * p.Wo
                        + ow;
    const uint8_t* s = stage + px * p.pitch + co * ELEM;
    uint8_t* d = out + (m * p.Co + co) * ELEM;
    if (ELEM == 1) *d = *s;
    else if (ELEM == 2) *reinterpret_cast<uint16_t*>(d) =
        *reinterpret_cast<const uint16_t*>(s);
    else *reinterpret_cast<float*>(d) = *reinterpret_cast<const float*>(s);
  }
}

template <int KS, int OUT, int RES>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    s8_conv_narrow_ci_kernel(const Params p) {
  constexpr int TAPS = KS * KS;
  constexpr int ELEM = OUT == 0 ? 1 : OUT == 1 ? 2 : 4;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* stage = smem;
  uint8_t* halo = stage + p.th * p.tw * p.pitch;
  uint8_t* raw = halo + p.hh * p.hw * PIX;
  float* prm = reinterpret_cast<float*>(raw + 2 * p.hh * p.raw_row);
  const int ncp = p.cw * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wc = warp % p.cw, wr = warp / p.cw;
  const int gid = lane >> 2, tig = lane & 3;

  // The first tile's input is in flight while the weights load.
  if (blockIdx.x < p.tiles) load_raw(p, raw, blockIdx.x);
  cp_async_commit();

  for (int i = tid; i < ncp; i += blockDim.x) {
    const bool ok = i < p.Co;
    prm[i] = ok ? p.factor[i] : 0.0f;
    prm[ncp + i] = ok ? p.bias[i] : 0.0f;
    prm[2 * ncp + i] = ok && p.res_kind == 1 ? p.res_scale[i] : 0.0f;
    prm[3 * ncp + i] = ok && OUT == 0 ? p.out_scale[i] : 1.0f;
  }
  // This warp's B fragments for every tap: b[t][j] holds, for output
  // channel wc*32 + 8j + gid, channels tig*4..+3 (.x) and 16 + tig*4..+3
  // (.y) of tap t; zero past Co and Ci.
  uint32_t b[TAPS][4][2];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = wc * 32 + 8 * j + gid;
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = 16 * h + 4 * tig + e;
          if (co < p.Co && ci < p.Ci) {
            v |= static_cast<uint32_t>(static_cast<uint8_t>(
                     p.w[(co * TAPS + t) * p.Ci + ci])) << (8 * e);
          }
        }
        b[t][j][h] = v;
      }

  const int mt_per_row = p.tw >> 4;
  const int n_mt = p.th * mt_per_row;
  const uint32_t halo_s = smem_u32(halo);
  // ldmatrix row of this lane: m16 row (lane & 7) + 8 * bit 3 of the
  // lane, 16-byte half bit 4 of the lane.
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhalf = lane >> 4;
  int buf = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, buf ^= 1) {
    const int next = t + gridDim.x;
    if (next < p.tiles) load_raw(p, raw + (buf ^ 1) * p.hh * p.raw_row, next);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    expand(p, raw + buf * p.hh * p.raw_row, halo, t);
    __syncthreads();

    const Tile tl = decode_tile(p, t);
    for (int mt = wr; mt < n_mt; mt += p.wm) {
      const int r = mt / mt_per_row, c0 = (mt % mt_per_row) * 16;
      if (tl.oh0 + r >= p.Ho || tl.ow0 + c0 >= p.Wo) continue;
      int acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
      for (int t9 = 0; t9 < TAPS; ++t9) {
        const int hc = c0 + lrow + t9 % KS;
        uint32_t a[4];
        ldsm_x4(a, halo_s + ((r + t9 / KS) * p.hw + hc) * PIX +
                       ((lhalf ^ ((hc >> 2) & 1)) << 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[j], a, b[t9][j][0],
                                           b[t9][j][1]);
      }
      // acc[j][e]: m16 row gid + 8 * (e >> 1), channel wc*32 + 8j + 2*tig
      // + (e & 1).
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wc * 32 + 8 * j + 2 * tig;
        const float2 f = *reinterpret_cast<const float2*>(prm + col);
        const float2 bb = *reinterpret_cast<const float2*>(prm + ncp + col);
        const float2 rs =
            RES == 1 ? *reinterpret_cast<const float2*>(prm + 2 * ncp + col)
                     : make_float2(0.0f, 0.0f);
        const float2 os =
            OUT == 0 ? *reinterpret_cast<const float2*>(prm + 3 * ncp + col)
                     : make_float2(1.0f, 1.0f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = r * p.tw + c0 + gid + 8 * h;
          const int ow = tl.ow0 + c0 + gid + 8 * h;
          long long i0 = -1, i1 = -1;
          if (RES != 0 && ow < p.Wo) {
            const long long m =
                (static_cast<long long>(tl.b) * p.Ho + tl.oh0 + r) * p.Wo +
                ow;
            if (col < p.Co) i0 = m * p.Co + col;
            if (col + 1 < p.Co) i1 = m * p.Co + col + 1;
          }
          const float y0 =
              finish<RES>(p, acc[j][2 * h], f.x, bb.x, rs.x, i0);
          const float y1 =
              finish<RES>(p, acc[j][2 * h + 1], f.y, bb.y, rs.y, i1);
          stage2<OUT>(stage + px * p.pitch + col * ELEM, y0, y1, os.x, os.y);
        }
      }
    }
    __syncthreads();
    copy_out<OUT>(p, stage, t);
  }
  cp_async_wait<0>();
}

// The persistent grid's size, as many blocks as fit on the SMs: found
// once for each device, block size and shared memory size, and kept.
template <int KS, int OUT, int RES>
cudaError_t grid_cap(int threads, int smem, int* cap) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> caps;  // (dev, thr, smem)
  static std::map<int, int> attr;  // dev -> the largest smem allowed so far
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, threads, smem);
  const auto it = caps.find(key);
  if (it != caps.end()) {
    *cap = it->second;
    return cudaSuccess;
  }
  if (smem > attr[dev]) {
    e = cudaFuncSetAttribute(s8_conv_narrow_ci_kernel<KS, OUT, RES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    attr[dev] = smem;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, s8_conv_narrow_ci_kernel<KS, OUT, RES>, threads, smem);
  }
  if (e != cudaSuccess) return e;
  *cap = caps[key] = std::max(1, per_sm) * sms;
  return cudaSuccess;
}

template <int KS, int OUT, int RES>
int launch(const Params& p, int threads, int smem, cudaStream_t stream) {
  int cap = 0;
  const cudaError_t e = grid_cap<KS, OUT, RES>(threads, smem, &cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = std::min(p.tiles, cap);
  s8_conv_narrow_ci_kernel<KS, OUT, RES><<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int KS, int OUT>
int launch_res(const Params& p, int threads, int smem, cudaStream_t stream) {
  if (p.res_kind == 1) return launch<KS, OUT, 1>(p, threads, smem, stream);
  if (p.res_kind == 2) return launch<KS, OUT, 2>(p, threads, smem, stream);
  return launch<KS, OUT, 0>(p, threads, smem, stream);
}

template <int KS>
int launch_out(const Params& p, int threads, int smem, cudaStream_t stream) {
  if (p.out_kind == 0) return launch_res<KS, 0>(p, threads, smem, stream);
  if (p.out_kind == 1) return launch_res<KS, 1>(p, threads, smem, stream);
  return launch_res<KS, 2>(p, threads, smem, stream);
}

}  // namespace

// `th` x `tw`: the output tile (tw a multiple of 16), as
// kernels/s8_conv.py:plan gives it.
extern "C" int dpig_s8_conv_narrow_ci(const void* x, const void* w,
                                      const float* factor, const float* bias,
                                      const void* res, int res_kind,
                                      const float* res_scale, void* out,
                                      int out_kind, const float* out_scale,
                                      int relu, int B, int H, int W, int Ci,
                                      int Ho, int Wo, int Co, int ks,
                                      int stride, int pad_t, int pad_l,
                                      int th, int tw, cudaStream_t stream) {
  if (stride != 1 || (ks != 1 && ks != 3) || Ci < 1 || Ci > PIX || Co < 1 ||
      Co > 256 || th < 1 || tw < 16 || tw % 16 != 0 || Ho != H ||
      Wo != W || out_kind < 0 || out_kind > 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  p.pad_t = pad_t; p.pad_l = pad_l;
  p.th = th; p.tw = tw;
  p.ncb = (Wo + tw - 1) / tw;
  p.nrb = (Ho + th - 1) / th;
  p.tiles = B * p.nrb * p.ncb;
  p.cw = (Co + 31) / 32;
  p.wm = std::max(1, 8 / p.cw);
  p.hh = th + ks - 1;
  p.hw = tw + ks - 1;
  // the span's 16-byte chunks, plus 48 bytes that expand reads past it
  p.raw_row = (p.hw * Ci + 15 + 48 + 15) / 16 * 16;
  const int elem = out_kind == 0 ? 1 : out_kind == 1 ? 2 : 4;
  // 8 (f32) or 4 words of padding: a warp's fragment writes of 8 rows
  // land on distinct banks
  p.pitch = (Co * elem + 127) / 128 * 128 + (out_kind == 2 ? 32 : 16);
  p.vec = (Co * elem) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  p.xbytes = static_cast<long long>(B) * H * W * Ci;
  const int threads = 32 * p.cw * p.wm;
  const int smem = th * tw * p.pitch + p.hh * p.hw * PIX +
                   2 * p.hh * p.raw_row + 4 * p.cw * 32 * 4;
  return ks == 3 ? launch_out<3>(p, threads, smem, stream)
                 : launch_out<1>(p, threads, smem, stream);
}
