// 3x3 stride-1 SAME convolution over NHWC bf16 maps, for Hopper (sm_90a).
//
// Replaces uce_tpu/ops/pallas/conv3x3.py::conv3x3 (_kernel :28, called at
// :91). Both kernels here are implicit GEMMs: M = output pixels, N = Cout,
// K = 9 taps x Cin, with the weights packed as [Cout, 3, 3, Cin] (a
// K-contiguous row per output channel) and fp32 accumulation; the bias is
// added in fp32 before the one rounding to bf16. The TPU kernel pads x in
// HBM because a BlockSpec cannot express overlapping halos; neither kernel
// here pads or copies x.
//
// What bounds it on this card: tensor-core work. At [4, 64, 64, 320] -> 320
// it is 2 * 16384 * 320 * 2880 = 30.2 GFLOP (31 us at 989 TFLOP/s) against
// 21 MB of traffic. The UNet's deep levels have few output tiles (at batch
// 4 the 8x8 level has 2 M tiles of 128 pixels for a K of 9 * 2560), so
// there the card is filled only by splitting K.
//
// conv3x3_wgmma_kernel (Cin % 64 == 0: every 3x3 conv of the SD UNet and
// VAE but the two latent-input ones):
//  - One block per (rectangle of 128 output pixels, BN output channels, K
//    split): one producer warp issuing TMA loads into a ring of stages with
//    "full" and "empty" mbarriers, two consumer warpgroups each running
//    wgmma m64n{BN}k16 on 64 of the pixels, both operands K-major with the
//    128-byte swizzle. A K step is one tap and 64 input channels.
//  - The A operand (im2col) is one 4-D TMA box [nb, TH, TW, 64] of x
//    [B, H, W, Cin] at (b0, oy0 + ky - 1, ox0 + kx - 1, c0): TMA writes
//    zeros for coordinates outside the map, which is SAME padding. The
//    rectangle is 2 x 64 pixels at W = 64, 8 x 16 at 16 x 16, and spans two
//    images at 8 x 8 (nb = 2), so M always fills 128 rows.
//  - The B operand is a 2-D box [BN, 64] of the packed weights, rows past
//    Cout zero-filled; its tensor map is encoded once per weight tensor by
//    the wrapper (conv3x3_weight_map).
//  - Split-K: when the output tiles do not fill the card, blocks of one
//    tile take disjoint ranges of K steps (ops/kernels/conv3x3.py::plan)
//    and write fp32 partial sums to a workspace; split_reduce_kernel sums
//    them in split order, adds the bias in fp32 and rounds once. No
//    atomics: the result is the same on every run.
//
// conv3x3_mma_kernel (any Cin; the latent convs, Cin = 4): 128 x 128 output
// tile per block of 8 warps on mma.sync m16n8k16, the im2col gathered by
// the threads with zeros for taps outside the map (an element-wise loader
// unless Cin % 8 == 0), K in steps of 32 through two shared buffers.

#include <string.h>

#include "hopper.cuh"

namespace {

// ---- mma.sync kernel (any Cin) --------------------------------------------
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;
constexpr int LDS = BK + 8;  // shared row stride in bf16 (80 bytes: no bank conflicts)
constexpr int kSlots = BM * BK / 8 / kThreads;  // 16-byte vectors per thread per operand

struct Shape {
  int h, w, cin, cout, m, k;
};

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Element of x at output pixel m's tap for im2col column kk (bf16 bits),
// 0 outside the map.
__device__ __forceinline__ uint32_t x_elem(const uint16_t* x, const Shape& s,
                                           int b, int oy, int ox, int kk) {
  if (kk >= s.k) return 0;
  const int tap = kk / s.cin, ci = kk % s.cin;
  const int iy = oy + tap / 3 - 1, ix = ox + tap % 3 - 1;
  if (iy < 0 || iy >= s.h || ix < 0 || ix >= s.w) return 0;
  return x[(((size_t)b * s.h + iy) * s.w + ix) * s.cin + ci];
}

// 8 consecutive im2col columns [kk, kk + 8) of output pixel m.
template <bool kVec>
__device__ __forceinline__ uint4 load_a(const __nv_bfloat16* x, const Shape& s,
                                        int m, int kk) {
  uint4 out = make_uint4(0, 0, 0, 0);
  if (m >= s.m) return out;
  const int ox = m % s.w, t = m / s.w;
  const int oy = t % s.h, b = t / s.h;
  if constexpr (kVec) {  // cin % 8 == 0: one tap, 8 channels, 16 bytes
    if (kk >= s.k) return out;
    const int tap = kk / s.cin, ci = kk % s.cin;
    const int iy = oy + tap / 3 - 1, ix = ox + tap % 3 - 1;
    if (iy < 0 || iy >= s.h || ix < 0 || ix >= s.w) return out;
    return *reinterpret_cast<const uint4*>(
        x + (((size_t)b * s.h + iy) * s.w + ix) * s.cin + ci);
  } else {
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = x_elem(xs, s, b, oy, ox, kk + j);
    out.x = v[0] | (v[1] << 16);
    out.y = v[2] | (v[3] << 16);
    out.z = v[4] | (v[5] << 16);
    out.w = v[6] | (v[7] << 16);
    return out;
  }
}

// Weights [n][kk, kk + 8) of the packed [Cout, K] matrix.
template <bool kVec>
__device__ __forceinline__ uint4 load_b(const __nv_bfloat16* w, const Shape& s,
                                        int n, int kk) {
  uint4 out = make_uint4(0, 0, 0, 0);
  if (n >= s.cout) return out;
  if constexpr (kVec) {  // K % 8 == 0: rows stay 16-byte aligned
    if (kk >= s.k) return out;
    return *reinterpret_cast<const uint4*>(w + (size_t)n * s.k + kk);
  } else {
    const uint16_t* ws = reinterpret_cast<const uint16_t*>(w) + (size_t)n * s.k;
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = kk + j < s.k ? ws[kk + j] : 0u;
    out.x = v[0] | (v[1] << 16);
    out.y = v[2] | (v[3] << 16);
    out.z = v[4] | (v[5] << 16);
    out.w = v[6] | (v[7] << 16);
    return out;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* y, const Shape& s,
                                           int row, int col, float v0, float v1) {
  if (row >= s.m) return;
  __nv_bfloat16* p = y + (size_t)row * s.cout + col;
  if (col + 1 < s.cout && (s.cout & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < s.cout) p[0] = __float2bfloat16(v0);
    if (col + 1 < s.cout) p[1] = __float2bfloat16(v1);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const __nv_bfloat16* __restrict__ bias,
               __nv_bfloat16* __restrict__ y, Shape s) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 sB[2][BN * LDS];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  uint4 ra[kSlots], rb[kSlots];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int slot = threadIdx.x + i * kThreads;
      const int r = slot / (BK / 8), kc = (slot % (BK / 8)) * 8;
      ra[i] = load_a<kVec>(x, s, m0 + r, k0 + kc);
      rb[i] = load_b<kVec>(w, s, n0 + r, k0 + kc);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int slot = threadIdx.x + i * kThreads;
      const int r = slot / (BK / 8), kc = (slot % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&sA[buf][r * LDS + kc]) = ra[i];
      *reinterpret_cast<uint4*>(&sB[buf][r * LDS + kc]) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  const int ktiles = (s.k + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) fetch((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* base = &sA[buf][(wm + mi * 16) * LDS + ks + t4 * 2];
        a[mi][0] = ld_u32(base + g * LDS);
        a[mi][1] = ld_u32(base + (g + 8) * LDS);
        a[mi][2] = ld_u32(base + g * LDS + 8);
        a[mi][3] = ld_u32(base + (g + 8) * LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* base = &sB[buf][(wn + ni * 8 + g) * LDS + ks + t4 * 2];
        b[ni][0] = ld_u32(base);
        b[ni][1] = ld_u32(base + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    if (kt + 1 < ktiles) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + t4 * 2;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (col < s.cout) b0 = __bfloat162float(bias[col]);
      if (col + 1 < s.cout) b1 = __bfloat162float(bias[col + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = m0 + wm + mi * 16 + g;
      store_pair(y, s, row, col, acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
      store_pair(y, s, row + 8, col, acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
    }
  }
}


// ---- TMA + wgmma kernel (Cin % 64 == 0) ------------------------------------

constexpr int kWRows = 128;                  // output pixels per block
constexpr int kWConsumerWarps = 8;           // two warpgroups
constexpr int kWThreads = kWConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kWLine = 128;                  // bytes of one swizzled line
constexpr int kABytes = kWRows * kWLine;     // A tile of one K step (16 KB)
constexpr int kReduceThreads = 256;

template <int TN>
struct WCfg {
  static constexpr int kStageBytes = kABytes + TN * kWLine;
  static constexpr int kFit = 200 * 1024 / kStageBytes;
  static constexpr int kStages = kFit > 6 ? 6 : kFit;
  static constexpr int kSmem = kStages * kStageBytes + 1024;
};

struct WShape {
  int b, h, w, cin, cout;
  int nb, th, tw;           // the output rectangle of a block (nb * th * tw = 128)
  int tiles_x, tiles_y;     // rectangles along W and H
  int ksteps, per;          // K steps (9 * Cin / 64) and K steps per split
};

__device__ __forceinline__ void store_out(__nv_bfloat16* y, int cout, size_t pix,
                                          int col, float v0, float v1) {
  __nv_bfloat16* p = y + pix * cout + col;
  if (col + 1 < cout && (cout & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < cout) p[0] = __float2bfloat16(v0);
    if (col + 1 < cout) p[1] = __float2bfloat16(v1);
  }
}

__device__ __forceinline__ void store_part(float* ws, int cout, size_t pix, int col,
                                           float v0, float v1) {
  float* p = ws + pix * cout + col;
  if (col + 1 < cout && (cout & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < cout) p[0] = v0;
    if (col + 1 < cout) p[1] = v1;
  }
}

// grid (rectangles, ceil(Cout / TN), splits). ws == nullptr: bf16 output
// with the bias; else fp32 partial sums of split blockIdx.z into ws
// [splits, B*H*W, Cout].
template <int TN>
__global__ void __launch_bounds__(kWThreads, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                     WShape s) {
  using C = WCfg<TN>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto a_tile = [&](int st) { return base + st * C::kStageBytes; };
  auto b_tile = [&](int st) { return a_tile(st) + kABytes; };

  const int xt = blockIdx.x % s.tiles_x;
  const int yt = (blockIdx.x / s.tiles_x) % s.tiles_y;
  const int bt = blockIdx.x / (s.tiles_x * s.tiles_y);
  const int ox0 = xt * s.tw, oy0 = yt * s.th, b0 = bt * s.nb;
  const int n0 = blockIdx.y * TN;
  const int ks0 = blockIdx.z * s.per;
  const int n = min(s.ksteps, ks0 + s.per) - ks0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kWConsumerWarps) {  // producer
    if (lane == 0) {
      const int chunks = s.cin / 64;
      for (int t = 0; t < n; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + st, (t / kStages - 1) & 1);
        mbar_expect_tx(full + st, C::kStageBytes);
        const int ks = ks0 + t, tap = ks / chunks, c0 = (ks % chunks) * 64;
        tma_load_4d(a_tile(st), &map_x, c0, ox0 + tap % 3 - 1, oy0 + tap / 3 - 1, b0,
                    full + st);
        tma_load_2d(b_tile(st), &map_w, tap * s.cin + c0, n0, full + st);
      }
    }
    return;
  }

  // Consumer warpgroup wg: pixels [64 wg, 64 wg + 64) of the rectangle.
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < n; ++t) {
    const int st = t % kStages;
    mbar_wait(full + st, (t / kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(acc, desc_sw128(a_tile(st) + wg * 64 * kWLine + kk * 32, 16, 1024),
               desc_sw128(b_tile(st) + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // step t - 1's products are done: free its stage
    if (t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % kStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Rows 16 wq + g (+ 8) of this warpgroup's 64; columns 8 j + 2 t4 (+ 1).
  const size_t m = (size_t)s.b * s.h * s.w;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + wq * 16 + g + h * 8;
    const int bi = r / (s.th * s.tw), yi = (r / s.tw) % s.th, xi = r % s.tw;
    const int bb = b0 + bi, yy = oy0 + yi, xx = ox0 + xi;
    if (bb >= s.b || yy >= s.h || xx >= s.w) continue;
    const size_t pix = ((size_t)bb * s.h + yy) * s.w + xx;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + j * 8 + t4 * 2;
      if (col >= s.cout) continue;
      float v0 = acc[j * 4 + h * 2], v1 = acc[j * 4 + h * 2 + 1];
      if (ws != nullptr) {
        store_part(ws + blockIdx.z * m * s.cout, s.cout, pix, col, v0, v1);
      } else {
        if (bias != nullptr) {
          v0 += __bfloat162float(bias[col]);
          if (col + 1 < s.cout) v1 += __bfloat162float(bias[col + 1]);
        }
        store_out(y, s.cout, pix, col, v0, v1);
      }
    }
  }
}

// y[i] = bf16(sum_z ws[z][i] + bias[i % cout]), the splits summed in order.
__global__ void __launch_bounds__(kReduceThreads)
split_reduce_kernel(const float* __restrict__ ws, const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, size_t total, int cout, int splits) {
  for (size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kReduceThreads) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += ws[z * total + i];
    if (bias != nullptr) acc += __bfloat162float(bias[i % cout]);
    y[i] = __float2bfloat16(acc);
  }
}

template <int TN>
int launch_wgmma(const CUtensorMap& mx, const CUtensorMap& mw, const void* bias,
                 void* y, void* ws, const WShape& s, int splits, cudaStream_t stream) {
  using C = WCfg<TN>;
  static unsigned sized = 0;
  const int err = set_smem_once(conv3x3_wgmma_kernel<TN>, C::kSmem, sized);
  if (err != 0) return err;
  const int rects = s.tiles_x * s.tiles_y * ((s.b + s.nb - 1) / s.nb);
  const dim3 grid(rects, (s.cout + TN - 1) / TN, splits);
  conv3x3_wgmma_kernel<TN><<<grid, kWThreads, C::kSmem, stream>>>(
      mx, mw, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y),
      splits > 1 ? static_cast<float*>(ws) : nullptr, s);
  return (int)cudaGetLastError();
}

}  // namespace

static_assert(sizeof(CUtensorMap) == 128, "tensor maps are 128 bytes");

// The tensor map of packed weights w [cout, 9 * cin] bf16 for bn-row boxes,
// written to `map` (128 bytes of host memory). Returns a cudaError_t value.
extern "C" int conv3x3_weight_map(void* map, const void* w, int cout, int cin, int bn) {
  const cuuint64_t dims[2] = {(cuuint64_t)9 * cin, (cuuint64_t)cout};
  const cuuint64_t strides[1] = {(cuuint64_t)9 * cin * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)bn};
  return encode_map(static_cast<CUtensorMap*>(map), w, 2, dims, strides, box);
}

// The wgmma kernel: x [b, h, w, cin] bf16 (cin % 64 == 0), wmap from
// conv3x3_weight_map with the same bn, bias [cout] bf16 or null; the output
// rectangle nb x th x tw (= 128 pixels); `per` K steps per split. splits ==
// 1: y [b, h, w, cout] bf16; else ws [splits, b*h*w, cout] fp32 partial
// sums (no bias) for conv3x3_split_reduce. Returns a cudaError_t value,
// -1 for an unsupported bn.
extern "C" int conv3x3_wgmma(const void* x, const void* wmap, const void* bias, void* y,
                             void* ws, int b, int h, int wd, int cin, int cout, int bn,
                             int nb, int th, int tw, int per, int splits, void* stream) {
  CUtensorMap mx, mw;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)wd, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)wd * cin * 2,
                                 (cuuint64_t)h * wd * cin * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)tw, (cuuint32_t)th, (cuuint32_t)nb};
  const int err = encode_map(&mx, x, 4, dims, strides, box);
  if (err != 0) return err;
  memcpy(&mw, wmap, sizeof(mw));
  const WShape s{b, h, wd, cin, cout, nb, th, tw, (wd + tw - 1) / tw, (h + th - 1) / th,
                 9 * cin / 64, per};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return launch_wgmma<64>(mx, mw, bias, y, ws, s, splits, st);
    case 128: return launch_wgmma<128>(mx, mw, bias, y, ws, s, splits, st);
    case 160: return launch_wgmma<160>(mx, mw, bias, y, ws, s, splits, st);
    default: return -1;
  }
}

// y [total] bf16 = the sum over `splits` of ws [splits, total] fp32, plus
// bias[i % cout] (bias may be null). Returns a cudaError_t value.
extern "C" int conv3x3_split_reduce(const void* ws, const void* bias, void* y,
                                    long long total, int cout, int splits,
                                    void* stream) {
  const long long blocks = (total + kReduceThreads - 1) / kReduceThreads;
  split_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kReduceThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), (size_t)total, cout, splits);
  return (int)cudaGetLastError();
}

// The mma.sync kernel: x [b, h, w, cin], w [cout, 3, 3, cin], bias [cout]
// or null, y [b, h, w, cout], all bf16 and contiguous. Returns a
// cudaError_t value (0 on success).
extern "C" int conv3x3_bf16(const void* x, const void* w, const void* bias, void* y,
                            int b, int h, int wd, int cin, int cout, void* stream) {
  const Shape s{h, wd, cin, cout, b * h * wd, 9 * cin};
  const dim3 grid((s.m + BM - 1) / BM, (cout + BN - 1) / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const __nv_bfloat16*>(bias);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (cin % 8 == 0)
    conv3x3_mma_kernel<true><<<grid, kThreads, 0, st>>>(xp, wp, bp, yp, s);
  else
    conv3x3_mma_kernel<false><<<grid, kThreads, 0, st>>>(xp, wp, bp, yp, s);
  return (int)cudaGetLastError();
}
