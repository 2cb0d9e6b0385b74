// 3x3 stride-1 SAME convolution over NHWC bf16 maps, for Hopper (sm_90a).
//
// Replaces uce_tpu/ops/pallas/conv3x3.py::conv3x3 (_kernel). It is an
// implicit GEMM: M = B*H*W output pixels, N = Cout, K = 9*Cin, with the
// weights packed as [Cout, 3, 3, Cin] (a K-contiguous row per output
// channel, the column-major B operand of mma.sync) and fp32 accumulation on
// mma.sync m16n8k16 bf16, as sd_attention.cu does. The bias is added in the
// fp32 epilogue, before the one rounding to bf16.
//
// The TPU kernel pre-pads x in HBM because a BlockSpec cannot express
// overlapping halos; here each block computes its own im2col addresses and
// writes zeros for taps that fall outside the map, so x is never padded or
// copied. Ragged edges (M, Cout or K not a multiple of the tile) are masked
// in the loads and the stores. Cin % 8 == 0 takes 16-byte vector loads; any
// other Cin (4 for the latent convs) takes an element-wise loader.
//
// Design: 128 x 128 output tile per block of 8 warps (2 x 4), each warp a
// 64 x 32 sub-tile of 4 x 4 mma tiles; K in steps of 32 through two
// shared-memory buffers, the next step's global loads issued into registers
// before the current step's MMAs (one __syncthreads per step).
//
// What bounds it: tensor-core work. At [4, 64, 64, 320] -> 320 it is
// 2 * 16384 * 320 * 2880 = 30.2 GFLOP (31 us at 989 TFLOP/s) against 21 MB
// of traffic. This kernel issues synchronous loads and mma.sync from
// shared memory without ldmatrix; wgmma fed by TMA is the lever for a
// faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
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

}  // namespace

// x [b, h, w, cin], w [cout, 3, 3, cin], bias [cout] or null, y [b, h, w,
// cout], all bf16 and contiguous. Returns a cudaError_t value (0 on success).
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
    conv3x3_kernel<true><<<grid, kThreads, 0, st>>>(xp, wp, bp, yp, s);
  else
    conv3x3_kernel<false><<<grid, kThreads, 0, st>>>(xp, wp, bp, yp, s);
  return (int)cudaGetLastError();
}
