// GroupNorm (+ optional SiLU) over NHWC bf16 maps, for Hopper (sm_90a).
//
// Replaces uce_tpu/ops/pallas/group_norm.py::group_norm_act (_stats_kernel
// and _apply_kernel). It computes what the TPU kernels compute, with the
// same one-pass statistics: per-channel sums of x and x^2 in fp32, folded
// into group mean and rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps), then
// into per-channel gamma/beta [B, 2, C]; the apply is y = x * gamma + beta,
// followed by SiLU when asked.
//
// The TPU carries the channel sums across row tiles in VMEM scratch because
// its grid runs in order. Hopper blocks run in parallel and in no order, so
// the statistics take two kernels: gn_partial_kernel writes one fp32 partial
// sum per (batch, row tile, channel) to a workspace the wrapper allocates,
// and gn_fold_kernel reduces one group's partials (over its channels and all
// row tiles) in a fixed order and writes gamma/beta. No float atomics: the
// result repeats bit for bit from run to run. gn_apply_kernel then streams
// x once more.
//
// What bounds it: memory. x is read twice and y written once (the floor of
// any two-pass normalisation, as on the TPU); the partials add 2 * 4 bytes
// per channel and row tile (about 8% of x with the wrapper's 32 KB tiles).
// Every load and store of x and y moves 16 bytes (8 channels) per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kVec = 8;  // bf16 channels per 16-byte access
constexpr int kFoldThreads = 256;
constexpr int kApplyThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffff, v, off);
  return v;
}

// Block (tile, b) of blockDim = (c / 8) * row_lanes threads: thread
// (lane_row, cv) sums channels [8 cv, 8 cv + 8) over rows r0 + lane_row,
// r0 + lane_row + row_lanes, ... of the tile; the lanes are then added in
// shared memory and the block writes ws[b][tile][0|1][c].
__global__ void gn_partial_kernel(const __nv_bfloat16* __restrict__ x,
                                  float* __restrict__ ws, int hw, int c,
                                  int rows_per_tile, int row_lanes) {
  extern __shared__ float red[];  // [2][row_lanes][c]
  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int ncv = c / kVec;
  const int cv = threadIdx.x % ncv, lane_row = threadIdx.x / ncv;
  const int r0 = tile * rows_per_tile, r1 = min(hw, r0 + rows_per_tile);
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
  const __nv_bfloat16* xb = x + (size_t)b * hw * c + cv * kVec;
  for (int r = r0 + lane_row; r < r1; r += row_lanes) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xb + (size_t)r * c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      s1[2 * j] += f.x;
      s1[2 * j + 1] += f.y;
      s2[2 * j] += f.x * f.x;
      s2[2 * j + 1] += f.y * f.y;
    }
  }
  float* red1 = red;
  float* red2 = red + row_lanes * c;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    red1[lane_row * c + cv * kVec + j] = s1[j];
    red2[lane_row * c + cv * kVec + j] = s2[j];
  }
  __syncthreads();
  float* out = ws + ((size_t)b * tiles + tile) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int l = 0; l < row_lanes; ++l) {
      a += red1[l * c + ch];
      q += red2[l * c + ch];
    }
    out[ch] = a;
    out[c + ch] = q;
  }
}

// Block (g, b): the sums of group g over its channels and all row tiles,
// then gamma = scale * rstd and beta = bias - mean * gamma for its channels.
__global__ void __launch_bounds__(kFoldThreads)
gn_fold_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ gb, int c,
               int groups, int tiles, float n, float eps) {
  __shared__ float part[2][kFoldThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y, cg = c / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < tiles * cg; i += kFoldThreads) {
    const float* p = ws + ((size_t)b * tiles + i / cg) * 2 * c + g * cg + i % cg;
    a += p[0];
    q += p[c];
  }
  a = warp_sum(a);
  q = warp_sum(q);
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = q;
  }
  __syncthreads();
  a = q = 0.f;
#pragma unroll
  for (int w = 0; w < kFoldThreads / 32; ++w) {
    a += part[0][w];
    q += part[1][w];
  }
  const float mean = a / n;
  const float rstd = rsqrtf(fmaxf(q / n - mean * mean, 0.f) + eps);
  for (int j = threadIdx.x; j < cg; j += kFoldThreads) {
    const int ch = g * cg + j;
    const float gamma = scale[ch] * rstd;
    gb[(size_t)b * 2 * c + ch] = gamma;
    gb[(size_t)b * 2 * c + c + ch] = bias[ch] - mean * gamma;
  }
}

// y = x * gamma[b] + beta[b] (then SiLU), 8 channels per thread.
template <bool kSilu>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gb,
                __nv_bfloat16* __restrict__ y, long long hw, int c,
                long long nvec) {
  const int ncv = c / kVec;
  const long long stride = (long long)gridDim.x * kApplyThreads;
  for (long long i = (long long)blockIdx.x * kApplyThreads + threadIdx.x;
       i < nvec; i += stride) {
    const int cv = (int)(i % ncv);
    const long long b = i / ncv / hw;
    const float4* gam = reinterpret_cast<const float4*>(gb + b * 2 * c + cv * kVec);
    const float4* bet = reinterpret_cast<const float4*>(gb + b * 2 * c + c + cv * kVec);
    const float4 g0 = gam[0], g1 = gam[1], b0 = bet[0], b1 = bet[1];
    const float gv[kVec] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bv[kVec] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 packed;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      float v0 = f.x * gv[2 * j] + bv[2 * j];
      float v1 = f.y * gv[2 * j + 1] + bv[2 * j + 1];
      if (kSilu) {
        v0 = v0 / (1.f + __expf(-v0));
        v1 = v1 / (1.f + __expf(-v1));
      }
      o2[j] = __floats2bfloat162_rn(v0, v1);
    }
    reinterpret_cast<uint4*>(y)[i] = packed;
  }
}

}  // namespace

// x, y [b, hw, c] bf16 (c % 8 == 0, c / 8 * row_lanes <= 1024 threads);
// scale, bias [c] fp32; ws [b, tiles, 2, c] fp32 with
// tiles = ceil(hw / rows_per_tile); gb [b, 2, c] fp32. Returns a
// cudaError_t value (0 on success).
extern "C" int group_norm_act_bf16(const void* x, const void* scale,
                                   const void* bias, void* y, void* ws, void* gb,
                                   int b, int hw, int c, int groups,
                                   int rows_per_tile, int row_lanes, float eps,
                                   int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (hw + rows_per_tile - 1) / rows_per_tile;
  const int threads = c / kVec * row_lanes;
  const size_t smem = sizeof(float) * 2 * (size_t)row_lanes * c;
  gn_partial_kernel<<<dim3(tiles, b), threads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(ws), hw, c,
      rows_per_tile, row_lanes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float n = (float)hw * (float)(c / groups);
  gn_fold_kernel<<<dim3(groups, b), kFoldThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(gb), c, groups, tiles,
      n, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nvec = (long long)b * hw * c / kVec;
  const int blocks = (int)std::min<long long>((nvec + kApplyThreads - 1) / kApplyThreads,
                                              132LL * 16);
  if (silu)
    gn_apply_kernel<true><<<blocks, kApplyThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gb),
        static_cast<__nv_bfloat16*>(y), hw, c, nvec);
  else
    gn_apply_kernel<false><<<blocks, kApplyThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gb),
        static_cast<__nv_bfloat16*>(y), hw, c, nvec);
  return (int)cudaGetLastError();
}
