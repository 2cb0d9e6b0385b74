// Newton-Schulz inverse of the UCE right Gram matrix, for Hopper (sm_90a).
//
// Replaces uce_tpu/ops/pallas/uce_solve.py::uce_edit_matrix_pallas
// (_kernel). As on the TPU it computes, all in fp32,
//
//     B   = lam*I + s * Ce^T Ce + p * Cp^T Cp
//     X_0 = I / ||B||_inf
//     X  <- X (2I - B X)        (iters steps, 40 in the caller)
//
// and leaves X ~= B^-1 for the caller, which forms E = A X and one step of
// iterative refinement with fp32 matmuls outside this file.
//
// The TPU kernel holds B and X in VMEM and builds fp32-accurate products
// from three bf16 MXU passes (a Mosaic workaround). One SM cannot hold a
// d x d fp32 matrix (2.4 MB at d = 768), and CUDA cores do fp32 FMA
// natively, so here the chain runs as launches on one stream from one C
// entry point: the Gram build, the row-sum norm, X_0, then per step two
// tiled fp32 GEMMs, the first with the 2I - (.) update fused into its
// epilogue. The wrapper allocates all scratch.
//
// What bounds it: fp32 FMA work, 2 * iters GEMMs of 2 d^3 flops (72.5 GFLOP
// at d = 768, 1.1 ms at 67 TFLOP/s). The GEMM is a plain 64 x 64 shared
// memory tile with 4 x 4 outputs per thread; a faster one would use the
// tensor cores in 3xTF32.

#include <cuda_runtime.h>

namespace {

constexpr int TS = 64;        // GEMM output tile
constexpr int TK = 16;        // GEMM k step
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kNormThreads = 1024;

// B[i][j] = s * sum_k Ce[k][i] Ce[k][j] + p * sum_k Cp[k][i] Cp[k][j]
//           (+ lam on the diagonal); grid (ceil(d / 256), d).
__global__ void gram_kernel(const float* __restrict__ ce, int ke,
                            const float* __restrict__ cp, int kp, int d,
                            float lam, float s, float p, float* __restrict__ bm) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, i = blockIdx.y;
  if (j >= d) return;
  float a = 0.f, q = 0.f;
  for (int k = 0; k < ke; ++k) a = fmaf(ce[(size_t)k * d + i], ce[(size_t)k * d + j], a);
  for (int k = 0; k < kp; ++k) q = fmaf(cp[(size_t)k * d + i], cp[(size_t)k * d + j], q);
  bm[(size_t)i * d + j] = s * a + p * q + (i == j ? lam : 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffff, v, off);
  return v;
}

// norm[0] = max_i sum_j |B[i][j]|; one block, one warp per row at a time.
__global__ void __launch_bounds__(kNormThreads)
norm_inf_kernel(const float* __restrict__ bm, int d, float* __restrict__ norm) {
  __shared__ float wmax[kNormThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mx = 0.f;
  for (int r = warp; r < d; r += kNormThreads / 32) {
    float acc = 0.f;
    for (int c = lane; c < d; c += 32) acc += fabsf(bm[(size_t)r * d + c]);
    mx = fmaxf(mx, warp_sum(acc));
  }
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kNormThreads / 32; ++w) mx = fmaxf(mx, wmax[w]);
    norm[0] = mx;
  }
}

// X = I / norm[0].
__global__ void scaled_eye_kernel(float* __restrict__ x, int d,
                                  const float* __restrict__ norm) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)d * d) return;
  x[idx] = (idx / d == idx % d) ? 1.f / norm[0] : 0.f;
}

// C = alpha * A B + diag * I for row-major d x d fp32 matrices.
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ c, int d, float alpha, float diag) {
  __shared__ __align__(16) float sa[TK][TS + 4];  // A tile, k-major
  __shared__ __align__(16) float sb[TK][TS + 4];  // B tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * TS, col0 = blockIdx.x * TS;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += TK) {
    for (int i = threadIdx.x; i < TS * TK; i += kGemmThreads) {
      const int r = i / TK, kk = i % TK;  // A: 16 consecutive k of a row
      const int gr = row0 + r, ga = k0 + kk;
      sa[kk][r] = (gr < d && ga < d) ? a[(size_t)gr * d + ga] : 0.f;
      const int kb = i / TS, cc = i % TS;  // B: 64 consecutive columns
      const int gb = k0 + kb, gc = col0 + cc;
      sb[kb][cc] = (gb < d && gc < d) ? b[(size_t)gb * d + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= d) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col0 + tx * 4 + j;
      if (cc < d) c[(size_t)r * d + cc] = alpha * acc[i][j] + (r == cc ? diag : 0.f);
    }
  }
}

}  // namespace

#define UCE_CHECK_LAUNCH()                       \
  do {                                           \
    const cudaError_t e = cudaGetLastError();    \
    if (e != cudaSuccess) return (int)e;         \
  } while (0)

// ce [ke, d], cp [kp, d] (kp may be 0), x [d, d] out; scratch: bm, t, xn
// [d, d] each and norm [1], all fp32. Returns a cudaError_t value.
extern "C" int uce_newton_schulz(const void* ce, int ke, const void* cp, int kp,
                                 int d, float lam, float erase_scale,
                                 float preserve_scale, int iters, void* x,
                                 void* bm, void* t, void* xn, void* norm,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* bmp = static_cast<float*>(bm);
  float* tp = static_cast<float*>(t);
  float* np = static_cast<float*>(norm);
  gram_kernel<<<dim3((d + 255) / 256, d), 256, 0, s>>>(
      static_cast<const float*>(ce), ke, static_cast<const float*>(cp), kp, d,
      lam, erase_scale, preserve_scale, bmp);
  UCE_CHECK_LAUNCH();
  norm_inf_kernel<<<1, kNormThreads, 0, s>>>(bmp, d, np);
  UCE_CHECK_LAUNCH();
  float* cur = static_cast<float*>(x);
  float* other = static_cast<float*>(xn);
  const int n = d * d;
  scaled_eye_kernel<<<(n + 255) / 256, 256, 0, s>>>(cur, d, np);
  UCE_CHECK_LAUNCH();
  const dim3 grid((d + TS - 1) / TS, (d + TS - 1) / TS);
  for (int it = 0; it < iters; ++it) {
    gemm_kernel<<<grid, kGemmThreads, 0, s>>>(bmp, cur, tp, d, -1.f, 2.f);
    UCE_CHECK_LAUNCH();
    gemm_kernel<<<grid, kGemmThreads, 0, s>>>(cur, tp, other, d, 1.f, 0.f);
    UCE_CHECK_LAUNCH();
    float* tmp = cur;
    cur = other;
    other = tmp;
  }
  if (cur != x) {
    const cudaError_t e = cudaMemcpyAsync(x, cur, sizeof(float) * n,
                                          cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}
