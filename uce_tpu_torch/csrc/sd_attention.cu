// Mask-free multi-head attention, softmax(q k^T * scale) v over [B, H, S, D]
// bf16 tensors, for Hopper (built for sm_90a).
//
// Replaces uce_tpu/ops/pallas/sd_attention.py::_kernel, the SD UNet
// self-attention (D in {40, 64, 80, 128, 160}). D = 512 (the VAE mid-block)
// has its own kernel, sd_attention_d512.cu.
//
// The TPU's _kernel keeps a whole K/V row and the [bq, S_kv] fp32 logits in
// VMEM; a Hopper block has at most 227 KB of shared memory, so the kernel
// here streams K/V in 64-row tiles with an online softmax instead (running
// row max and row sum in fp32, the output accumulator rescaled whenever the
// max moves).
//
// Numerics follow _kernel: QK^T accumulates in fp32 and is scaled there,
// the softmax runs in fp32 with max subtraction, P is rounded to bf16 and
// PV accumulates in fp32. One difference: P is normalised after PV (by the
// fp32 row sum) rather than before it.
//
// Design: one block of 4 warps per (batch*head, 64 query rows); each warp
// owns 16 query rows. Q, K and V^T tiles live in shared memory, with the
// head dim D zero-padded to a multiple of 16 there (never in HBM). Both
// products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate); the QK^T
// accumulator fragments are reused directly as the A operand of PV.
//
// What bounds it: at s=4096, d=40 the work is tensor-core work on a head
// dim that fills little of the MMA (the QK^T contraction pads 40 -> 48) and
// the loads are synchronous (no cp.async/TMA double buffering, no wgmma).
// Those are the levers for a faster version.

#include "sd_attention_common.cuh"

namespace {

// Copy `rows` rows of D bf16 (16-byte vectors) from global into a shared
// tile with row stride `ld`; rows past `valid` are written as zeros.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int rows,
                                          int valid) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
sd_attention_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int sq, int skv,
                    float scale_log2) {
  constexpr int DK = (D + 15) / 16 * 16;  // QK^T contraction, zero padded
  constexpr int kSteps = DK / 16;         // k-steps of QK^T
  constexpr int kDTiles = D / 8;          // n-tiles of PV (D % 8 == 0)
  constexpr int LDQ = DK + kPad;          // Q and K row stride

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRowsPerBlock * LDQ;
  __nv_bfloat16* sVt = sK + kKvTile * LDQ;

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  const __nv_bfloat16* qb = q + ((size_t)bh * sq + row0) * D;
  const __nv_bfloat16* kb = k + (size_t)bh * skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * skv * D;

  // Zero the contraction padding of Q and K once; loads never touch it.
  if constexpr (DK != D) {
    constexpr int kPadCols = DK - D;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < (kRowsPerBlock + kKvTile) * kPadCols; i += kThreads) {
      const int r = i / kPadCols, c = D + i % kPadCols;
      sQ[r * LDQ + c] = zero;  // rows past kRowsPerBlock fall into sK
    }
  }
  load_rows<D>(sQ, LDQ, qb, kRowsPerBlock, min(kRowsPerBlock, sq - row0));
  __syncthreads();

  // This warp's 16 Q rows as A fragments, kept in registers.
  uint32_t qa[kSteps][4];
  {
    const __nv_bfloat16* base = sQ + (warp * 16) * LDQ;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = s * 16 + t4 * 2;
      qa[s][0] = ld_u32(base + g * LDQ + c);
      qa[s][1] = ld_u32(base + (g + 8) * LDQ + c);
      qa[s][2] = ld_u32(base + g * LDQ + c + 8);
      qa[s][3] = ld_u32(base + (g + 8) * LDQ + c + 8);
    }
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // Rows g and g + 8 of this warp's block: running max (log2 units) and sum.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < skv; kv0 += kKvTile) {
    const int valid = min(kKvTile, skv - kv0);
    __syncthreads();  // previous tile fully consumed
    load_rows<D>(sK, LDQ, kb + (size_t)kv0 * D, kKvTile, valid);
    load_vt(sVt, vb + (size_t)kv0 * D, D, 0, D, valid);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 kv columns.
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = sK + (n * 8 + g) * LDQ + t4 * 2;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t b[2] = {ld_u32(krow + st * 16), ld_u32(krow + st * 16 + 8)};
        mma_bf16_16816(s[n], qa[st], b);
      }
    }
    softmax_pv<kDTiles>(s, acc, m_run, l_run, valid, scale_log2, sVt, g, t4);
  }
  store_rows<kDTiles>(o + (size_t)bh * sq * D, D, 0, acc, l_run,
                      row0 + warp * 16 + g, sq, t4);
}

template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, size_t smem, const void* q,
                  const void* k, const void* v, void* o, int sq, int skv,
                  float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      skv, scale * log2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, float scale, cudaStream_t stream) {
  constexpr int DK = (D + 15) / 16 * 16;
  constexpr size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)(kRowsPerBlock + kKvTile) * (DK + kPad) +
                               (size_t)D * LDV);
  dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  return launch_kernel(sd_attention_kernel<D>, grid, smem, q, k, v, o, sq, skv,
                       scale, stream);
}

}  // namespace

// Returns a cudaError_t value (0 on success); -1 for an unsupported head dim.
extern "C" int sd_attention_bf16(const void* q, const void* k, const void* v,
                                 void* o, int bh, int sq, int skv, int d,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch<40>(q, k, v, o, bh, sq, skv, scale, s);
    case 64: return launch<64>(q, k, v, o, bh, sq, skv, scale, s);
    case 80: return launch<80>(q, k, v, o, bh, sq, skv, scale, s);
    case 128: return launch<128>(q, k, v, o, bh, sq, skv, scale, s);
    case 160: return launch<160>(q, k, v, o, bh, sq, skv, scale, s);
    default: return -1;
  }
}
