// Mask-free multi-head attention, softmax(q k^T * scale) v over [B, H, S, D]
// bf16 tensors, for Hopper (built for sm_90a).
//
// Replaces two TPU kernels:
//  - uce_tpu/ops/pallas/sd_attention.py::_kernel, the SD UNet self-attention
//    (D in {40, 64, 80, 128, 160}): sd_attention_kernel below;
//  - uce_tpu/ops/attention.py::_flash_attention, JAX's bundled TPU flash
//    kernel, which serves the VAE mid-block attention (s=4096, D=512, one
//    head) because the sd_attention VMEM gate rejects D=512:
//    sd_attention_wide_kernel below.
//
// The TPU's _kernel keeps a whole K/V row and the [bq, S_kv] fp32 logits in
// VMEM; a Hopper block has at most 227 KB of shared memory, so both kernels
// here stream K/V in 64-row tiles with an online softmax instead (running
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
// D = 512: a thread would need D/8 = 64 PV accumulator n-tiles (256 fp32
// registers) for O alone, so the wide kernel splits D across the grid: each
// block owns one 64-column slice of the output, recomputes QK^T over the
// full 512-wide contraction from shared memory (Q and the K tile, 2 x 65 KB)
// and runs PV for its slice only. The QK^T work is repeated once per slice
// (8x): 9 * 2 * S^2 * D flops instead of 4 * S^2 * D. That is the price of
// a simple kernel; a faster one keeps O in several warpgroups' registers.
//
// What bounds it: at s=4096, d=40 the work is tensor-core work on a head
// dim that fills little of the MMA (the QK^T contraction pads 40 -> 48) and
// the loads are synchronous (no cp.async/TMA double buffering, no wgmma);
// at d=512 the 8x repeated QK^T and one resident block per SM (142 KB of
// shared memory). Those are the levers for a faster version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 64;   // query rows per block
constexpr int kKvTile = 64;         // K/V rows per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;             // bf16 elements of row padding (bank spread)
constexpr int kNTiles = kKvTile / 8;  // n-tiles of QK^T
constexpr int LDV = kKvTile + kPad;   // V^T row stride
constexpr int kWideD = 512;         // head dim of the wide kernel
constexpr int kSlice = 64;          // output columns per wide-kernel block

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// V^T tile: sVt[c][kv] = v[kv][c0 + c] for `cols` columns of rows with
// stride D; rows past `valid` are zero so 0 * padding stays 0.
__device__ __forceinline__ void load_vt(__nv_bfloat16* sVt,
                                        const __nv_bfloat16* v, int D, int c0,
                                        int cols, int valid) {
  for (int i = threadIdx.x; i < kKvTile * (cols / 2); i += kThreads) {
    const int r = i / (cols / 2), c = (i % (cols / 2)) * 2;
    __nv_bfloat162 val = __floats2bfloat162_rn(0.f, 0.f);
    if (r < valid)
      val = *reinterpret_cast<const __nv_bfloat162*>(v + (size_t)r * D + c0 + c);
    sVt[c * LDV + r] = val.x;
    sVt[(c + 1) * LDV + r] = val.y;
  }
}

// One K/V tile of the online softmax for this warp's 16 rows: s holds the
// raw QK^T logits (16 rows x 64 kv columns, m16n8 fragments); updates the
// running max/sum and adds P V^T (kDTiles n-tiles of 8 columns) into acc.
template <int kDTiles>
__device__ __forceinline__ void softmax_pv(float (&s)[kNTiles][4],
                                           float (&acc)[kDTiles][4],
                                           float (&m_run)[2], float (&l_run)[2],
                                           int valid, float scale_log2,
                                           const __nv_bfloat16* sVt, int g,
                                           int t4) {
  // Online softmax in log2 units; columns past skv are masked out.
  float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + t4 * 2 + (e & 1);
      const float x = col < valid ? s[n][e] * scale_log2 : -INFINITY;
      s[n][e] = x;
      m_tile[e >> 1] = fmaxf(m_tile[e >> 1], x);
    }
  }
  float alpha[2], m_new[2], l_tile[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffff, m_tile[r], 1));
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffff, m_tile[r], 2));
    m_new[r] = fmaxf(m_run[r], m_tile[r]);
    alpha[r] = exp2f(m_run[r] - m_new[r]);  // 0 on the first tile
    m_run[r] = m_new[r];
  }
#pragma unroll
  for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[n][e] - m_new[e >> 1]);
      s[n][e] = p;
      l_tile[e >> 1] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_tile[r] += __shfl_xor_sync(0xffffffff, l_tile[r], 1);
    l_tile[r] += __shfl_xor_sync(0xffffffff, l_tile[r], 2);
    l_run[r] = l_run[r] * alpha[r] + l_tile[r];
  }
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }

  // O += P V: the S accumulators of n-tiles 2c and 2c+1 form the A
  // fragment of kv chunk c.
#pragma unroll
  for (int c = 0; c < kKvTile / 16; ++c) {
    uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                      pack_bf16(s[2 * c][2], s[2 * c][3]),
                      pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                      pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      const __nv_bfloat16* vrow = sVt + (j * 8 + g) * LDV + c * 16 + t4 * 2;
      uint32_t b[2] = {ld_u32(vrow), ld_u32(vrow + 8)};
      mma_bf16_16816(acc[j], pa, b);
    }
  }
}

// Normalise and store rows r_lo and r_lo + 8 of acc into columns
// [c0, c0 + 8 * kDTiles) of the [sq, D] output ob.
template <int kDTiles>
__device__ __forceinline__ void store_rows(__nv_bfloat16* ob, int D, int c0,
                                           const float (&acc)[kDTiles][4],
                                           const float (&l_run)[2], int r_lo,
                                           int sq, int t4) {
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int c = c0 + j * 8 + t4 * 2;
    if (r_lo < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r_lo * D + c) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r_hi < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r_hi * D + c) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
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

// D = 512: grid (query tiles, batch*head, D / kSlice). Q stays in shared
// memory (its A fragments would take 128 registers per thread) and is read
// from there at every k-step.
__global__ void __launch_bounds__(kThreads)
sd_attention_wide_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int sq, int skv,
                         float scale_log2) {
  constexpr int D = kWideD;
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = kSlice / 8;
  constexpr int LDQ = D + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRowsPerBlock * LDQ;
  __nv_bfloat16* sVt = sK + kKvTile * LDQ;

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int c0 = blockIdx.z * kSlice;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  const __nv_bfloat16* qb = q + ((size_t)bh * sq + row0) * D;
  const __nv_bfloat16* kb = k + (size_t)bh * skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * skv * D;
  const __nv_bfloat16* qw = sQ + (warp * 16) * LDQ;

  load_rows<D>(sQ, LDQ, qb, kRowsPerBlock, min(kRowsPerBlock, sq - row0));

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < skv; kv0 += kKvTile) {
    const int valid = min(kKvTile, skv - kv0);
    __syncthreads();  // previous tile fully consumed (and Q stored)
    load_rows<D>(sK, LDQ, kb + (size_t)kv0 * D, kKvTile, valid);
    load_vt(sVt, vb + (size_t)kv0 * D, D, c0, kSlice, valid);
    __syncthreads();

    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int st = 0; st < kSteps; ++st) {
      const int c = st * 16 + t4 * 2;
      uint32_t a[4] = {ld_u32(qw + g * LDQ + c), ld_u32(qw + (g + 8) * LDQ + c),
                       ld_u32(qw + g * LDQ + c + 8),
                       ld_u32(qw + (g + 8) * LDQ + c + 8)};
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
        const __nv_bfloat16* krow = sK + (n * 8 + g) * LDQ + c;
        uint32_t b[2] = {ld_u32(krow), ld_u32(krow + 8)};
        mma_bf16_16816(s[n], a, b);
      }
    }
    softmax_pv<kDTiles>(s, acc, m_run, l_run, valid, scale_log2, sVt, g, t4);
  }
  store_rows<kDTiles>(o + (size_t)bh * sq * D, D, c0, acc, l_run,
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

int launch_wide(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int skv, float scale, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)(kRowsPerBlock + kKvTile) * (kWideD + kPad) +
                               (size_t)kSlice * LDV);
  dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, bh, kWideD / kSlice);
  return launch_kernel(sd_attention_wide_kernel, grid, smem, q, k, v, o, sq,
                       skv, scale, stream);
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
    case kWideD: return launch_wide(q, k, v, o, bh, sq, skv, scale, s);
    default: return -1;
  }
}
