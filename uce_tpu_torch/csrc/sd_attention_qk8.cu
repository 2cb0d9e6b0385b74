// Mask-free multi-head attention with an int8 QK^T, for Hopper (built for
// sm_90a): softmax(q k^T * scale) v over [B, H, S, D], q and v bf16, K
// given as int8 `ki` [B, H, Skv, D] with fp32 per-token scales `ks`
// [B, H, Skv] (centred per channel and quantized once by the wrapper).
//
// Replaces uce_tpu/ops/pallas/sd_attention.py::_kernel_qk8, the W8A8
// serving variant of the SD UNet's long self-attention. Numerics follow it:
// each q row is quantized here (amax over D in fp32, qs = max(amax,
// 1e-6)/127, qi = round-half-even(q / qs) by a true division), QK^T
// accumulates exactly in int32, logits = float(acc) * (qs * ks) * scale,
// the softmax runs in fp32 with max subtraction, P is rounded to bf16 and
// PV accumulates in fp32. K/V stream in 64-row
// tiles with an online softmax (the TPU kernel holds a whole K row in VMEM;
// a Hopper block cannot, and need not) and P is normalised after PV.
//
// Design: one block of 4 warps per (batch*head, 64 query rows). The block
// quantizes its q rows into shared memory (int8, D zero-padded to a
// multiple of 32: 40 -> 64, 80 -> 96, in shared memory only), keeps them
// as the A fragments of mma.sync m16n8k32 s8 (four 32-bit registers of four
// int8 each) and runs QK^T against each int8 K tile; `ki` [Skv, D]
// row-major is already the `col` B operand. The s32 accumulator fragment
// has the layout of the fp32 C of m16n8k16, so after the per-entry scaling
// the online-softmax + PV step (softmax_pv below) reuses the fragments as
// the bf16 A operand of PV.
//
// What bounds it: tensor-core work on a head dim that
// fills little of the MMA (40 pads to 64 in the int8 contraction), PV in
// bf16 at half the int8 rate, and synchronous loads (no cp.async/TMA
// double buffering, no wgmma). Those are the levers for a faster version.
//
// Built without --use_fast_math: the q quantization relies on IEEE division
// and round-to-nearest-even.

// Shared pieces below: the block shape, the bf16 mma.sync m16n8k16 helpers,
// the V^T tile load, the online-softmax + PV step and the normalised store.
// One block of 4 warps owns 64 query rows, each warp 16 of them.

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
// unscaled logits (16 rows x 64 kv columns, m16n8 accumulator layout);
// updates the running max/sum and adds P V^T (kDTiles n-tiles of 8
// columns) into acc.
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

}  // namespace


namespace {

constexpr int kQkPad = 16;  // int8 bytes of row padding in sQ and sK (bank spread)

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy 64 rows of D int8 (8-byte vectors: a row of 40 bytes is 8-byte but
// not 16-byte aligned) into a shared tile with row stride `ld` bytes; rows
// past `valid` are written as zeros.
template <int D>
__device__ __forceinline__ void load_k8(int8_t* dst, int ld, const int8_t* src,
                                        int valid) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kKvTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint2 val = make_uint2(0, 0);
    if (r < valid) val = *reinterpret_cast<const uint2*>(src + (size_t)r * D + c);
    *reinterpret_cast<uint2*>(dst + r * ld + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
sd_attention_qk8_kernel(const __nv_bfloat16* __restrict__ q,
                        const int8_t* __restrict__ ki,
                        const float* __restrict__ ks,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, int sq, int skv,
                        float scale_log2) {
  constexpr int DK = (D + 31) / 32 * 32;  // int8 contraction, zero padded
  constexpr int kSteps = DK / 32;         // k-steps of QK^T
  constexpr int kDTiles = D / 8;          // n-tiles of PV (D % 8 == 0)
  constexpr int LDQ = DK + kQkPad;        // sQ and sK row stride (bytes)
  constexpr int kPerLane = (D + 31) / 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sK = sQ + kRowsPerBlock * LDQ;
  float* sQs = reinterpret_cast<float*>(sK + kKvTile * LDQ);
  float* sKs = sQs + kRowsPerBlock;
  __nv_bfloat16* sVt = reinterpret_cast<__nv_bfloat16*>(sKs + kKvTile);

  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  const __nv_bfloat16* qb = q + ((size_t)bh * sq + row0) * D;
  const int8_t* kb = ki + (size_t)bh * skv * D;
  const float* ksb = ks + (size_t)bh * skv;
  const __nv_bfloat16* vb = v + (size_t)bh * skv * D;

  // Zero the contraction padding of Q and K once; nothing else writes it.
  if constexpr (DK != D) {
    constexpr int kPadCols = DK - D;
    for (int i = threadIdx.x; i < (kRowsPerBlock + kKvTile) * kPadCols; i += kThreads) {
      const int r = i / kPadCols, c = D + i % kPadCols;
      sQ[r * LDQ + c] = 0;  // rows past kRowsPerBlock fall into sK
    }
  }

  // Quantize this warp's 16 q rows (rows past sq quantize zeros, unstored).
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const bool in = row0 + r < sq;
    float x[kPerLane];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + 32 * j;
      x[j] = (in && c < D) ? __bfloat162float(qb[(size_t)r * D + c]) : 0.f;
      amax = fmaxf(amax, fabsf(x[j]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, off));
    const float qs = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < D) sQ[r * LDQ + c] = (int8_t)__float2int_rn(__fdiv_rn(x[j], qs));
    }
    if (lane == 0) sQs[r] = qs;
  }
  __syncthreads();

  // This warp's 16 int8 Q rows as m16n8k32 A fragments, kept in registers.
  uint32_t qa[kSteps][4];
  {
    const int8_t* base = sQ + (warp * 16) * LDQ;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int c = st * 32 + t4 * 4;
      qa[st][0] = ld_u32(base + g * LDQ + c);
      qa[st][1] = ld_u32(base + (g + 8) * LDQ + c);
      qa[st][2] = ld_u32(base + g * LDQ + c + 16);
      qa[st][3] = ld_u32(base + (g + 8) * LDQ + c + 16);
    }
  }
  const float qs_lo = sQs[warp * 16 + g], qs_hi = sQs[warp * 16 + g + 8];

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
    load_k8<D>(sK, LDQ, kb + (size_t)kv0 * D, valid);
    for (int i = threadIdx.x; i < kKvTile; i += kThreads)
      sKs[i] = i < valid ? ksb[kv0 + i] : 0.f;
    load_vt(sVt, vb + (size_t)kv0 * D, D, 0, D, valid);
    __syncthreads();

    // S = (qi ki^T) * (qs * ks) for 16 rows x 64 kv columns; softmax_pv
    // applies scale (in log2 units).
    float s[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      int si[4] = {0, 0, 0, 0};
      const int8_t* krow = sK + (n * 8 + g) * LDQ + t4 * 4;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t b[2] = {ld_u32(krow + st * 32), ld_u32(krow + st * 32 + 16)};
        mma_s8_16832(si, qa[st], b);
      }
      const float ks0 = sKs[n * 8 + t4 * 2], ks1 = sKs[n * 8 + t4 * 2 + 1];
      s[n][0] = (float)si[0] * (qs_lo * ks0);
      s[n][1] = (float)si[1] * (qs_lo * ks1);
      s[n][2] = (float)si[2] * (qs_hi * ks0);
      s[n][3] = (float)si[3] * (qs_hi * ks1);
    }
    softmax_pv<kDTiles>(s, acc, m_run, l_run, valid, scale_log2, sVt, g, t4);
  }
  store_rows<kDTiles>(o + (size_t)bh * sq * D, D, 0, acc, l_run,
                      row0 + warp * 16 + g, sq, t4);
}

template <int D>
int launch(const void* q, const void* ki, const void* ks, const void* v, void* o,
           int bh, int sq, int skv, float scale, cudaStream_t stream) {
  constexpr int DK = (D + 31) / 32 * 32;
  constexpr size_t smem = (size_t)(kRowsPerBlock + kKvTile) * (DK + kQkPad) +
                          sizeof(float) * (kRowsPerBlock + kKvTile) +
                          sizeof(__nv_bfloat16) * (size_t)D * LDV;
  cudaError_t err = cudaFuncSetAttribute(
      sd_attention_qk8_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float log2e = 1.4426950408889634f;
  dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  sd_attention_qk8_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(ki),
      static_cast<const float*>(ks), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), sq, skv, scale * log2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value (0 on success); -1 for an unsupported head dim.
extern "C" int sd_attention_qk8(const void* q, const void* ki, const void* ks,
                                const void* v, void* o, int bh, int sq, int skv,
                                int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch<40>(q, ki, ks, v, o, bh, sq, skv, scale, s);
    case 64: return launch<64>(q, ki, ks, v, o, bh, sq, skv, scale, s);
    case 80: return launch<80>(q, ki, ks, v, o, bh, sq, skv, scale, s);
    case 128: return launch<128>(q, ki, ks, v, o, bh, sq, skv, scale, s);
    case 160: return launch<160>(q, ki, ks, v, o, bh, sq, skv, scale, s);
    default: return -1;
  }
}
