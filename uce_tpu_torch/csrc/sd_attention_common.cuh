// Pieces shared by the attention kernels of sd_attention.cu (bf16 QK^T) and
// sd_attention_qk8.cu (int8 QK^T): the block shape, the bf16 mma.sync
// m16n8k16 helpers, the V^T tile load, the online-softmax + PV step and the
// normalised store. Both kernels stream K/V in 64-row tiles; one block of 4
// warps owns 64 query rows, each warp 16 of them.

#pragma once

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
