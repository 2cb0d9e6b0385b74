// Mask-free multi-head attention with an int8 QK^T, for Hopper (sm_90a):
// softmax(q k^T * scale) v over [B, H, S, D], q and v bf16, K given as int8
// `ki` [B, H, Skv, Dp] (Dp = D rounded up to 16, columns past D zero) with
// fp32 per-token scales `ks` [B, H, Skv] (centred per channel and quantized
// once by the wrapper's pre-pass).
//
// Replaces uce_tpu/ops/pallas/sd_attention.py::_kernel_qk8 (:166), the W8A8
// serving variant of the SD UNet's long self-attention. Numerics follow it:
// each q row is quantized here (amax over D in fp32, qs = max(amax,
// 1e-6)/127, qi = round-half-even(q / qs) by a true division), QK^T
// accumulates exactly in int32, logits = acc * qs * ks * scale, the softmax
// runs in fp32 with max subtraction, P is rounded to bf16 and PV accumulates
// in fp32. K/V stream in tiles with an online softmax (the TPU kernel holds
// a whole K row in VMEM) and P is normalised after PV.
//
// What bounds it: at D = 40 the exp unit. At (8, 8, 4096, 4096, 40) the
// products are 86 GOP int8 + 86 GFLOP bf16 (0.13 ms), the softmax 1.07e9
// exp2 on the MUFU unit, 16 a clock per SM (0.26 ms at 1.98 GHz); the
// dequantize adds an IADD and an FFMA per logit on the other pipes.
//
// Design: csrc/sd_attention.cu's schedule (one block per 128 query rows of
// one batch*head):
//  - A producer warp issues TMA loads: bf16 Q once (128 rows), then per
//    K/V tile of kKv rows the int8 K tile, the bf16 V tile and the tile's
//    fp32 ks slice into a ring of kStages stages with "full" and "empty"
//    mbarriers. K's tensor map is [bh, Skv, Dp] with a 128-byte box: TMA
//    needs 16-byte global strides, hence the pre-pass's Dp (48 at D = 40),
//    and zero-fills the columns past Dp, so the int8 contraction runs over
//    D rounded up to 32 (64 at D = 40, 96 at 80, 160 at 160) in k32 steps of
//    32 bytes, the same byte offsets as a bf16 k16 step. ks is read through
//    a 1-D map over all bh * Skv scales (its rows need no 16-byte stride).
//  - Two consumer warpgroups own 64 query rows each. Each quantizes its
//    rows once, from the TMA'd bf16 tile into a 128-byte-swizzled int8 tile
//    (the K-major A operand), with __fdiv_rn and __float2int_rn.
//    S = Qi Ki^T is wgmma m64n{kKv}k32 .s32.s8.s8, both operands K-major in
//    shared memory (8-bit wgmma has no transpose bit and needs none).
//  - Dequantize without I2F: the s32 fragment has the fp32 one's layout,
//    and for |acc| < 2^22 (here |acc| <= 127^2 * 160) the float with bits
//    acc + 0x4B400000 is 12582912 + acc exactly. One FFMA folds the magic
//    constant and the column's ks (y = f * ks - 12582912 * ks), a second
//    one the row's qs * scale * log2(e) and the row max before ex2.
//  - P is rounded to bf16 in registers as the A fragments of O += P V,
//    wgmma m64n{D}k16 with V read MN-major through the transpose bit.
//  - Tile t's QK^T is issued with tile t-1's PV, and the two warpgroups
//    take turns at issuing through two named barriers (ping-pong), so one
//    warpgroup's dequantize and exp2 run under the other's products. The
//    first tile is peeled so that every wgmma issue is branch-free (ptxas
//    serialises wgmma otherwise, C7520).
//
// Built without --use_fast_math: the q quantization relies on IEEE division
// and round-to-nearest-even.

#include "hopper.cuh"

namespace {

constexpr int kBlockRows = 128;              // query rows per block
constexpr int kConsumerWarps = 8;            // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kLine = 128;                   // bytes of one swizzled line
constexpr int kSmemBudget = 200 * 1024;
constexpr int kMagic = 0x4B400000;           // the bits of 1.5 * 2^23
constexpr float kMagicF = 12582912.f;

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of element (r, c) of a tile of 128-byte lines, lines of
// `line_elems` elements of `elem` bytes, chunks of `rows` lines, as TMA's
// 128-byte swizzle lands it.
__device__ __forceinline__ int sw128(int r, int c, int line_elems, int elem, int rows) {
  const int byte = (c % line_elems) * elem;
  return (c / line_elems) * rows * kLine + r * kLine +
         ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
}

template <int D>
struct Cfg {
  static constexpr int kDk = (D + 31) / 32 * 32;      // int8 contraction
  static constexpr int kSteps = kDk / 32;             // k32 steps of QK^T
  static constexpr int kChunks8 = (kDk + 127) / 128;  // lines of an int8 row
  static constexpr int kChunks = (D + 63) / 64;       // lines of a bf16 row
  static constexpr int kKv = D <= 80 ? 128 : 64;      // K/V rows per tile
  static constexpr int kQBytes = kChunks * kBlockRows * kLine;    // bf16 Q
  static constexpr int kQ8Bytes = kChunks8 * kBlockRows * kLine;  // int8 Q
  static constexpr int kKBytes = kChunks8 * kKv * kLine;
  static constexpr int kVBytes = kChunks * kKv * kLine;
  static constexpr int kStageTx = kKBytes + kVBytes + kKv * 4;  // + ks
  static constexpr int kStageBytes = (kStageTx + 1023) / 1024 * 1024;
  static constexpr int kStagesFit = (kSmemBudget - kQBytes - kQ8Bytes) / kStageBytes;
  static constexpr int kStages = kStagesFit > 4 ? 4 : kStagesFit;
  static constexpr int kSmem = kQBytes + kQ8Bytes + kStages * kStageBytes + 1024;
  static_assert(kStages >= 2, "K/V ring needs two stages");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
sd_attention_qk8_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_ks,
                        const __grid_constant__ CUtensorMap map_v,
                        __nv_bfloat16* __restrict__ o, int sq, int skv, float c) {
  using C = Cfg<D>;
  constexpr int kKv = C::kKv, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  __shared__ float s_qs[kBlockRows];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  unsigned char* base = smem_raw + (sQ - raw);  // generic address of sQ
  const uint32_t sQ8 = sQ + C::kQBytes;
  const uint32_t sKV = sQ8 + C::kQ8Bytes;  // stage s: K, V, ks
  auto k_tile = [&](int st) { return sKV + st * C::kStageBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + C::kKBytes; };
  auto ks_tile = [&](int st) { return v_tile(st) + C::kVBytes; };

  const int bh = blockIdx.y, row0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = (skv + kKv - 1) / kKv;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&q_full, C::kQBytes);
      for (int ch = 0; ch < C::kChunks; ++ch)
        tma_load_3d(sQ + ch * kBlockRows * kLine, &map_q, ch * 64, row0, bh, &q_full);
      for (int t = 0; t < n; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + st, (t / kStages - 1) & 1);
        mbar_expect_tx(full + st, C::kStageTx);
        for (int ch = 0; ch < C::kChunks8; ++ch)
          tma_load_3d(k_tile(st) + ch * kKv * kLine, &map_k, ch * 128, t * kKv, bh,
                      full + st);
        for (int ch = 0; ch < C::kChunks; ++ch)
          tma_load_3d(v_tile(st) + ch * kKv * kLine, &map_v, ch * 64, t * kKv, bh,
                      full + st);
        tma_load_1d(ks_tile(st), &map_ks, bh * skv + t * kKv, full + st);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows [64 wg, 64 wg + 64) of the block.
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  if (wg == 1) named_arrive(1, 256);  // warpgroup 0 issues first
  const uint32_t sQ8w = sQ8 + wg * 64 * kLine;

  // Quantize this warp's 16 q rows into the int8 tile; the contraction
  // padding past D is written as zeros (rows past sq arrive as zeros).
  mbar_wait(&q_full, 0);
  {
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(base);
    int8_t* q8 = reinterpret_cast<int8_t*>(base + C::kQBytes);
    for (int i = 0; i < 16; ++i) {
      const int r = wg * 64 + wq * 16 + i;
      float x[C::kSteps];
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < C::kSteps; ++j) {
        const int col = lane + 32 * j;
        x[j] = col < D ? __bfloat162float(qb[sw128(r, col, 64, 2, kBlockRows) / 2]) : 0.f;
        amax = fmaxf(amax, fabsf(x[j]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, off));
      const float qs = __fdiv_rn(fmaxf(amax, 1e-6f), 127.f);
#pragma unroll
      for (int j = 0; j < C::kSteps; ++j) {
        const int col = lane + 32 * j;
        q8[sw128(r, col, 128, 1, kBlockRows)] =
            col < D ? (int8_t)__float2int_rn(__fdiv_rn(x[j], qs)) : (int8_t)0;
      }
      if (lane == 0) s_qs[r] = qs;
    }
  }
  fence_proxy_async();      // the int8 tile is read by wgmma (async proxy)
  named_sync(3 + wg, 128);  // this warpgroup's four warps
  // qs * scale * log2(e) of rows 16 wq + g (+ 8) of this warpgroup
  const float qc[2] = {s_qs[wg * 64 + wq * 16 + g] * c,
                       s_qs[wg * 64 + wq * 16 + g + 8] * c};

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // in units of acc * ks
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  uint32_t pa[kKv / 16][4];      // P of the previous tile, bf16 A fragments

  auto issue_pv = [&](int st) {
#pragma unroll
    for (int cc = 0; cc < kKv / 16; ++cc)
      wgmma_rs(o_acc, pa[cc],
               desc_sw128(v_tile(st) + cc * 16 * kLine, kKv * kLine, 1024));
  };
  // S = Qi Ki_st^T over D rounded up to 32; the first step overwrites S.
  auto issue_qk = [&](int st, int (&s)[kKv / 2]) {
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_s8(s, desc_sw128(sQ8w + (kk / 4) * kBlockRows * kLine + off, 16, 1024),
                  desc_sw128(k_tile(st) + (kk / 4) * kKv * kLine + off, 16, 1024),
                  kk > 0);
    }
  };
  // Dequantize and online softmax of tile t in place: s (int32 sums) comes
  // back as the bits of fp32 P; the running max and this thread's row sums
  // move, alpha rescales O.
  auto softmax = [&](int t, int st, int (&s)[kKv / 2], float (&alpha)[2]) {
    const float* ksv = reinterpret_cast<const float*>(base + (ks_tile(st) - sQ));
    float y[kKv / 2];
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
      const float2 k2 = *reinterpret_cast<const float2*>(ksv + j * 8 + t4 * 2);
      const float nk0 = -kMagicF * k2.x, nk1 = -kMagicF * k2.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        y[i] = fmaf(__int_as_float(s[i] + kMagic), (e & 1) ? k2.y : k2.x,
                    (e & 1) ? nk1 : nk0);
      }
    }
    if ((t + 1) * kKv > skv) {  // columns past skv
#pragma unroll
      for (int i = 0; i < kKv / 2; ++i) {
        const int col = t * kKv + (i / 4) * 8 + t4 * 2 + (i & 1);
        if (col >= skv) y[i] = -INFINITY;
      }
    }
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kKv / 2; ++i)
      m_tile[(i >> 1) & 1] = fmaxf(m_tile[(i >> 1) & 1], y[i]);
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffff, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffff, m_tile[r], 2));
      const float m_new = fmaxf(m_run[r], m_tile[r]);
      alpha[r] = exp2_ftz((m_run[r] - m_new) * qc[r]);  // 0 on the first tile
      m_run[r] = m_new;
      mc[r] = m_new * qc[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kKv / 2; ++i) {
      const float p = exp2_ftz(fmaf(y[i], qc[(i >> 1) & 1], -mc[(i >> 1) & 1]));
      s[i] = __float_as_int(p);
      l_run[(i >> 1) & 1] += p;
    }
  };
  // S n-tiles 2cc and 2cc + 1 are the A fragment of kv rows [16cc, 16cc + 16).
  auto pack = [&](const int (&s)[kKv / 2]) {
#pragma unroll
    for (int cc = 0; cc < kKv / 16; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[cc][e] = pack_bf16(__int_as_float(s[8 * cc + 2 * e]),
                              __int_as_float(s[8 * cc + 2 * e + 1]));
  };

  int s[kKv / 2] = {};
  float alpha[2];
  // Tile 0: QK^T alone (O is still zero).
  mbar_wait(full, 0);
  named_sync(1 + wg, 256);  // this warpgroup's turn to issue
  fence_regs(s);
  wgmma_fence();
  issue_qk(0, s);
  wgmma_commit();
  named_arrive(2 - wg, 256);  // the other warpgroup's turn
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0, 0, s, alpha);
  pack(s);
  // Tile t: QK^T of t and PV of t - 1 issued together; the softmax of t runs
  // while PV t - 1 completes.
  for (int t = 1; t < n; ++t) {
    const int st = t % kStages, prev = (t - 1) % kStages;
    mbar_wait(full + st, (t / kStages) & 1);
    named_sync(1 + wg, 256);
    fence_regs(s);
    fence_regs(o_acc);
    wgmma_fence();
    issue_qk(st, s);
    wgmma_commit();
    issue_pv(prev);
    wgmma_commit();
    named_arrive(2 - wg, 256);
    wgmma_wait<1>();  // S_t complete; PV_{t-1} may still run
    fence_regs(s);
    softmax(t, st, s, alpha);
    wgmma_wait<0>();  // PV_{t-1} complete: its stage and pa are free
    fence_regs(o_acc);
    if (lane == 0) mbar_arrive(empty + prev);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
    pack(s);
  }
  // The last tile's PV.
  fence_regs(o_acc);
  wgmma_fence();
  issue_pv((n - 1) % kStages);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o_acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 2);
  }
  // Rows 16 wq + g (+ 8) of this warpgroup; columns 8 j + 2 t4 (+ 1).
  __nv_bfloat16* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wg * 64 + wq * 16 + g + h * 8;
    if (r >= sq) continue;
    const float inv = 1.f / l_run[h];
    __nv_bfloat16* orow = ob + (size_t)r * D + t4 * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = __floats2bfloat162_rn(
          o_acc[j * 4 + h * 2] * inv, o_acc[j * 4 + h * 2 + 1] * inv);
  }
}

// Tensor map over a [bh, rows, cols] tensor of `elem`-byte elements,
// loading [box_rows, 128-byte] boxes with the 128-byte swizzle.
int make_map(CUtensorMap* map, const void* base, int cols, int rows, int bh,
             int box_rows, int elem, CUtensorMapDataType type) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem,
                                 (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(kLine / elem), (cuuint32_t)box_rows, 1};
  return encode_map(map, base, 3, dims, strides, box, type);
}

template <int D>
int launch(const void* q, const void* ki, const void* ks, const void* v, void* o,
           int bh, int sq, int skv, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr int kDp = (D + 15) / 16 * 16;
  CUtensorMap mq, mk, mks, mv;
  int err = make_map(&mq, q, D, sq, bh, kBlockRows, 2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (err == 0)
    err = make_map(&mk, ki, kDp, skv, bh, C::kKv, 1, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == 0)
    err = make_map(&mv, v, D, skv, bh, C::kKv, 2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (err == 0) {
    const cuuint64_t dims[1] = {(cuuint64_t)bh * skv};
    const cuuint64_t strides[1] = {0};  // unused at rank 1
    const cuuint32_t box[1] = {(cuuint32_t)C::kKv};
    err = encode_map(&mks, ks, 1, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != 0) return err;
  static unsigned sized = 0;
  err = set_smem_once(sd_attention_qk8_kernel<D>, C::kSmem, sized);
  if (err != 0) return err;
  const dim3 grid((sq + kBlockRows - 1) / kBlockRows, bh);
  sd_attention_qk8_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mks, mv, static_cast<__nv_bfloat16*>(o), sq, skv,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q, v [bh, sq|skv, d] bf16, ki [bh, skv, round_up(d, 16)] int8, ks [bh, skv]
// fp32, all 16-byte aligned. Returns a cudaError_t value (0 on success); -1
// for an unsupported head dim.
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
