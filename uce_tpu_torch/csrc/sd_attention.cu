// Mask-free multi-head attention, softmax(q k^T * scale) v over [B, H, S, D]
// bf16 tensors, D in {40, 64, 80, 128, 160}, for Hopper (sm_90a).
//
// Replaces uce_tpu/ops/pallas/sd_attention.py::_kernel (:86), the SD UNet
// self-attention. D = 512 (the VAE mid-block) has its own kernel,
// sd_attention_d512.cu.
//
// The TPU's _kernel keeps a whole K/V row and the [bq, S_kv] fp32 logits in
// VMEM; a Hopper block has at most 227 KB of shared memory, so the kernel
// here streams K/V tiles with an online softmax instead (running row max
// and row sum in fp32, the output accumulator rescaled whenever the max
// moves).
//
// Numerics follow _kernel: QK^T accumulates in fp32, the softmax runs in
// fp32 with max subtraction, P is rounded to bf16 and PV accumulates in
// fp32. One difference: P is normalised after PV (by the fp32 row sum)
// rather than before it.
//
// What bounds it on this card: at D = 40 not the tensor cores. At
// (16, 8, 4096, 4096, 40) the products are 4 * B*H*S^2 * D = 343.6 GFLOP
// (0.35 ms at 989 TFLOP/s), but the softmax takes B*H*S^2 = 2.15e9 exp2 on
// the MUFU unit, 16 a clock per SM (0.51 ms at 1.98 GHz on 132 SMs), and
// about as many FP32 instructions again for the scale, max and convert.
// So the kernel is fast only if the softmax runs while the products run.
//
// Design (one block per 128 query rows of one batch*head):
//  - A producer warp issues TMA loads: Q once (128 rows), then K and V
//    tiles of kKv rows into a ring of kStages stages, each with a "full"
//    mbarrier (the TMA bytes landed) and an "empty" one (all eight consumer
//    warps are done with it). Tensor maps are 3-D [bh, S, D], so rows past
//    S within a head, and the columns past D up to the 64-column line, land
//    as zeros: D is padded in shared memory only, and the QK^T contraction
//    runs over D rounded up to 16 (48 at D = 40, not 64).
//  - Two consumer warpgroups own 64 query rows each. S = Q K^T is wgmma
//    m64n{kKv}k16 with both operands K-major in shared memory. P is rounded
//    to bf16 in registers as the A fragments of O += P V, wgmma m64n{D}k16
//    in its register-A form, with V read straight from its [kv, D] tile as
//    an MN-major operand (transpose bit): no V transpose.
//  - The softmax overlaps the products twice over. Within a warpgroup,
//    tile t's QK^T and tile t-1's PV are issued together, and the softmax
//    of tile t runs while PV t-1 completes. Across the two warpgroups, two
//    named barriers make them take turns at issuing (ping-pong), so one
//    warpgroup's exp2 and FP32 work runs while the other's wgmmas run.
//  - The scale is folded into one FFMA before exp2: p = 2^(x c - m c) with
//    c = scale * log2(e) and m the raw row max. Row maxima are combined by
//    quad shuffles in the accumulator layout; row sums stay per thread
//    until the end.
//  - Rows past Skv in the last tile are masked to -inf before the max.

#include "hopper.cuh"

namespace {

constexpr int kBlockRows = 128;              // query rows per block
constexpr int kConsumerWarps = 8;            // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp
constexpr int kLine = 128;                   // bytes of one swizzled line
constexpr int kSmemBudget = 200 * 1024;

// 2^x on the MUFU unit, results below 2^-126 flushed to zero (they vanish
// beside the row sum and the bf16 rounding of P).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct Cfg {
  static constexpr int kSteps = (D + 15) / 16;      // k16 steps of QK^T
  static constexpr int kChunks = (D + 63) / 64;     // 64-column lines of a row
  static constexpr int kKv = D <= 80 ? 128 : 64;    // K/V rows per tile
  static constexpr int kQBytes = kChunks * kBlockRows * kLine;
  static constexpr int kTileBytes = kChunks * kKv * kLine;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStagesFit = (kSmemBudget - kQBytes) / kStageBytes;
  static constexpr int kStages = kStagesFit > 4 ? 4 : kStagesFit;
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;
  static_assert(kStages >= 2, "K/V ring needs two stages");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
sd_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ o, int sq, int skv, float c) {
  using C = Cfg<D>;
  constexpr int kKv = C::kKv, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + C::kQBytes;  // stage s: K, then V
  auto k_tile = [&](int st) { return sKV + st * C::kStageBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + C::kTileBytes; };

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
        mbar_expect_tx(full + st, C::kStageBytes);
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load_3d(k_tile(st) + ch * kKv * kLine, &map_k, ch * 64, t * kKv, bh,
                      full + st);
          tma_load_3d(v_tile(st) + ch * kKv * kLine, &map_v, ch * 64, t * kKv, bh,
                      full + st);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows [64 wg, 64 wg + 64) of the block.
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  if (wg == 1) named_arrive(1, 256);  // warpgroup 0 issues first
  const uint32_t sQw = sQ + wg * 64 * kLine;

  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  uint32_t pa[kKv / 16][4];      // P of the previous tile, bf16 A fragments

  // O += P V_st, V as the MN-major B operand: 64-column lines kKv * 128
  // bytes apart (LBO), 8-row groups 1024 bytes apart (SBO).
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int cc = 0; cc < kKv / 16; ++cc)
      wgmma_rs(o_acc, pa[cc],
               desc_sw128(v_tile(st) + cc * 16 * kLine, kKv * kLine, 1024));
  };

  // S = Q K_st^T over D rounded up to 16 (k16 steps of 32 bytes of a line);
  // the first step overwrites S.
  auto issue_qk = [&](int st, float (&s)[kKv / 2]) {
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(s, desc_sw128(sQw + (kk / 4) * kBlockRows * kLine + off, 16, 1024),
               desc_sw128(k_tile(st) + (kk / 4) * kKv * kLine + off, 16, 1024),
               kk > 0);
    }
  };
  // Online softmax of tile t on S (raw logits), in place: s becomes fp32 P,
  // the running max and this thread's row sums move, alpha rescales O.
  auto softmax = [&](int t, float (&s)[kKv / 2], float (&alpha)[2]) {
    if ((t + 1) * kKv > skv) {  // columns past skv
#pragma unroll
      for (int i = 0; i < kKv / 2; ++i) {
        const int col = t * kKv + (i / 4) * 8 + t4 * 2 + (i & 1);
        if (col >= skv) s[i] = -INFINITY;
      }
    }
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kKv / 2; ++i)
      m_tile[(i >> 1) & 1] = fmaxf(m_tile[(i >> 1) & 1], s[i]);
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffff, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffff, m_tile[r], 2));
      const float m_new = fmaxf(m_run[r], m_tile[r]);
      alpha[r] = exp2_ftz((m_run[r] - m_new) * c);  // 0 on the first tile
      m_run[r] = m_new;
      mc[r] = m_new * c;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kKv / 2; ++i) {
      const float p = exp2_ftz(fmaf(s[i], c, -mc[(i >> 1) & 1]));
      s[i] = p;
      l_run[(i >> 1) & 1] += p;
    }
  };
  // S n-tiles 2cc and 2cc + 1 are the A fragment of kv rows [16cc, 16cc + 16).
  auto pack = [&](const float (&s)[kKv / 2]) {
#pragma unroll
    for (int cc = 0; cc < kKv / 16; ++cc) {
      pa[cc][0] = pack_bf16(s[8 * cc + 0], s[8 * cc + 1]);
      pa[cc][1] = pack_bf16(s[8 * cc + 2], s[8 * cc + 3]);
      pa[cc][2] = pack_bf16(s[8 * cc + 4], s[8 * cc + 5]);
      pa[cc][3] = pack_bf16(s[8 * cc + 6], s[8 * cc + 7]);
    }
  };

  mbar_wait(&q_full, 0);
  float s[kKv / 2] = {}, alpha[2];
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
  softmax(0, s, alpha);
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
    softmax(t, s, alpha);
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

// Tensor map over a [bh, rows, D] bf16 tensor loading [box_rows, 64] boxes.
int make_map(CUtensorMap* map, const void* base, int d, int rows, int bh,
             int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_map(map, base, 3, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
           int skv, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, D, sq, bh, kBlockRows);
  if (err == 0) err = make_map(&mk, k, D, skv, bh, C::kKv);
  if (err == 0) err = make_map(&mv, v, D, skv, bh, C::kKv);
  if (err != 0) return err;
  static unsigned sized = 0;
  err = set_smem_once(sd_attention_kernel<D>, C::kSmem, sized);
  if (err != 0) return err;
  const dim3 grid((sq + kBlockRows - 1) / kBlockRows, bh);
  sd_attention_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), sq, skv,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q [bh, sq, d], k/v [bh, skv, d] bf16, 16-byte aligned. Returns a
// cudaError_t value (0 on success); -1 for an unsupported head dim.
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
