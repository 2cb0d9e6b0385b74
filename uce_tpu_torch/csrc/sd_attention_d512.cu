// Single-head attention at head dim 512, softmax(q k^T * scale) v over
// [B*H, S, 512] bf16 tensors, for Hopper (sm_90a): the VAE mid-block.
//
// Replaces uce_tpu/ops/attention.py::_flash_attention (:96), JAX's bundled
// TPU flash kernel, which serves the VAE mid-block attention (s = 4096,
// D = 512, one head) on the TPU because the sd_attention VMEM gate rejects
// D = 512.
//
// Numerics are those of sd_attention.cu and of sd_attention_reference:
// QK^T accumulates in fp32 and is scaled there, the softmax runs in fp32
// with max subtraction (online, over 32-row K/V tiles), P is rounded to
// bf16, PV accumulates in fp32, and O is normalised by the fp32 row sum
// after PV; the output is bf16.
//
// What bounds it on this card: tensor-core work, 4 * S^2 * D flops
// (34.4 GFLOP at s = 4096: 0.035 ms at 989 TFLOP/s), against 16 MB of
// q/k/v/o traffic. A thread cannot hold a 64 x 512 fp32 O tile alone, and
// the earlier kernel split D across blocks, recomputing the 512-deep QK^T
// in every 64-column slice (9 * 2 * S^2 * D flops) from synchronous loads,
// with one 142 KB block per SM.
//
// Design:
//  - QK^T once, O whole in registers. One block of two warpgroups per
//    (batch*head, 64 query rows, KV split). Warpgroup w owns output columns
//    [256w, 256w + 256): a wgmma m64n256 fp32 accumulator, 128 registers a
//    thread. For S = Q K^T each warpgroup runs wgmma m64n32k16 over its own
//    256-wide half of the contraction; the two fp32 partial S tiles are
//    summed through shared memory (each warpgroup adds the other's tile to
//    its own: a + b == b + a, so both hold the same S), both run the same
//    online softmax, and P goes as bf16 register A fragments into wgmma
//    m64n256k16 against the V tile. MMA work is the minimal 4 * S^2 * D.
//  - No V transpose: V tiles land as they lie in HBM ([kv, D], 128-byte
//    swizzled lines) and wgmma reads them as an MN-major B operand. Q and
//    K tiles use the same layout as K-major operands.
//  - Asynchronous loads: all 256 threads issue 16-byte cp.async copies into
//    a double-buffered K/V ring. K runs two tiles ahead and V one, so one
//    barrier an iteration both publishes the next tiles and frees the
//    stage being refilled. Shared memory: Q 64 KB + 2 x (K 32 KB + V 32 KB)
//    + 2 x 16 KB for the S exchange = 224 KB, one block per SM. No
//    producer warp: without one the consumers keep 255 registers each
//    without setmaxnreg.
//  - Fill the card: at batch*head 1 there are 64 query tiles for 132 SMs,
//    so the wrapper splits the KV range (sd_attention.py::d512_splits).
//    Each split writes its unnormalised fp32 O and its per-row (m, l) in
//    log2 units to a workspace, and merge_kernel rescales, sums and
//    normalises. With one split the block writes bf16 directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 512;
constexpr int kRows = 64;            // query rows per block
constexpr int kKv = 32;              // K/V rows per tile
constexpr int kLine = 128;           // bytes per swizzled shared line (64 bf16)
constexpr int kChunks = D / 64;      // 64-column chunks of a row
constexpr int kThreads = 256;        // two warpgroups
constexpr int kQBytes = kChunks * kRows * kLine;  // 64 KB
constexpr int kTileBytes = kChunks * kKv * kLine; // 32 KB
constexpr int kXFloats = 16 * 128;   // one warpgroup's partial S tile
constexpr int kSmemBytes = kQBytes + 4 * kTileBytes + 4 * kXFloats * 4 + 1024;
constexpr int kMergeThreads = D / 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy rows [0, kRowsT) of a [rows, 512] bf16 tile into shared memory as
// kChunks blocks of kRowsT 128-byte lines, 16-byte units XOR-swizzled by
// the line index (the 128-byte swizzle that wgmma descriptors name); rows
// at or past `valid` are zero-filled.
template <int kRowsT>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int valid) {
#pragma unroll
  for (int i = threadIdx.x; i < kRowsT * 64; i += kThreads) {
    const int r = i / 64, u = i % 64;  // row, 16-byte unit along the row
    const uint32_t s = dst + (u / 8) * (kRowsT * kLine) + r * kLine +
                       (((u % 8) ^ (r % 8)) << 4);
    const bool ok = r < valid;
    const __nv_bfloat16* g = ok ? src + (size_t)r * D + u * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(ok ? 16 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Make this thread's landed cp.async data visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all >> 4). Buffers are 1024-byte aligned, so the
// base offset field stays 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pin accumulator registers in program order around the asynchronous
// wgmma (the compiler does not know that wgmma writes them late).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x 32] += A[64 x 16] B[16 x 32]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 256] += A[64 x 16] B[16 x 256]: A bf16 fragments in registers, B
// MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (ceil(sq / 64), batch*head, splits); split z covers KV tiles
// [z * per, min((z + 1) * per, ceil(skv / 32))). out != nullptr: bf16
// output (one split); else o_part [splits, bh, sq, 512] fp32 unnormalised
// and ml [splits, bh, sq, 2] (row max in log2 units, row sum).
__global__ void __launch_bounds__(kThreads, 1)
sd_attention_d512_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ o_part, float* __restrict__ ml,
                         int sq, int skv, int per, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kQBytes;            // 2 stages
  const uint32_t sV = sK + 2 * kTileBytes;     // 2 stages
  float* sX = reinterpret_cast<float*>(base_ptr + kQBytes + 4 * kTileBytes);

  const int bh = blockIdx.y, split = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int wq = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int n_tiles = (skv + kKv - 1) / kKv;
  const int t_begin = split * per, t_end = min(n_tiles, t_begin + per);
  const int n = t_end - t_begin;

  const __nv_bfloat16* kb = k + (size_t)bh * skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * skv * D;
  auto kv_rows = [&](int t) { return min(kKv, skv - (t_begin + t) * kKv); };
  auto kv_src = [&](const __nv_bfloat16* b, int t) {
    return b + (size_t)(t_begin + t) * kKv * D;
  };

  // Prologue: Q and K_0, then V_0 and K_1.
  load_tile<kRows>(sQ, q + ((size_t)bh * sq + row0) * D, min(kRows, sq - row0));
  load_tile<kKv>(sK, kv_src(kb, 0), kv_rows(0));
  cp_async_commit();
  load_tile<kKv>(sV, kv_src(vb, 0), kv_rows(0));
  if (n > 1) load_tile<kKv>(sK + kTileBytes, kv_src(kb, 1), kv_rows(1));
  cp_async_commit();
  cp_async_wait<1>();
  fence_async_shared();
  __syncthreads();

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n; ++t) {
    const int st = t & 1;
    // S_t = Q K_t^T over this warpgroup's half of D (4 chunks of 64).
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int chunk = wg * 4 + kk / 4;
      const uint32_t off = (kk % 4) * 32;
      wgmma_m64n32k16(s, make_desc(sQ + chunk * (kRows * kLine) + off, 16, 1024),
                      make_desc(sK + st * kTileBytes + chunk * (kKv * kLine) + off,
                                16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();  // S_t and the previous PV are complete
    fence_regs(s);
    fence_regs(o);

    float* mine = sX + ((st * 2 + wg) * kXFloats);
    const float* theirs = sX + ((st * 2 + (1 - wg)) * kXFloats);
#pragma unroll
    for (int i = 0; i < 16; ++i) mine[i * 128 + tid] = s[i];
    // V_t and K_{t+1} landed (this thread's copies), then one barrier: every
    // thread's copies and partial S are visible, and every warpgroup is done
    // with K_t and V_{t-1}, whose stages the next copies refill.
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    if (t + 1 < n) load_tile<kKv>(sV + (st ^ 1) * kTileBytes, kv_src(vb, t + 1),
                                  kv_rows(t + 1));
    if (t + 2 < n) load_tile<kKv>(sK + st * kTileBytes, kv_src(kb, t + 2),
                                  kv_rows(t + 2));
    cp_async_commit();

    // Online softmax in log2 units on the summed S; columns past skv are
    // masked out.
    const int col0 = (t_begin + t) * kKv;
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = col0 + (i / 4) * 8 + t4 * 2 + (i & 1);
      const float x = col < skv ? (s[i] + theirs[i * 128 + tid]) * scale_log2
                                : -INFINITY;
      s[i] = x;
      m_tile[(i >> 1) & 1] = fmaxf(m_tile[(i >> 1) & 1], x);
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
    for (int i = 0; i < 16; ++i) {
      const float p = exp2f(s[i] - m_new[(i >> 1) & 1]);
      s[i] = p;
      l_tile[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_tile[r] += __shfl_xor_sync(0xffffffff, l_tile[r], 1);
      l_tile[r] += __shfl_xor_sync(0xffffffff, l_tile[r], 2);
      l_run[r] = l_run[r] * alpha[r] + l_tile[r];
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V_t: the S n-tiles 2c and 2c + 1 are the A fragment of kv rows
    // [16c, 16c + 16); V_t's rows are wgmma's K and its columns N.
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kKv / 16; ++c) {
      const uint32_t pa[4] = {pack_bf16(s[8 * c + 0], s[8 * c + 1]),
                              pack_bf16(s[8 * c + 2], s[8 * c + 3]),
                              pack_bf16(s[8 * c + 4], s[8 * c + 5]),
                              pack_bf16(s[8 * c + 6], s[8 * c + 7])};
      wgmma_m64n256k16_rs(
          o, pa,
          make_desc(sV + st * kTileBytes + wg * 4 * (kKv * kLine) + c * 16 * kLine,
                    kKv * kLine, 1024));
    }
    wgmma_commit();
    fence_regs(o);
  }
  wgmma_wait<0>();
  fence_regs(o);

  // Rows 16 wq + g (+ 8) of the block; columns 256 wg + 8 j + 2 t4 (+ 1).
  const size_t rows = (size_t)gridDim.y * sq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wq * 16 + g + h * 8;
    if (r >= sq) continue;
    const size_t row = (size_t)bh * sq + r;
    if (out != nullptr) {
      const float inv = 1.f / l_run[h];
      __nv_bfloat16* orow = out + row * D + wg * 256 + t4 * 2;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = __floats2bfloat162_rn(
            o[j * 4 + h * 2] * inv, o[j * 4 + h * 2 + 1] * inv);
    } else {
      const size_t prow = split * rows + row;
      float* orow = o_part + prow * D + wg * 256 + t4 * 2;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<float2*>(orow + j * 8) =
            make_float2(o[j * 4 + h * 2], o[j * 4 + h * 2 + 1]);
      if (wg == 0 && t4 == 0)
        *reinterpret_cast<float2*>(ml + prow * 2) = make_float2(m_run[h], l_run[h]);
    }
  }
}

// out[row] = sum_i 2^(m_i - m) O_i[row] / sum_i 2^(m_i - m) l_i, m = max_i m_i;
// one block of 128 threads per row, 4 columns a thread.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ o_part, const float* __restrict__ ml,
             __nv_bfloat16* __restrict__ out, int rows, int splits) {
  const size_t row = blockIdx.x;
  float m = -INFINITY;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, ml[(i * (size_t)rows + row) * 2]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < splits; ++i) {
    const size_t prow = i * (size_t)rows + row;
    const float w = exp2f(ml[prow * 2] - m);
    l += w * ml[prow * 2 + 1];
    const float4 x = reinterpret_cast<const float4*>(o_part + prow * D)[threadIdx.x];
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const float inv = 1.f / l;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + row * D) + 2 * threadIdx.x;
  o2[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  o2[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
}

}  // namespace

// q [bh, sq, 512], k/v [bh, skv, 512] bf16; `per` KV tiles of 32 rows per
// split, `splits` splits. splits == 1: out [bh, sq, 512] bf16, o_part and
// ml unused; else o_part [splits, bh, sq, 512] and ml [splits, bh, sq, 2]
// fp32, out unused. Returns a cudaError_t value.
extern "C" int sd_attention_d512(const void* q, const void* k, const void* v,
                                 void* out, void* o_part, void* ml, int bh,
                                 int sq, int skv, int per, int splits,
                                 float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sd_attention_d512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kRows - 1) / kRows, bh, splits);
  sd_attention_d512_kernel<<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      splits == 1 ? static_cast<__nv_bfloat16*>(out) : nullptr,
      static_cast<float*>(o_part), static_cast<float*>(ml), sq, skv, per,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// o_part [splits, rows, 512], ml [splits, rows, 2] fp32 -> out [rows, 512]
// bf16. Returns a cudaError_t value.
extern "C" int sd_attention_d512_merge(const void* o_part, const void* ml,
                                       void* out, int rows, int splits,
                                       void* stream) {
  merge_kernel<<<rows, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml),
      static_cast<__nv_bfloat16*>(out), rows, splits);
  return (int)cudaGetLastError();
}
