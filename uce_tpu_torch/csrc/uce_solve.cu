// Newton-Schulz inverse of the UCE right Gram matrix, for Hopper (sm_90a).
//
// Replaces uce_tpu/ops/pallas/uce_solve.py::_kernel (:87), the body of
// uce_edit_matrix_pallas. As on the TPU it computes, all in fp32,
//
//     B   = lam*I + s * Ce^T Ce + p * Cp^T Cp
//     X_0 = I / ||B||_inf
//     X  <- X (2I - B X)        (iters steps, 40 in the caller)
//
// and leaves X ~= B^-1 for the caller, which forms E = A X and one step of
// iterative refinement with fp32 matmuls outside this file.
//
// What bounds it on this card: the 2 * iters d x d GEMMs, 2 d^3 flops each
// (72.5 GFLOP at d = 768, 40 steps). On the fp32 CUDA cores that is 1.08 ms
// at 67 TFLOP/s; the tensor cores do TF32 at 495 TFLOP/s, but one TF32
// product keeps 11 of fp32's 24 mantissa bits, and the TPU kernel's own note
// (uce_solve.py:70-76) says reduced-precision products do not let
// Newton-Schulz converge. Three TF32 products per fp32 product (3xTF32)
// put the floor at 3 x 72.5 GFLOP / 495 TFLOP/s = 0.44 ms.
//
// Design:
//  - 3xTF32, the Hopper counterpart of the TPU's _dot3 (three bf16 MXU
//    passes): each fp32 operand x is split into big = tf32(x) and
//    small = tf32(x - big) (x - big is exact in fp32; both rounded to
//    nearest with ties away, as cvt.rna.tf32.f32 does, in two integer ops),
//    and A B ~= As Bb + Ab Bs + Ab Bb, the small terms first. The dropped
//    As Bs term is below 2^-22 relative.
//  - The products run on wgmma m64n72k8 TF32: A (64 rows of the left
//    matrix) as register fragments, split as they are read from shared
//    memory; B from shared memory, where TF32 wgmma takes K-major operands
//    only, so each landed k tile of the row-major right matrix is split
//    once into big and small copies laid out transposed, as 8 x 4 core
//    matrices (no swizzle). A in registers spares shared memory the A
//    halves' writes and the products' A reads; the fragments alternate
//    between two register sets, so that one tile's are written while the
//    previous tile's products still read theirs.
//  - The tensor cores' own fp32 accumulation is coarser than fp32 adds
//    rounded to nearest: one accumulator chained through all 3 * d / 8
//    products of a 768-deep dot lands near chip_smoke.py's 1e-3 bar
//    against the fp32 plain version at 100 concepts. So each k tile's 12
//    products go to a fresh accumulator, which fp32 adds fold into the
//    running sum once its group is done, while the next tile is split.
//  - One wave: 64 x 72 output tiles give 12 x 11 = 132 blocks at d = 768,
//    one per SM (the last tile column is 48 wide), one warpgroup each.
//  - K in tiles of 32 through a 4-stage ring fed by TMA (two box loads a
//    tile, issued by one thread, completing on the stage's mbarrier; boxes
//    past d are zero-filled), so three tiles are in flight while one is
//    split and multiplied; the warpgroup that splits the tiles issues no
//    per-thread copies. A tensor map needs 16-byte row strides, so d must
//    be a multiple of 4 (the wrapper checks; CLIP's 768 and 1024 are).
//  - The chain runs as launches on one stream from one C entry point, with
//    no host synchronisation: the Gram build, the row-sum norm, X_0, then
//    per step two GEMMs, the first with the 2I - (.) update fused into its
//    epilogue. The wrapper allocates all scratch.

#include "hopper.cuh"

namespace {

constexpr int BM = 64, BN = 72, BK = 32;  // GEMM block tile
constexpr int kStages = 4;                // load ring depth
constexpr int kGemmThreads = 128;         // one warpgroup
constexpr int kNG = BN / 8;               // 8-column groups of the tile (9)
constexpr int kStageFloats = BM * BK + BK * BN;  // raw A then raw B (17 KB)
constexpr int kTileSplit = BN * BK;       // one half of a split B tile
constexpr int kSplitFloats = 2 * kTileSplit;  // big and small
constexpr int kGemmSmem = 4 * (kStages * kStageFloats + 2 * kSplitFloats) + 1024;
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

// norm[0] = max_i sum_j |B[i][j]| (norm[0] zeroed first): one warp per
// row, grid ceil(d / 32). Row sums are >= 0, so their fp32 bits order as
// the values and an integer atomicMax gives the same maximum in any order.
__global__ void __launch_bounds__(kNormThreads)
norm_inf_kernel(const float* __restrict__ bm, int d, float* __restrict__ norm) {
  const int r = blockIdx.x * (kNormThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= d) return;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += fabsf(bm[(size_t)r * d + c]);
  acc = warp_sum(acc);
  if (lane == 0) atomicMax(reinterpret_cast<int*>(norm), __float_as_int(acc));
}

// X = I / norm[0].
__global__ void scaled_eye_kernel(float* __restrict__ x, int d,
                                  const float* __restrict__ norm) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)d * d) return;
  x[idx] = (idx / d == idx % d) ? 1.f / norm[0] : 0.f;
}

// Raw stage tiles as TMA lands them: A [BM x BK] with the 128-byte swizzle
// (16-byte chunk c / 4 of row r at chunk (c / 4) ^ (r % 8)), B [BK x BN]
// dense. Both are read by split_tile without bank conflicts.
__device__ __forceinline__ int a_index(int r, int c) {
  return r * BK + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}
__device__ __forceinline__ int b_index(int r, int c) { return r * BN + c; }

// One BK step of the A tile (rows row0.., cols k0..) and the B tile (rows
// k0.., cols col0..) by two TMA loads (boxes past d are zero-filled),
// issued by thread 0 and completing on the stage's mbarrier.
__device__ __forceinline__ void load_tiles_tma(float* sa, float* sb, uint64_t* bar,
                                               const CUtensorMap* map_a,
                                               const CUtensorMap* map_b, int row0,
                                               int col0, int k0) {
  if (threadIdx.x != 0) return;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, 4 * kStageFloats);
  tma_load_2d(smem_u32(sa), map_a, k0, row0, bar);
  tma_load_2d(smem_u32(sb), map_b, col0, k0, bar);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32 on finite values, in integer ops.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x -> (big, small) TF32 pair: big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// wgmma descriptor of a K-major operand without swizzle: 8 x 16-byte core
// matrices, `lbo` bytes between K-neighbours and `sbo` between the 8-row
// groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[64 x 72] (+)= A[64 x 8] B[8 x 72]: A TF32 fragments in registers, B
// K-major in shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n72k8(float (&d)[36], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, "
      "%9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Split one landed BK tile: the raw B tile transposed into K-major 8 x 4
// core matrices (no swizzle) at bt, big then small kTileSplit floats on;
// this warp's A fragments (k8 step ks: rows g, g + 8, columns t4, t4 + 4)
// into registers.
__device__ __forceinline__ void split_tile(const float* sa, const float* sb, float* bt,
                                          uint32_t (&ab)[BK / 8][4],
                                          uint32_t (&as)[BK / 8][4]) {
  constexpr int kWarps = kGemmThreads / 32;
  constexpr int kB = (BK / 4) * kNG / kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 4, e = lane % 4;
  float xb[kB], xa[BK / 8][4];
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    const int cm = warp + i * kWarps;
    xb[i] = sb[b_index((cm / kNG) * 4 + e, (cm % kNG) * 8 + r)];
  }
  const int row = warp * 16 + r;
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    xa[ks][0] = sa[a_index(row, ks * 8 + e)];
    xa[ks][1] = sa[a_index(row + 8, ks * 8 + e)];
    xa[ks][2] = sa[a_index(row, ks * 8 + e + 4)];
    xa[ks][3] = sa[a_index(row + 8, ks * 8 + e + 4)];
  }
#pragma unroll
  for (int i = 0; i < kB; ++i) {
    uint32_t big, small;
    split_tf32(xb[i], big, small);
    bt[(warp + i * kWarps) * 32 + lane] = __uint_as_float(big);
    bt[kTileSplit + (warp + i * kWarps) * 32 + lane] = __uint_as_float(small);
  }
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(xa[ks][q], ab[ks][q], as[ks][q]);
}

// The 12 products of one BK tile (3 per k8 step, small terms first) into
// the fresh accumulator part, issued as one wgmma group.
__device__ __forceinline__ void tile_products(const float* bt,
                                              const uint32_t (&ab)[BK / 8][4],
                                              const uint32_t (&as)[BK / 8][4],
                                              float (&part)[36]) {
  const uint32_t bb = smem_u32(bt), bs = bb + 4 * kTileSplit;
  const auto db = [](uint32_t base, int ks) {
    return make_desc(base + ks * 2 * kNG * 128, kNG * 128, 128);
  };
  fence_regs(part);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    wgmma_m64n72k8(part, as[ks], db(bb, ks), ks > 0);
    wgmma_m64n72k8(part, ab[ks], db(bs, ks), 1);
    wgmma_m64n72k8(part, ab[ks], db(bb, ks), 1);
  }
  wgmma_commit();
  fence_regs(part);
}

__device__ __forceinline__ void fold(float (&acc)[36], float (&part)[36]) {
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < 36; ++i) acc[i] += part[i];
}

// C = alpha * A B + diag * I for row-major d x d fp32 matrices, 3xTF32.
// grid (ceil(d / BN), ceil(d / BM)), one warpgroup, kGemmSmem bytes.
// map_a / map_b: tensor maps of A and B (make_map).
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_3xtf32_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   float* __restrict__ c, int d, float alpha, float diag) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];  // stage landed
  // 1024-byte aligned, as the 128-byte swizzle of the A tiles needs.
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024));  // kStages x (A, B)
  float* split = ring + kStages * kStageFloats;     // 2 x split B
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = (d + BK - 1) / BK;
  auto stage_a = [&](int t) { return ring + (t % kStages) * kStageFloats; };
  auto stage_b = [&](int t) { return stage_a(t) + BM * BK; };
  auto load = [&](int t) {
    load_tiles_tma(stage_a(t), stage_b(t), full + t % kStages, &map_a, &map_b,
                   row0, col0, t * BK);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) load(t);
  }
  float acc[36], part[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) acc[i] = 0.f;

  // Tile t: land it, refill the stage that tile t - 1 used, split it, then
  // fold tile t - 1's products (which ran during the split) into acc and
  // issue tile t's. acc is read only once its group is complete, so the
  // products of one tile overlap the split of the next.
  // A fragments alternate between two register sets, so that tile t + 1's
  // are written while tile t's products still read theirs.
  uint32_t ab0[BK / 8][4], as0[BK / 8][4], ab1[BK / 8][4], as1[BK / 8][4];
  auto step = [&](int t, uint32_t (&ab)[BK / 8][4], uint32_t (&as)[BK / 8][4]) {
    mbar_wait(full + t % kStages, (t / kStages) & 1);
    __syncthreads();  // tile t landed; tile t - 1's stage is free
    const int next = t + kStages - 1;
    if (next < nk) load(next);
    float* bt = split + (t & 1) * kSplitFloats;  // tile t - 2's group is done
    split_tile(stage_a(t), stage_b(t), bt, ab, as);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the split tile is complete for wgmma
    wgmma_wait<0>();
    if (t > 0) fold(acc, part);
    tile_products(bt, ab, as, part);
  };
  for (int t = 0; t < nk; t += 2) {
    step(t, ab0, as0);
    if (t + 1 < nk) step(t + 1, ab1, as1);
  }
  wgmma_wait<0>();
  fold(acc, part);

  // Rows 16 warp + g (+ 8), columns 8 j + 2 t4 (+ 1) of the tile.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < kNG; ++j) {
    const int cc = col0 + j * 8 + t4 * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + warp * 16 + g + h * 8;
      if (r >= d) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (cc + e < d)
          c[(size_t)r * d + cc + e] =
              alpha * acc[4 * j + 2 * h + e] + (r == cc + e ? diag : 0.f);
      }
    }
  }
}

}  // namespace

// A tensor map over a row-major d x d fp32 matrix, loading boxes of `rows`
// rows x `cols` columns; boxes past the edge are zero-filled.
static int make_map(CUtensorMap* map, float* base, int d, int rows, int cols,
                    CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)d};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)rows};
  return encode_map(map, base, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    swizzle);
}

#define UCE_CHECK_LAUNCH()                       \
  do {                                           \
    const cudaError_t e = cudaGetLastError();    \
    if (e != cudaSuccess) return (int)e;         \
  } while (0)

// ce [ke, d], cp [kp, d] (kp may be 0), x [d, d] out; scratch: bm, t, xn
// [d, d] each and norm [1], all fp32, 16-byte aligned; d % 4 == 0. Returns
// a cudaError_t value.
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
  const cudaError_t zeroed = cudaMemsetAsync(np, 0, sizeof(float), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  norm_inf_kernel<<<(d + kNormThreads / 32 - 1) / (kNormThreads / 32),
                    kNormThreads, 0, s>>>(bmp, d, np);
  UCE_CHECK_LAUNCH();
  float* cur = static_cast<float*>(x);
  float* other = static_cast<float*>(xn);
  const int n = d * d;
  scaled_eye_kernel<<<(n + 255) / 256, 256, 0, s>>>(cur, d, np);
  UCE_CHECK_LAUNCH();
  const dim3 grid((d + BN - 1) / BN, (d + BM - 1) / BM);
  const cudaError_t sized = cudaFuncSetAttribute(
      gemm_3xtf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (sized != cudaSuccess) return (int)sized;
  // Maps of each matrix as the left (A: 64 x 32 boxes, swizzled) and the
  // right operand (B: 32 x 72 boxes) of a GEMM.
  CUtensorMap left[3], right[3];  // B, X, X_next / X, X_next, T
  float* mats[4] = {bmp, cur, other, tp};
  for (int i = 0; i < 3; ++i) {
    int e = make_map(left + i, mats[i], d, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == 0) e = make_map(right + i, mats[i + 1], d, BK, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != 0) return e;
  }
  for (int it = 0; it < iters; ++it) {
    const int xi = it % 2;  // X in x (0) or xn (1)
    gemm_3xtf32_kernel<<<grid, kGemmThreads, kGemmSmem, s>>>(left[0], right[xi], tp, d,
                                                             -1.f, 2.f);
    UCE_CHECK_LAUNCH();
    gemm_3xtf32_kernel<<<grid, kGemmThreads, kGemmSmem, s>>>(left[1 + xi], right[2],
                                                             other, d, 1.f, 0.f);
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
