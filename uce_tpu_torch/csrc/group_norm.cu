// GroupNorm (+ optional SiLU) over NHWC bf16 maps, for Hopper (sm_90a).
//
// Replaces uce_tpu/ops/pallas/group_norm.py::group_norm_act (_stats_kernel
// and _apply_kernel). It computes what the TPU kernels compute, with the
// same one-pass statistics: per-channel sums of x and x^2 in fp32, folded
// into group mean and rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps), then
// into per-channel gamma/beta; the apply is y = x * gamma + beta, followed
// by SiLU when asked.
//
// What bounds it: memory. The floor is one read of x and one write of y.
// The TPU carries the channel sums across row tiles in VMEM because its
// grid runs in order; Hopper blocks run in parallel, so the sums have to
// cross blocks. Two schedules, picked per shape by ops/kernels/group_norm.py
// ::plan; neither uses float atomics, so a result repeats bit for bit.
//
// Resident (one launch, x read once): one thread-block cluster per (image,
// channel slab), the slab a whole number of groups and of 8-channel
// vectors. Each block TMA-loads its share of the H*W rows x slab into
// shared memory and sums x and x^2 per channel; the blocks exchange their
// partial sums through distributed shared memory after a cluster barrier
// and fold them in rank order, so every block derives the same gamma/beta,
// then applies them to the rows it holds and writes y.
//
// Streaming (maps whose slab does not fit a cluster's shared memory, the
// VAE's 256^2 and 512^2 levels, and the largest maps, where it measured
// faster: a resident block loads, sums, waits on the cluster and applies in
// turn, while these kernels keep loads and arithmetic in flight together):
// gn_partial_kernel writes one fp32 partial sum per (batch, row tile,
// channel) to a workspace, gn_fold_kernel reduces one group's partials in a
// fixed order into gamma/beta, and gn_apply_kernel streams x once more
// (from L2 where the map fits).
//
// Every load and store of x and y moves 16 bytes (8 channels) per thread.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kVec = 8;  // bf16 channels per 16-byte access
constexpr int kFoldThreads = 256;
constexpr int kMaxBands = 8;  // row bands of TMA boxes of a resident block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffff, v, off);
  return v;
}

// Add the sums of x and x^2 of 8 bf16 channels to s1, s2.
__device__ __forceinline__ void add_sums(const uint4& raw, float (&s1)[kVec],
                                         float (&s2)[kVec]) {
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

// y = x * gamma + beta (then SiLU) for 8 channels.
template <bool kSilu>
__device__ __forceinline__ uint4 apply8(const uint4& raw, const float (&gv)[kVec],
                                        const float (&bv)[kVec]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 packed;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    float v0 = f.x * gv[2 * j] + bv[2 * j];
    float v1 = f.y * gv[2 * j + 1] + bv[2 * j + 1];
    if (kSilu) {  // fast division: 0 where exp(-v) overflows, as SiLU -> 0
      v0 = __fdividef(v0, 1.f + __expf(-v0));
      v1 = __fdividef(v1, 1.f + __expf(-v1));
    }
    o2[j] = __floats2bfloat162_rn(v0, v1);
  }
  return packed;
}

// Shared memory of a resident block: the x tile [rows][slab] bf16 at a
// 128-byte boundary (TMA's destination rule), then the lanes' sums
// [2][lanes][slab], the block's partial sums [2][slab] (read by the other
// blocks of the cluster), every rank's partials [cluster][2][slab] and
// gamma/beta [2][slab], fp32.
__host__ __device__ inline int resident_smem(int rows, int slab, int threads,
                                             int cluster) {
  const int lanes = threads / (slab / kVec);
  return 128 + rows * slab * 2 + 4 * (2 * lanes * slab + (4 + 2 * cluster) * slab);
}

// Barrier over all threads of the cluster, split: arrive (release) and
// wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Cluster (slab s, image b) of gridDim.x / cluster_size slabs: block rank r
// holds rows [r * rows, min((r + 1) * rows, hw)) of channels
// [s * slab, (s + 1) * slab), loaded as (rows / box_rows) x (slab / box_c)
// TMA boxes (a box takes at most 256 channels) laid out [slab / box_c][rows]
// [box_c]; each row band completes on its own mbarrier, so that the sums
// start on the first band while the others land. Thread (lane_row, cv)
// works on channels [8 cv, 8 cv + 8) of the slab and rows lane_row,
// lane_row + lanes, ...
template <bool kSilu>
__global__ void gn_cluster_kernel(const __grid_constant__ CUtensorMap map_x,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ bias,
                                  __nv_bfloat16* __restrict__ y, int hw, int c,
                                  int slab, int box_c, int cgroup, int rows,
                                  int box_rows, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar[kMaxBands];
  unsigned char* smem = smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int c0 = (blockIdx.x / csize) * slab, b = blockIdx.y;
  const int nv = slab / kVec, lanes = blockDim.x / nv, ncb = slab / box_c;
  const int cv = threadIdx.x % nv, lane_row = threadIdx.x / nv;
  const bool active = lane_row < lanes;
  const int r0 = rank * rows, nvalid = min(rows, hw - r0);  // >= 1 (plan)
  const int bands = (nvalid + box_rows - 1) / box_rows;    // none wholly past hw
  // this thread's 8 channels in row 0 of the tile; row r is r * box_c further
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem) +
                            (cv * kVec / box_c) * rows * box_c + cv * kVec % box_c;
  float* red = reinterpret_cast<float*>(smem + rows * slab * 2);
  float* part = red + 2 * lanes * slab;
  float* parts = part + 2 * slab;  // [csize][2][slab], every rank's partials
  float* gb = parts + 2 * csize * slab;

  if (threadIdx.x == 0) {
    for (int i = 0; i < bands; ++i) mbar_init(bar + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < bands; ++i) {
      mbar_expect_tx(bar + i, (uint32_t)box_rows * slab * 2);
      for (int j = 0; j < ncb; ++j)
        tma_load_3d(smem_u32(smem) + (j * rows + i * box_rows) * box_c * 2, &map_x,
                    c0 + j * box_c, r0 + i * box_rows, b, bar + i);
    }
  }

  // This block's per-channel sums: each thread over its rows in order (as
  // their bands land), then the lanes in order.
  if (active) {
    float s1[kVec], s2[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
    int landed = 0;  // rows known to be in shared memory
    for (int r = lane_row; r < nvalid; r += lanes) {
      if (r >= landed) {
        mbar_wait(bar + r / box_rows, 0);
        landed = (r / box_rows + 1) * box_rows;
      }
      add_sums(*reinterpret_cast<const uint4*>(xs + r * box_c), s1, s2);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      red[lane_row * slab + cv * kVec + j] = s1[j];
      red[(lanes + lane_row) * slab + cv * kVec + j] = s2[j];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < slab; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a += red[l * slab + ch];
      q += red[(lanes + l) * slab + ch];
    }
    part[ch] = a;
    part[slab + ch] = q;
  }
  // Gather every rank's partials through distributed shared memory, four
  // loads in flight per thread, then fold them in rank order. The block
  // waits for the others' arrival on the second barrier (they are done
  // reading its partials) only at its very end.
  cluster_arrive();
  cluster_wait();
  const int total = csize * 2 * slab;
  for (int i0 = threadIdx.x; i0 < total; i0 += 4 * blockDim.x) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = i < total ? cluster.map_shared_rank(part, i / (2 * slab))[i % (2 * slab)]
                       : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * blockDim.x < total) parts[i0 + u * blockDim.x] = v[u];
  }
  cluster_arrive();
  __syncthreads();
  // Per channel: the ranks in order (into red, free again; part may still
  // be read by the other blocks); then per group: its channels in order.
  for (int k = threadIdx.x; k < 2 * slab; k += blockDim.x) {
    float a = 0.f;
    for (int r = 0; r < csize; ++r) a += parts[r * 2 * slab + k];
    red[k] = a;
  }
  __syncthreads();
  const float n = (float)hw * (float)cgroup;
  for (int ch = threadIdx.x; ch < slab; ch += blockDim.x) {
    const int g0 = ch / cgroup * cgroup;
    float a = 0.f, q = 0.f;
    for (int i = 0; i < cgroup; ++i) {
      a += red[g0 + i];
      q += red[slab + g0 + i];
    }
    const float mean = a / n;
    const float rstd = rsqrtf(fmaxf(q / n - mean * mean, 0.f) + eps);
    const float gamma = scale[c0 + ch] * rstd;
    gb[ch] = gamma;
    gb[slab + ch] = bias[c0 + ch] - mean * gamma;
  }
  __syncthreads();
  if (active) {
    float gv[kVec], bv[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      gv[j] = gb[cv * kVec + j];
      bv[j] = gb[slab + cv * kVec + j];
    }
    __nv_bfloat16* yb = y + ((size_t)b * hw + r0) * c + c0 + cv * kVec;
    for (int r = lane_row; r < nvalid; r += lanes)
      *reinterpret_cast<uint4*>(yb + (size_t)r * c) =
          apply8<kSilu>(*reinterpret_cast<const uint4*>(xs + r * box_c), gv, bv);
  }
  cluster_wait();
}

// Streaming statistics. Block (tile, b) of blockDim = (c / 8) * row_lanes
// threads: thread (lane_row, cv) sums channels [8 cv, 8 cv + 8) over rows
// r0 + lane_row, r0 + lane_row + row_lanes, ... of the tile; the lanes are
// then added in shared memory and the block writes ws[b][tile][0|1][c].
__global__ void gn_partial_kernel(const __nv_bfloat16* __restrict__ x,
                                  float* __restrict__ ws, int hw, int c,
                                  int rows_per_tile, int row_lanes) {
  extern __shared__ float red_s[];  // [2][row_lanes][c]
  const int tile = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int ncv = c / kVec;
  const int cv = threadIdx.x % ncv, lane_row = threadIdx.x / ncv;
  const int r0 = tile * rows_per_tile, r1 = min(hw, r0 + rows_per_tile);
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
  const __nv_bfloat16* xb = x + (size_t)b * hw * c + cv * kVec;
  for (int r = r0 + lane_row; r < r1; r += row_lanes)
    add_sums(*reinterpret_cast<const uint4*>(xb + (size_t)r * c), s1, s2);
  float* red1 = red_s;
  float* red2 = red_s + row_lanes * c;
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
  __shared__ float fold[2][kFoldThreads / 32];
  const int g = blockIdx.x, b = blockIdx.y, cg_ = c / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float a = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < tiles * cg_; i += kFoldThreads) {
    const float* p = ws + ((size_t)b * tiles + i / cg_) * 2 * c + g * cg_ + i % cg_;
    a += p[0];
    q += p[c];
  }
  a = warp_sum(a);
  q = warp_sum(q);
  if (lane == 0) {
    fold[0][warp] = a;
    fold[1][warp] = q;
  }
  __syncthreads();
  a = q = 0.f;
#pragma unroll
  for (int w = 0; w < kFoldThreads / 32; ++w) {
    a += fold[0][w];
    q += fold[1][w];
  }
  const float mean = a / n;
  const float rstd = rsqrtf(fmaxf(q / n - mean * mean, 0.f) + eps);
  for (int j = threadIdx.x; j < cg_; j += kFoldThreads) {
    const int ch = g * cg_ + j;
    const float gamma = scale[ch] * rstd;
    gb[(size_t)b * 2 * c + ch] = gamma;
    gb[(size_t)b * 2 * c + c + ch] = bias[ch] - mean * gamma;
  }
}

// Streaming apply. Block (i, b) of (c / 8) * row_lanes threads: thread
// (lane_row, cv) keeps the gamma/beta of channels [8 cv, 8 cv + 8) in
// registers and walks rows lane_row + row_lanes * (i + gridDim.x * k).
template <bool kSilu>
__global__ void gn_apply_kernel(const __nv_bfloat16* __restrict__ x,
                                const float* __restrict__ gb,
                                __nv_bfloat16* __restrict__ y, int hw, int c,
                                int row_lanes) {
  const int ncv = c / kVec, b = blockIdx.y;
  const int cv = threadIdx.x % ncv, lane_row = threadIdx.x / ncv;
  float gv[kVec], bv[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    gv[j] = gb[(size_t)b * 2 * c + cv * kVec + j];
    bv[j] = gb[(size_t)b * 2 * c + c + cv * kVec + j];
  }
  const size_t base = (size_t)b * hw * c + cv * kVec;
  const int stride = gridDim.x * row_lanes;
  for (int r = blockIdx.x * row_lanes + lane_row; r < hw; r += stride) {
    const size_t i = base + (size_t)r * c;
    *reinterpret_cast<uint4*>(y + i) =
        apply8<kSilu>(*reinterpret_cast<const uint4*>(x + i), gv, bv);
  }
}

template <bool kSilu>
int launch_resident(const void* x, const void* scale, const void* bias, void* y,
                    int b, int hw, int c, int groups, int slab, int box_c,
                    int cluster, int rows, int box_rows, int threads, float eps,
                    cudaStream_t stream) {
  static unsigned ready = 0;  // a bit per device: attributes set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !((ready >> dev) & 1u)) {
    // All the shared memory a block may have, less the kernel's static part.
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, gn_cluster_kernel<kSilu>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gn_cluster_kernel<kSilu>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gn_cluster_kernel<kSilu>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) ready |= 1u << dev;
  }
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)hw, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)hw * c * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_c, (cuuint32_t)box_rows, 1};
  if (encode_map(&map, x, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 CU_TENSOR_MAP_SWIZZLE_NONE) != 0)
    return -2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c / slab * cluster, b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = resident_smem(rows, slab, threads, cluster);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<kSilu>, map,
                         static_cast<const float*>(scale), static_cast<const float*>(bias),
                         static_cast<__nv_bfloat16*>(y), hw, c, slab, box_c, c / groups,
                         rows, box_rows, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The resident schedule (ops/kernels/group_norm.py::plan): x, y [b, hw, c]
// bf16, 16-byte aligned; scale, bias [c] fp32; c / slab clusters of
// `cluster` blocks per image, each block `rows` rows (a multiple of
// box_rows, at most 256, in at most 8 bands) of `threads` threads, its
// slab loaded in boxes of box_c <= 256 channels. Returns a cudaError_t value
// (0 on success), or -2 if x's tensor map cannot be encoded.
extern "C" int group_norm_act_resident(const void* x, const void* scale,
                                       const void* bias, void* y, int b, int hw,
                                       int c, int groups, int slab, int box_c,
                                       int cluster, int rows, int box_rows,
                                       int threads, float eps, int silu,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return silu ? launch_resident<true>(x, scale, bias, y, b, hw, c, groups, slab,
                                      box_c, cluster, rows, box_rows, threads, eps, s)
              : launch_resident<false>(x, scale, bias, y, b, hw, c, groups, slab,
                                       box_c, cluster, rows, box_rows, threads, eps, s);
}

// The streaming schedule: x, y [b, hw, c] bf16 (c % 8 == 0, c / 8 *
// row_lanes <= 1024 threads); scale, bias [c] fp32; ws [b, tiles, 2, c] fp32
// with tiles = ceil(hw / rows_per_tile); gb [b, 2, c] fp32; apply_blocks
// blocks per image for the apply. Returns a cudaError_t value.
extern "C" int group_norm_act_stream(const void* x, const void* scale,
                                     const void* bias, void* y, void* ws, void* gb,
                                     int b, int hw, int c, int groups,
                                     int rows_per_tile, int row_lanes,
                                     int apply_blocks, float eps, int silu,
                                     void* stream) {
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
  const dim3 grid(apply_blocks, b);
  if (silu)
    gn_apply_kernel<true><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gb),
        static_cast<__nv_bfloat16*>(y), hw, c, row_lanes);
  else
    gn_apply_kernel<false><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gb),
        static_cast<__nv_bfloat16*>(y), hw, c, row_lanes);
  return (int)cudaGetLastError();
}
