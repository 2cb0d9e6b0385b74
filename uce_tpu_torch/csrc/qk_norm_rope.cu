// FLUX's per-head QK RMSNorm and 3-axis RoPE, for Hopper (sm_90a), in one
// pass over a block's q and k.
//
// Replaces no Pallas kernel: uce_tpu/models/flux.py:69-100 (_rms,
// rope_freqs, apply_rope) leaves this work to XLA, which fuses it. In
// PyTorch the same composition (_rms on each _heads view, torch.cat of the
// text and image halves, apply_rope) is some twenty launches of elementwise,
// cast and copy kernels that move about 2.5 GB a tensor per block at FLUX's
// shape; this kernel reads q and k once and writes them once.
//
// Per block of the DiT: up to two row segments (text, then image), each a
// q and a k projection output [B, S_seg, H * 128] bf16 with its own bf16
// [128] norm scales, and the fp32 cos/sin tables [S, 128] of the joint
// sequence (S = sum of S_seg). Output: q and k [B, H, S, 128] bf16, the
// layout the joint attention reads, the text rows first.
//
// For each (b, s, h) row x of 128:
//   n = bf16(x * rsqrt(mean(x^2) + eps))     (fp32 arithmetic)
//   y = bf16(n * scale)                      (one rounding of the exact product)
//   out[2j]   = bf16(y[2j] * cos[2j] + (-y[2j+1]) * sin[2j])
//   out[2j+1] = bf16(y[2j+1] * cos[2j+1] + y[2j] * sin[2j+1])
// which rounds where the plain PyTorch version rounds; the products and
// sums are taken with __fmul_rn / __fadd_rn, so nothing contracts them into
// an FMA that the plain version (separate kernels) does not have. The sum
// of squares is taken in the order of PyTorch's CUDA mean over a row of
// 128 fp32 values (ATen/native/cuda/Reduce.cuh: 32 threads, thread j
// summing its 4-vector j left to right, then a warp tree whose shuffle
// offset falls from 16 to 1). Here thread t of the row's 16 holds vectors
// 2t and 2t + 1 (dims 8t..8t+7) and carries both sums through the tree's
// first four levels (lane offsets 8 to 1 are vector offsets 16 to 2), then
// adds them (offset 1). So the kernel gives the plain version's bits on the
// card wherever PyTorch reduces so.
//
// What bounds it: memory. At FLUX.1-schnell's 1024^2 shape (B 2, H 24,
// S 256 + 4096) one launch reads and writes 2 x 53.5 MB each way: 218 MB
// with the tables, 65 us at 3.35 TB/s. Design: 16 threads per row, each
// with one 16-byte load and store (so every interleaved RoPE pair sits in
// one thread); a block of kPos consecutive positions for one batch row and
// one group of kRows of the 2H rows (q's heads, then k's), its threads
// keeping their position's cos, sin and scale values in registers; a warp
// covers two positions of one head at a time, so a block's stores fill
// kPos * 256 contiguous bytes of each head; each thread issues its next
// kBatch rows' loads before the arithmetic of the current ones. The 4.5 MB
// tables stay in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDim = 128;               // head dim
constexpr int kVec = 4;                 // the values of one PyTorch reduce vector
constexpr int kLanes = 16;              // threads per row, 8 values each
constexpr int kThreads = 64;
constexpr int kPos = kThreads / kLanes;  // sequence positions per block
constexpr int kBatch = 2;               // rows of loads in flight per thread
constexpr int kRows = 24;               // rows per position and block

struct Segments {
  const __nv_bfloat16* q[2];
  const __nv_bfloat16* k[2];
  const __nv_bfloat16* q_scale[2];
  const __nv_bfloat16* k_scale[2];
  int len0;  // rows of the first segment; the second holds the rest
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[2 * kVec]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// ((v0^2 + v1^2) + v2^2) + v3^2, each square rounded, as PyTorch sums a
// 4-vector of the squared tensor
__device__ __forceinline__ float vec_sum_sq(const float* v) {
  float acc = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int j = 1; j < kVec; ++j) acc = __fadd_rn(acc, __fmul_rn(v[j], v[j]));
  return acc;
}

// rows [r0, r0 + kBatch) of a position, those below r_end (zeros past it)
__device__ __forceinline__ void load_rows(uint4 (&raw)[kBatch], const __nv_bfloat16* q_src,
                                          const __nv_bfloat16* k_src, int r0, int r_end,
                                          int heads, int d0) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int r = r0 + i;
    raw[i] = make_uint4(0, 0, 0, 0);
    if (r < r_end) {
      const __nv_bfloat16* src = r < heads ? q_src + r * kDim : k_src + (r - heads) * kDim;
      raw[i] = __ldg(reinterpret_cast<const uint4*>(src + d0));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    qk_norm_rope_kernel(Segments seg, const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ q_out,
                        __nv_bfloat16* __restrict__ k_out, int heads, int s_total,
                        float eps) {
  const int lane = threadIdx.x % kLanes;
  const int s = blockIdx.x * kPos + threadIdx.x / kLanes;
  const int b = blockIdx.y;
  const int r_begin = blockIdx.z * kRows;
  const int r_end = min(r_begin + kRows, 2 * heads);
  // both halves of a warp shuffle: a position past the end computes on
  // zeros and stores nothing
  const bool live = s < s_total;
  const int sc = live ? s : s_total - 1;
  const int g = sc < seg.len0 ? 0 : 1;
  const int s_local = g ? sc - seg.len0 : sc;
  const int s_seg = g ? s_total - seg.len0 : seg.len0;
  const int d0 = 2 * kVec * lane;  // this thread's dims: [d0, d0 + 8)

  const size_t src_row = ((size_t)b * s_seg + s_local) * heads * kDim;
  const __nv_bfloat16* q_src = seg.q[g] + src_row;
  const __nv_bfloat16* k_src = seg.k[g] + src_row;
  uint4 cur[kBatch], nxt[kBatch];
  load_rows(cur, q_src, k_src, r_begin, live ? r_end : r_begin, heads, d0);

  float cs[2 * kVec], sn[2 * kVec];
  __nv_bfloat162 qs[kVec], ks[kVec];  // the norm scales, as pairs of dims
  {
    const float4* c4 = reinterpret_cast<const float4*>(cos_t + (size_t)sc * kDim + d0);
    const float4* s4 = reinterpret_cast<const float4*>(sin_t + (size_t)sc * kDim + d0);
    const float4 c0 = __ldg(c4), c1 = __ldg(c4 + 1), s0 = __ldg(s4), s1 = __ldg(s4 + 1);
    const float cv[2 * kVec] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float sv[2 * kVec] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int j = 0; j < 2 * kVec; ++j) {
      cs[j] = cv[j];
      sn[j] = sv[j];
    }
    // the scales are parameters of any alignment: 2-byte loads
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int d = d0 + 2 * j;
      qs[j] = __halves2bfloat162(seg.q_scale[g][d], seg.q_scale[g][d + 1]);
      ks[j] = __halves2bfloat162(seg.k_scale[g][d], seg.k_scale[g][d + 1]);
    }
  }

  const size_t dst_row = ((size_t)b * heads * s_total + sc) * kDim;
  const size_t head_stride = (size_t)s_total * kDim;
  for (int r0 = r_begin; r0 < r_end; r0 += kBatch) {
    // the next rows' loads go out before this batch's arithmetic
    if (r0 + kBatch < r_end)
      load_rows(nxt, q_src, k_src, r0 + kBatch, live ? r_end : r0, heads, d0);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = r0 + i;
      float x[2 * kVec];
      unpack(cur[i], x);
      // vectors 2t and 2t + 1 through the warp tree; every lane of the 16
      // (one half of the warp) ends with the same sum
      float sa = vec_sum_sq(x), sb = vec_sum_sq(x + kVec);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        sa = __fadd_rn(sa, __shfl_xor_sync(0xffffffffu, sa, off));
        sb = __fadd_rn(sb, __shfl_xor_sync(0xffffffffu, sb, off));
      }
      const float inv = rsqrtf(__fadd_rn(__fmul_rn(__fadd_rn(sa, sb), 1.0f / kDim), eps));
      if (!live || r >= r_end) continue;
      const bool is_k = r >= heads;
      __align__(16) __nv_bfloat162 out[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        // n = bf16(x * inv); y = bf16(n * scale): the bf16 product of two
        // bf16 values rounds their exact product once, as fp32 then bf16
        const __nv_bfloat162 n =
            __floats2bfloat162_rn(__fmul_rn(x[2 * j], inv), __fmul_rn(x[2 * j + 1], inv));
        const float2 y = __bfloat1622float2(__hmul2(n, is_k ? ks[j] : qs[j]));
        const float o0 = __fadd_rn(__fmul_rn(y.x, cs[2 * j]), __fmul_rn(-y.y, sn[2 * j]));
        const float o1 =
            __fadd_rn(__fmul_rn(y.y, cs[2 * j + 1]), __fmul_rn(y.x, sn[2 * j + 1]));
        out[j] = __floats2bfloat162_rn(o0, o1);
      }
      __nv_bfloat16* dst =
          (is_k ? k_out : q_out) + dst_row + (is_k ? r - heads : r) * head_stride;
      *reinterpret_cast<uint4*>(dst + d0) = *reinterpret_cast<const uint4*>(out);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) cur[i] = nxt[i];
  }
}

}  // namespace

// q0/k0 [b, s0, heads * 128] and q1/k1 [b, s1, heads * 128] bf16, contiguous
// and 16-byte aligned (s1 = 0: one segment, q1/k1 unused); the scales [128]
// bf16 per segment, contiguous; cos, sin [s0 + s1, 128] fp32, contiguous and
// 16-byte aligned; q_out, k_out [b, heads, s0 + s1, 128] bf16. Returns a
// cudaError_t value.
extern "C" int qk_norm_rope(const void* q0, const void* k0, const void* q_scale0,
                            const void* k_scale0, int s0, const void* q1, const void* k1,
                            const void* q_scale1, const void* k_scale1, int s1,
                            const void* cos_t, const void* sin_t, void* q_out, void* k_out,
                            int batch, int heads, float eps, void* stream) {
  Segments seg;
  seg.q[0] = static_cast<const __nv_bfloat16*>(q0);
  seg.k[0] = static_cast<const __nv_bfloat16*>(k0);
  seg.q_scale[0] = static_cast<const __nv_bfloat16*>(q_scale0);
  seg.k_scale[0] = static_cast<const __nv_bfloat16*>(k_scale0);
  seg.q[1] = static_cast<const __nv_bfloat16*>(s1 ? q1 : q0);
  seg.k[1] = static_cast<const __nv_bfloat16*>(s1 ? k1 : k0);
  seg.q_scale[1] = static_cast<const __nv_bfloat16*>(s1 ? q_scale1 : q_scale0);
  seg.k_scale[1] = static_cast<const __nv_bfloat16*>(s1 ? k_scale1 : k_scale0);
  seg.len0 = s0;
  const int s_total = s0 + s1;
  const dim3 grid((s_total + kPos - 1) / kPos, batch, (2 * heads + kRows - 1) / kRows);
  qk_norm_rope_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seg, static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(q_out), static_cast<__nv_bfloat16*>(k_out), heads, s_total,
      eps);
  return (int)cudaGetLastError();
}
