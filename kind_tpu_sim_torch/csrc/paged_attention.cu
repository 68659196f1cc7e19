// Paged attention (decode) for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: kind_tpu_sim/ops/pallas_kernels.py:paged_attention (the
// Pallas TPU kernel launched by pl.pallas_call at :651). Same function:
// one query token per slot attends over that slot's paged KV prefix,
// read block by block through its block table with no gathered view in
// device memory, returning the unnormalised fp32 softmax partials
// (acc, m, l) that models/paged.py merges with the chunk-buffer and
// in-flight groups. The mask multiplies p, so a zero-length slot gives
// exactly l = 0, acc = 0, m = -1e30; table entries past a slot's live
// blocks are never read, so padding may point at any block.
//
// What bounds it on this card: device-memory bytes. Each live KV
// position is read once (k and v, kv_heads x head_dim values each) and
// does ~4 flops per byte-pair of work across the query group, far
// below the ~295 flops/byte at which Hopper turns compute-bound.
//
// Design: one thread block per (slot, kv head) covers the group's g
// query rows, so every K/V byte is read once for all g heads that share
// it (the GQA saving). The block loads its own table entries (what the
// TPU's scalar prefetch did) and walks only ceil(len / block_size)
// blocks. Scores: one warp per pool position, the lanes splitting the
// head dim and reducing with shuffles. Softmax: one warp per query row.
// PV: each thread owns output columns, reading V rows coalesced. All
// sums are fp32. With 8 slots x 4 kv heads the grid fills 32 of the
// 132 SMs; splitting the sequence across blocks (a second combine
// pass) is the lever for the PR that makes it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int G_MAX = 8;       // query heads per kv head
constexpr int HD_MAX = 256;    // head dim
constexpr int THREADS = 128;   // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int COLS = HD_MAX / THREADS;
constexpr float NEG = -1e30f;  // the reference's mask value, not -inf

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ qg, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int kv, int g, int hd,
                       int bsz, int width, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;            // g x hd
  float* p_s = q_s + g * hd;    // g x bsz: scores, then p
  __shared__ float m_s[G_MAX], l_s[G_MAX], corr_s[G_MAX];

  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = lengths[slot];
  const int n_blocks = min(width, (len + bsz - 1) / bsz);
  const long long row0 = ((long long)slot * kv + h) * g;  // first q row

  for (int idx = tid; idx < g * hd; idx += THREADS)
    q_s[idx] = to_f(qg[row0 * hd + idx]);
  if (tid < g) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  float acc[G_MAX][COLS];
#pragma unroll
  for (int gi = 0; gi < G_MAX; ++gi)
#pragma unroll
    for (int cc = 0; cc < COLS; ++cc) acc[gi][cc] = 0.f;
  __syncthreads();

  for (int b = 0; b < n_blocks; ++b) {
    const long long pb = tables[(long long)slot * width + b];
    const int live = min(bsz, len - b * bsz);  // >= 1 by n_blocks

    for (int pos = warp; pos < bsz; pos += WARPS) {
      if (pos >= live) {
        if (lane < g) p_s[lane * bsz + pos] = NEG;
        continue;
      }
      const T* krow = k_pool + ((pb * bsz + pos) * kv + h) * hd;
      float part[G_MAX];
#pragma unroll
      for (int gi = 0; gi < G_MAX; ++gi) part[gi] = 0.f;
      for (int c = lane; c < hd; c += 32) {
        const float kval = to_f(krow[c]);
#pragma unroll
        for (int gi = 0; gi < G_MAX; ++gi)
          if (gi < g) part[gi] = fmaf(q_s[gi * hd + c], kval, part[gi]);
      }
#pragma unroll
      for (int gi = 0; gi < G_MAX; ++gi) {
        float x = part[gi];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        part[gi] = x;
      }
      if (lane < g) {
        float mine = 0.f;
#pragma unroll
        for (int gi = 0; gi < G_MAX; ++gi)
          if (gi == lane) mine = part[gi];
        p_s[lane * bsz + pos] = mine * scale;
      }
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += WARPS) {
      float mx = NEG;
      for (int pos = lane; pos < bsz; pos += 32)
        mx = fmaxf(mx, p_s[gi * bsz + pos]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int pos = lane; pos < bsz; pos += 32) {
        // masked positions carry p = 0 exactly (the mask multiplies)
        const float p = pos < live ? expf(p_s[gi * bsz + pos] - m_new) : 0.f;
        p_s[gi * bsz + pos] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
        corr_s[gi] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int cc = 0; cc < COLS; ++cc) {
      const int c = tid + cc * THREADS;
      if (c >= hd) continue;
#pragma unroll
      for (int gi = 0; gi < G_MAX; ++gi)
        if (gi < g) acc[gi][cc] *= corr_s[gi];
      for (int pos = 0; pos < live; ++pos) {
        const float vval = to_f(v_pool[((pb * bsz + pos) * kv + h) * hd + c]);
#pragma unroll
        for (int gi = 0; gi < G_MAX; ++gi)
          if (gi < g) acc[gi][cc] = fmaf(p_s[gi * bsz + pos], vval, acc[gi][cc]);
      }
    }
    __syncthreads();  // the next block overwrites p_s and corr_s
  }

#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int c = tid + cc * THREADS;
    if (c >= hd) continue;
#pragma unroll
    for (int gi = 0; gi < G_MAX; ++gi)
      if (gi < g) acc_out[(row0 + gi) * hd + c] = acc[gi][cc];
  }
  if (tid < g) {
    m_out[row0 + tid] = m_s[tid];
    l_out[row0 + tid] = l_s[tid];
  }
}

template <typename T>
int launch(const void* qg, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* acc, void* m,
           void* l, int slots, int kv, int g, int hd, int bsz, int width,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)g * (hd + bsz);
  const dim3 grid(slots, kv);
  paged_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qg), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), kv, g, hd, bsz, width,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). dtype: 0 = bf16, 1 = fp32; all
// tensors contiguous; tables/lengths int32. Returns the CUDA error code
// of the launch (0 = success).
extern "C" int kts_paged_attention(const void* qg, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* lengths, void* acc, void* m,
                                   void* l, int dtype, int slots, int kv,
                                   int g, int hd, int bsz, int width,
                                   float scale, void* stream) {
  if (g < 1 || g > G_MAX || hd < 1 || hd > HD_MAX || bsz < 1 || width < 1 ||
      sizeof(float) * (size_t)g * (hd + bsz) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(qg, k_pool, v_pool, tables, lengths, acc,
                                 m, l, slots, kv, g, hd, bsz, width, scale,
                                 st);
  if (dtype == 1)
    return launch<float>(qg, k_pool, v_pool, tables, lengths, acc, m, l,
                         slots, kv, g, hd, bsz, width, scale, st);
  return (int)cudaErrorInvalidValue;
}
