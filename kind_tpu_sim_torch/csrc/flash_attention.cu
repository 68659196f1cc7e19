// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: kind_tpu_sim/ops/pallas_kernels.py:_flash_impl (the Pallas
// TPU kernel launched by pl.pallas_call at :313; entry flash_attention
// :182). Same function: causal or full GQA attention
// softmax(Q K^T / sqrt(d)) V with an online softmax whose running max,
// denominator and accumulator stay in fp32, P rounded to the value
// dtype before the PV product (:288), and an optional logsumexp.
//
// What bounds it on this card: at the serving path's prefill shape
// (b=1, t=s=256, h=16, kv=4, d=128, bf16, causal) the work is ~0.27
// GFLOP against ~2.6 MB of q/k/v/out, so the least time is set by the
// bytes (about 0.8 us at 3.35 TB/s) and the kernel is bound in practice
// by its own instruction issue: this first version multiplies on the
// fp32 CUDA cores out of shared memory, not on the tensor cores.
//
// Design: one thread block per (q tile of BQ rows, head, batch); a loop
// inside the block walks the KV tiles up to the causal limit, which
// replaces the TPU's sequential kv grid axis (blocks run in parallel
// here and carry nothing between them). Q, K and V tiles are staged in
// shared memory as fp32 with padded rows (no bank conflicts); each
// thread owns a 4x4 patch of the score tile and a 4x8 patch of the
// output accumulator in registers. Inputs are read through element
// strides, so the (b, t, h, d) layout needs no transpose, and the
// ragged edges (any t, s; d <= 128, a multiple of 8) are masked here:
// no divisor search as the TPU's _fit_block does. wgmma/TMA and warp
// specialisation are left for the PR that makes it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;            // query rows per block
constexpr int BK = 64;            // kv rows per tile
constexpr int D_MAX = 128;        // largest head dim
constexpr int THREADS = 128;      // 16 (cols) x 8 (rows) thread grid
constexpr int LDQ = D_MAX + 1;    // padded fp32 row strides
constexpr int LDK = D_MAX + 1;
constexpr int LDS = BK + 1;
constexpr float NEG = -1e30f;     // the reference's mask value, not -inf

constexpr size_t SMEM_BYTES =
    sizeof(float) * (BQ * LDQ + BK * LDK + BK * D_MAX + BQ * LDS + 3 * BQ);

struct Strides {
  long long b, t, h;  // element strides; the head dim is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int t, int s, int h, int group,
                 int d, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;         // BK x LDK
  float* Vs = Ks + BK * LDK;         // BK x D_MAX
  float* Ss = Vs + BK * D_MAX;       // BQ x LDS: scores, then P
  float* m_s = Ss + BQ * LDS;        // running max per row
  float* l_s = m_s + BQ;             // running denominator per row
  float* a_s = l_s + BQ;             // this tile's rescale per row

  const int q0 = blockIdx.x * BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + (hi / group) * ks.h;
  const T* vb = v + bi * vs.b + (hi / group) * vs.h;

  for (int idx = tid; idx < BQ * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    const int row = q0 + r;
    Qs[r * LDQ + c] = row < t ? to_f(qb[row * qs.t + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  float acc[4][8];  // rows ty + 8 i, cols tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // causal: column <= row, so nothing past this tile's last row is live
  const int kv_end = causal ? min(s, min(t, q0 + BQ)) : s;
  __syncthreads();

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    for (int idx = tid; idx < BK * d; idx += THREADS) {
      const int r = idx / d, c = idx % d;
      const int col = k0 + r;
      const bool ok = col < s;
      Ks[r * LDK + c] = ok ? to_f(kb[col * ks.t + c]) : 0.f;
      Vs[r * D_MAX + c] = ok ? to_f(vb[col * vs.t + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 8 * i) * LDQ + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDK + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const int col = k0 + cl;
        const bool live = col < s && (!causal || col <= q0 + r);
        Ss[r * LDS + cl] = live ? sc[i][j] * scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: each warp owns BQ / 4 rows, a lane two columns
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int r = warp * (BQ / 4) + rr;
      const float x0 = Ss[r * LDS + lane];
      const float x1 = Ss[r * LDS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // the denominator sums P in fp32; the PV product takes P rounded
      // to the value dtype, as the reference kernel does
      Ss[r * LDS + lane] = to_f(from_f<T>(p0));
      Ss[r * LDS + lane + 32] = to_f(from_f<T>(p1));
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 8 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = Vs[c * D_MAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ss
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    const int row = q0 + r;
    if (row >= t) continue;
    const float l = l_s[r];
    T* orow = out + bi * os.b + row * os.t + hi * os.h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[c] = from_f<T>(acc[i][j] / l);
    }
  }
  if (lse != nullptr && tid < BQ && q0 + tid < t)
    lse[((long long)bi * h + hi) * t + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int b, int t, int s, int h, int kv, int d,
           Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t, s, h, h / kv, d, qs, ks, vs, os, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). dtype: 0 = bf16, 1 = fp32. Strides
// are in elements for the batch, sequence and head axes. Returns the
// CUDA error code of the launch (0 = success).
extern "C" int kts_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int b, int t, int s, int h, int kv, int d, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, float scale, int causal,
    void* stream) {
  if (d > D_MAX || d % 8 != 0 || h % kv != 0 || t < 1 || s < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, out, lse, b, t, s, h, kv, d, qs,
                                 ks, vs, os, scale, causal, st);
  if (dtype == 1)
    return launch<float>(q, k, v, out, lse, b, t, s, h, kv, d, qs, ks, vs,
                         os, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
