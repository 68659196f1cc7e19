// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++: two
// kernels, dq and dk/dv, on the CUDA cores. This is the route for fp32
// (the tiny models stay exact here) and for bf16 head dims or layouts
// TMA cannot read; bf16 that TMA can read goes to the tensor-core
// kernels of csrc/flash_attention_bwd_tc.cu. ops/flash_attention.py
// picks the route from the inputs before the launch.
//
// Replaces: kind_tpu_sim/ops/pallas_kernels.py:_flash_bwd, its dq_kernel
// (:380, pl.pallas_call at :416) and its dkv_kernel (:440, pl.pallas_call
// at :485) together with the GQA group-sum after it (:519-525). Same
// function: scores recomputed in fp32 as (Q K^T) * scale, causal mask
// column <= row; P = exp(S - lse) in fp32 (not rounded, unlike the
// forward's P before PV); dP = dO V^T; dS = P * (dP - D) with
// D = rowsum(dO * O) computed outside the kernels (as at :373-375);
// dQ = sum_kv dS K * scale; dV = sum_q P^T dO; dK = sum_q dS^T Q * scale.
//
// What bounds it on this card: at the training path's shape (b=8,
// t=s=1024, h=16, kv=4, d=128, bf16, causal) dq does three products and
// dk/dv four over the 67.2M live (row, col) pairs: 51.6 and 68.8 GFLOP
// against ~0.12 and ~0.10 GB of inputs and outputs, so the least time is
// set by the operations (0.052 and 0.070 ms at 989 TFLOP/s bf16). These
// first versions multiply on the fp32 CUDA cores out of shared memory,
// not on the tensor cores, so they are bound in practice by their own
// shared-memory loads and FMA issue, far above that bound.
//
// Design. The TPU walks the reduction axis as a sequential grid
// dimension and carries the sum in VMEM scratch; here blocks run in
// parallel and carry nothing, so a loop inside each block replaces that
// grid axis and the sums live in registers:
// * dq: one block per (q tile of DQ_BQ rows, q head, batch) holds its Q
//   and dO rows, lse and D in shared memory and loops over the kv tiles
//   up to the causal limit, accumulating dQ in registers (fp32); dQ is
//   written once, in q's dtype.
// * dk/dv: one block per (kv tile of KV_BK rows, KV head, batch) holds
//   its K and V rows and loops over the group's q heads and, for each,
//   over the q tiles from the causal start, accumulating dK and dV in
//   registers (fp32). So the GQA group-sum happens inside the block,
//   still in fp32 before the one cast, and dK and dV are written once in
//   k's and v's dtype: no (b, h, s, d) fp32 intermediates.
// Neither uses atomics, so both are deterministic. Inputs are read
// through element strides (V is a view of the fused qkv projection in
// the model), and the ragged q and kv edges are masked here, so any
// t, s and any d <= 128 that is a multiple of 8 run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // 16 (tx) x 8 (ty)
constexpr int D_MAX = 128;     // largest head dim
constexpr int LD = D_MAX + 1;  // padded fp32 row stride of a d-wide tile

// dq kernel tiles
constexpr int DQ_BQ = 32;      // q rows per block
constexpr int DQ_BK = 64;      // kv rows per loop step
constexpr int DQ_LDS = DQ_BK + 1;
constexpr size_t DQ_SMEM =
    sizeof(float) * (2 * DQ_BQ * LD + 2 * DQ_BK * LD + DQ_BQ * DQ_LDS +
                     2 * DQ_BQ);

// dk/dv kernel tiles
constexpr int KV_BK = 32;      // kv rows per block
constexpr int KV_BQ = 64;      // q rows per loop step
constexpr int KV_LDP = KV_BK + 1;
constexpr size_t KV_SMEM =
    sizeof(float) * (2 * KV_BK * LD + 2 * KV_BQ * LD + KV_BQ * KV_LDP +
                     2 * KV_BQ);

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

// rows [r0, r0 + n) of a (seq, d) slice into a padded fp32 tile; rows at
// or past `len` are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int n, int len, int d) {
  for (int idx = threadIdx.x; idx < n * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    const int row = r0 + r;
    dst[r * LD + c] = row < len ? to_f(src[row * row_stride + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int t, int s, int h, int group, int d, Strides qs,
                    Strides ks, Strides vs, Strides gs, Strides os,
                    float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // DQ_BQ x LD
  float* Gs = Qs + DQ_BQ * LD;        // DQ_BQ x LD (dO rows)
  float* Ks = Gs + DQ_BQ * LD;        // DQ_BK x LD
  float* Vs = Ks + DQ_BK * LD;        // DQ_BK x LD
  float* dSs = Vs + DQ_BK * LD;       // DQ_BQ x DQ_LDS
  float* lse_s = dSs + DQ_BQ * DQ_LDS;
  float* d_s = lse_s + DQ_BQ;

  const int q0 = blockIdx.x * DQ_BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const T* kb = k + bi * ks.b + (hi / group) * ks.h;
  const T* vb = v + bi * vs.b + (hi / group) * vs.h;
  load_tile(Qs, q + bi * qs.b + hi * qs.h, qs.t, q0, DQ_BQ, t, d);
  load_tile(Gs, g + bi * gs.b + hi * gs.h, gs.t, q0, DQ_BQ, t, d);
  if (threadIdx.x < DQ_BQ) {
    const int row = q0 + threadIdx.x;
    const long long at = ((long long)bi * h + hi) * t + row;
    lse_s[threadIdx.x] = row < t ? lse[at] : 0.f;
    d_s[threadIdx.x] = row < t ? dsum[at] : 0.f;
  }

  float acc[4][8];  // dQ rows ty + 8 i, cols tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // causal: column <= row, so nothing past this tile's last row is live
  const int kv_end = causal ? min(s, q0 + DQ_BQ) : s;
  __syncthreads();

  for (int k0 = 0; k0 < kv_end; k0 += DQ_BK) {
    load_tile(Ks, kb, ks.t, k0, DQ_BK, s, d);
    load_tile(Vs, vb, vs.t, k0, DQ_BK, s, d);
    __syncthreads();

    float sc[4][4], dp[4][4];  // rows ty + 8 i, cols tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 8 * i) * LD + c];
        gv[i] = Gs[(ty + 8 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + c];
        vv[j] = Vs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const int col = k0 + cl;
        // a masked score is -1e30 in the reference: exp(-1e30 - lse) = 0
        const bool live = row < t && col < s && (!causal || col <= row);
        const float p = live ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * DQ_LDS + cl] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();

    for (int c = 0; c < DQ_BK; ++c) {
      float ds[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 8 * i) * DQ_LDS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kk[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and dSs
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= t) continue;
    T* orow = dq + bi * os.b + row * os.t + hi * os.h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[c] = from_f<T>(acc[i][j] * scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int t, int s, int h, int group,
                     int d, Strides qs, Strides ks, Strides vs, Strides gs,
                     Strides dks, Strides dvs, float scale, int causal) {
  extern __shared__ float smem[];
  float* Ks = smem;                   // KV_BK x LD
  float* Vs = Ks + KV_BK * LD;        // KV_BK x LD
  float* Qs = Vs + KV_BK * LD;        // KV_BQ x LD
  float* Gs = Qs + KV_BQ * LD;        // KV_BQ x LD (dO rows)
  float* Ps = Gs + KV_BQ * LD;        // KV_BQ x KV_LDP: P, then dS
  float* lse_s = Ps + KV_BQ * KV_LDP;
  float* d_s = lse_s + KV_BQ;

  const int k0 = blockIdx.x * KV_BK;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile(Ks, k + bi * ks.b + kvh * ks.h, ks.t, k0, KV_BK, s, d);
  load_tile(Vs, v + bi * vs.b + kvh * vs.h, vs.t, k0, KV_BK, s, d);

  // dK and dV rows ty + 8 i of the kv tile, cols tx + 16 j
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: a q tile is live when its last row reaches this tile's first
  // column, so the walk starts at the tile that holds row k0
  const int q_start = causal ? (k0 / KV_BQ) * KV_BQ : 0;

  for (int gi = 0; gi < group; ++gi) {
    const int hq = kvh * group + gi;
    const T* qb = q + bi * qs.b + hq * qs.h;
    const T* gb = g + bi * gs.b + hq * gs.h;
    const long long lse_row = ((long long)bi * h + hq) * t;
    for (int q0 = q_start; q0 < t; q0 += KV_BQ) {
      __syncthreads();  // the previous step is done with Qs, Gs and Ps
      load_tile(Qs, qb, qs.t, q0, KV_BQ, t, d);
      load_tile(Gs, gb, gs.t, q0, KV_BQ, t, d);
      if (threadIdx.x < KV_BQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < t ? lse[lse_row + row] : 0.f;
        d_s[threadIdx.x] = row < t ? dsum[lse_row + row] : 0.f;
      }
      __syncthreads();

      // S and dP for q rows ty + 8 i (i < 8), kv cols tx + 16 j (j < 2)
      float sc[8][2], dp[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float qv[8], gv[8], kv[2], vv[2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          qv[i] = Qs[(ty + 8 * i) * LD + c];
          gv[i] = Gs[(ty + 8 * i) * LD + c];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          kv[j] = Ks[(tx + 16 * j) * LD + c];
          vv[j] = Vs[(tx + 16 * j) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
            dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
          }
      }
      float p[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 8 * i;
        const int row = q0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cl = tx + 16 * j;
          const int col = k0 + cl;
          const bool live = row < t && col < s && (!causal || col <= row);
          p[i][j] = live ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
          Ps[r * KV_LDP + cl] = p[i][j];
        }
      }
      __syncthreads();

      // dV += P^T dO over this tile's q rows
      for (int r = 0; r < KV_BQ; ++r) {
        float pv[4], gv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[r * KV_LDP + ty + 8 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) gv[j] = Gs[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
      }
      __syncthreads();  // every thread has read P; Ps now takes dS

#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          Ps[r * KV_LDP + tx + 16 * j] = p[i][j] * (dp[i][j] - d_s[r]);
      }
      __syncthreads();

      // dK += dS^T Q over this tile's q rows (scaled at the end)
      for (int r = 0; r < KV_BQ; ++r) {
        float dsv[4], qv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = Ps[r * KV_LDP + ty + 8 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) qv[j] = Qs[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty + 8 * i;
    if (col >= s) continue;
    T* krow = dk + bi * dks.b + col * dks.t + kvh * dks.h;
    T* vrow = dv + bi * dvs.b + col * dvs.t + kvh * dvs.h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        krow[c] = from_f<T>(dk_acc[i][j] * scale);
        vrow[c] = from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* lse, const void* dsum, void* dq, int b, int t,
              int s, int h, int kv, int d, Strides qs, Strides ks,
              Strides vs, Strides gs, Strides os, float scale, int causal,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + DQ_BQ - 1) / DQ_BQ, h, b);
  flash_bwd_dq_kernel<T><<<grid, THREADS, DQ_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dq), t, s, h, h / kv, d, qs, ks, vs, gs, os, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const void* lse, const void* dsum, void* dk, void* dv,
               int b, int t, int s, int h, int kv, int d, Strides qs,
               Strides ks, Strides vs, Strides gs, Strides dks,
               Strides dvs, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)KV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + KV_BK - 1) / KV_BK, kv, b);
  flash_bwd_dkv_kernel<T><<<grid, THREADS, KV_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), t, s, h, h / kv, d, qs, ks,
      vs, gs, dks, dvs, scale, causal);
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int t, int s, int h, int kv, int d) {
  return b < 1 || t < 1 || s < 1 || kv < 1 || h % kv != 0 || d > D_MAX ||
         d < 8 || d % 8 != 0;
}

}  // namespace

// C interface (bound with ctypes). dtype: 0 = bf16, 1 = fp32 (q, k, v,
// g and the outputs all of it); lse and dsum are (b, h, t) fp32,
// contiguous. Strides are in elements for the batch, sequence and head
// axes of q, k, v, g and each output. Each returns the CUDA error code of
// its launch (0 = success).
extern "C" int kts_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* dsum, void* dq, int dtype, int b, int t,
    int s, int h, int kv, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long g_sb,
    long long g_st, long long g_sh, long long o_sb, long long o_st,
    long long o_sh, float scale, int causal, void* stream) {
  if (bad_shape(b, t, s, h, kv, d)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, gs{g_sb, g_st, g_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq<__nv_bfloat16>(q, k, v, g, lse, dsum, dq, b, t, s, h,
                                    kv, d, qs, ks, vs, gs, os, scale,
                                    causal, st);
  if (dtype == 1)
    return launch_dq<float>(q, k, v, g, lse, dsum, dq, b, t, s, h, kv, d,
                            qs, ks, vs, gs, os, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int kts_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* dsum, void* dk, void* dv, int dtype,
    int b, int t, int s, int h, int kv, int d, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long g_sb, long long g_st, long long g_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, float scale, int causal, void* stream) {
  if (bad_shape(b, t, s, h, kv, d)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, gs{g_sb, g_st, g_sh},
      dks{dk_sb, dk_ss, dk_sh}, dvs{dv_sb, dv_ss, dv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv<__nv_bfloat16>(q, k, v, g, lse, dsum, dk, dv, b, t,
                                     s, h, kv, d, qs, ks, vs, gs, dks, dvs,
                                     scale, causal, st);
  if (dtype == 1)
    return launch_dkv<float>(q, k, v, g, lse, dsum, dk, dv, b, t, s, h, kv,
                             d, qs, ks, vs, gs, dks, dvs, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
