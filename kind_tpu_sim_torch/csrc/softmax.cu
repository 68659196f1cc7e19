// Row softmax for NVIDIA Hopper (sm_90a), CUDA C++: two routes.
//
// Replaces: kind_tpu_sim/ops/pallas_kernels.py:softmax (the Pallas TPU
// kernel launched by pl.pallas_call at :122). Same function: over the
// last axis, in fp32, subtract the row's max, exponentiate, divide by
// the row's sum; the output has x's dtype.
//
// What bounds it on this card: bytes. Each element is read once and
// written once with a handful of flops between, so at the shape
// chip_smoke.py times (8192 x 32768 fp32, the flagship's readout logits
// over one training batch: 2.1 GB) the least time is 0.64 ms at
// 3.35 TB/s.
//
// The TPU kernel holds the whole array in VMEM as one block. Here:
//
// * kts_softmax_one_read (the "one_read" route): the row is read from
//   device memory once and written once, the bound's own count of
//   bytes. A row is owned by the fewest threads (a power of two, a warp
//   at least) that hold it at 32 values each, in registers as fp32: a
//   full-width 32768 fp32 row is 1024 threads x 8 chunks of 16 bytes,
//   one block an SM (64 registers a thread at most), while shorter rows
//   share a 256-thread block. Every thread issues all its 16-byte loads
//   before the first is used. The row's max comes from the held
//   values, then each value becomes exp(x - max), one expf and no
//   branch an element, and their sum; both reductions are shuffles,
//   then one value a warp through shared memory. The held values are
//   scaled by 1 / sum and leave in 16-byte stores. One block an SM
//   cannot overlap its own reductions with its loads; the other SMs'
//   loads keep device memory busy meanwhile, and the route reaches
//   ~89% of the byte bound at the flagship shape (PERF.md), so a row
//   split across a thread-block cluster was not needed. Streaming
//   cache hints (evict-first loads, __stcs stores) were no faster
//   there than the read-only path and plain stores. Rows up to 32768
//   values.
// * kts_softmax (the "two_pass" route, the first kernel): one
//   1024-thread block a row, scalar loads; a first pass keeps a running
//   max and a running sum per thread (the sum rescaled by
//   exp(old max - new max) whenever the max grows), merged across the
//   block; a second pass reads the row again and writes
//   exp(x - max) / sum. Kept for rows the one_read route cannot read in
//   16-byte chunks or hold: longer than 32768 values, a length that is
//   not a multiple of a chunk, a base off a 16-byte boundary.
//
// Edge cases, as in the reference: a -inf entry gives 0; a row whose
// entries are all -inf gives NaN (exp(-inf - -inf)); NaN anywhere in a
// row makes the row NaN.

#include "rows.cuh"

namespace {

using rowops::from_f;
using rowops::to_f;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

// (m, s): the sum s of exp(x - m) over some elements. A part with s == 0
// (no element yet, or only -inf) contributes nothing.
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                     float s2) {
  if (s2 == 0.f) return;
  if (s == 0.f) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
softmax_kernel(const T* __restrict__ x, T* __restrict__ out, int n) {
  __shared__ float m_s[WARPS], s_s[WARPS];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const T* xr = x + (long long)blockIdx.x * n;
  T* yr = out + (long long)blockIdx.x * n;

  float m = -INFINITY, s = 0.f;
  for (int c = tid; c < n; c += THREADS) {
    const float v = to_f(xr[c]);
    if (v > m) {
      s = s * expf(m - v) + 1.f;  // expf(-inf) = 0 on the first element
      m = v;
    } else if (v != -INFINITY) {
      s += expf(v - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if (lane == 0) {
    m_s[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  m = m_s[0];
  s = s_s[0];
  for (int w = 1; w < WARPS; ++w) merge(m, s, m_s[w], s_s[w]);

  for (int c = tid; c < n; c += THREADS)
    yr[c] = from_f<T>(expf(to_f(xr[c]) - m) / s);
}

// the one_read route: values of a row a thread holds, threads a block at
// least
constexpr int HELD = 32;
constexpr int ONE_READ_BLOCK = 256;

template <typename T>
__global__ void __launch_bounds__(1024, 1)
softmax_one_read_kernel(const T* __restrict__ x, T* __restrict__ out,
                        int rows, int n, int tpr) {
  __shared__ float max_s[32], sum_s[32];
  constexpr int V = rowops::kVec<T>, CHUNKS = HELD / V;
  const int chunks = n / V;
  const int t = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + (live ? row : 0) * n);

  uint4 raw[CHUNKS];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = t + i * tpr;
    raw[i] = live && c < chunks ? __ldg(xr + c) : make_uint4(0, 0, 0, 0);
  }
  float v[HELD];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    if (t + i * tpr < chunks) {
      rowops::chunk_to_f<T>(raw[i], v + i * V);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i * V + j] = -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) m = fmaxf(m, v[i * V + j]);
  }
  m = rowops::row_reduce(m, max_s, tpr, rowops::Max{}, -INFINITY);
  // a value past the row's end is -inf: exp gives 0 (NaN in a row of
  // -inf only, which is NaN all the same)
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < HELD; ++j) {
    v[j] = expf(v[j] - m);
    s += v[j];
  }
  s = rowops::row_reduce(s, sum_s, tpr, rowops::Sum{}, 0.f);
  const float inv = 1.f / s;
  if (!live) return;

  uint4* yr = reinterpret_cast<uint4*>(out + row * n);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = t + i * tpr;
    if (c < chunks) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i * V + j] *= inv;
      yr[c] = rowops::f_to_chunk<T>(v + i * V);
    }
  }
}

template <typename T>
int launch(bool one_read, const void* x, void* out, int rows, int n,
           cudaStream_t stream) {
  if (!one_read) {
    softmax_kernel<T><<<rows, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n);
    return (int)cudaGetLastError();
  }
  constexpr int V = rowops::kVec<T>;
  if (n % V != 0 || n > 1024 * HELD || !rowops::aligned16(x) ||
      !rowops::aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int tpr = rowops::threads_per_row(n / V, HELD / V);
  const int threads = tpr > ONE_READ_BLOCK ? tpr : ONE_READ_BLOCK;
  const int per_block = threads / tpr;
  const int blocks = (int)(((long long)rows + per_block - 1) / per_block);
  softmax_one_read_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, n, tpr);
  return (int)cudaGetLastError();
}

int dispatch(bool one_read, const void* x, void* out, int dtype, int rows,
             int n, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(one_read, x, out, rows, n, st);
  if (dtype == 1) return launch<float>(one_read, x, out, rows, n, st);
  if (dtype == 2) return launch<__half>(one_read, x, out, rows, n, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). dtype of x and out: 0 = bf16,
// 1 = fp32, 2 = fp16; x contiguous, viewed as (rows, n). Returns the
// CUDA error code of the launch (0 = success).
extern "C" int kts_softmax(const void* x, void* out, int dtype, int rows,
                           int n, void* stream) {
  return dispatch(false, x, out, dtype, rows, n, stream);
}

// The one_read route: as kts_softmax, and further x and out on 16-byte
// boundaries, n a multiple of a 16-byte chunk of the dtype and at most
// 32768; cudaErrorInvalidValue otherwise.
extern "C" int kts_softmax_one_read(const void* x, void* out, int dtype,
                                    int rows, int n, void* stream) {
  return dispatch(true, x, out, dtype, rows, n, stream);
}
