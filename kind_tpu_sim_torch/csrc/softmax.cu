// Row softmax for NVIDIA Hopper (sm_90a), CUDA C++.
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
// Design: the TPU kernel holds the whole array in VMEM as one block; a
// full-width row here is 32768 fp32 (128 KB), more than a block's
// registers hold. So one block owns a row and loops over it twice. The
// first pass keeps a running max and a running sum per thread (the sum
// rescaled by exp(old max - new max) whenever the max grows), so the row
// is read once for both; the threads' (max, sum) pairs are merged with
// warp shuffles and then across the block's warps in shared memory. The
// second pass writes exp(x - max) / sum. It reads the row again: with
// 1024 threads a block, two blocks an SM, the rows in flight are ~35 MB,
// within the 50 MB L2, so that read should mostly come from L2. Keeping
// the row in shared memory (it fits: 227 KB) would make sure of it;
// that is for a later PR.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

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

template <typename T>
int launch(const void* x, void* out, int rows, int n, cudaStream_t stream) {
  softmax_kernel<T><<<rows, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). dtype of x and out: 0 = bf16,
// 1 = fp32, 2 = fp16; x contiguous, viewed as (rows, n). Returns the
// CUDA error code of the launch (0 = success).
extern "C" int kts_softmax(const void* x, void* out, int dtype, int rows,
                           int n, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(x, out, rows, n, st);
  if (dtype == 1) return launch<float>(x, out, rows, n, st);
  if (dtype == 2) return launch<__half>(x, out, rows, n, st);
  return (int)cudaErrorInvalidValue;
}
