// Row-wise RMSNorm for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: kind_tpu_sim/ops/pallas_kernels.py:rms_norm (the Pallas TPU
// kernel launched by pl.pallas_call at :98). Same function:
// out = x * rsqrt(mean(x^2) + eps) * w over each row of x (rows, d), in
// fp32, cast to x's dtype.
//
// What bounds it on this card: bytes. Each element is read once and
// written once with ~4 flops between, so at the shape chip_smoke.py
// times (8192 x 2048 bf16, the flagship's norm input over one training
// batch: 67 MB) the least time is 0.020 ms at 3.35 TB/s.
//
// Design: the TPU kernel holds the whole array in VMEM as one block.
// Here one warp owns a row: a first pass sums the squares in fp32 and
// reduces them across the warp with shuffles, a second pass scales,
// multiplies by w and casts. The second pass reads the row again; a
// row is a few KB, so it comes from L1/L2, not device memory. Eight
// rows per 256-thread block keep enough loads in flight. Vector
// (16-byte) loads and keeping the row in registers are levers for a
// later PR.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

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

template <typename T, typename W>
__global__ void __launch_bounds__(THREADS)
rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                T* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row =
      (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = out + row * d;

  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f(xr[c]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  // 1.f / sqrtf, each step correctly rounded, not the approximate rsqrtf
  const float inv = 1.f / sqrtf(ss / (float)d + eps);

  for (int c = lane; c < d; c += 32)
    yr[c] = from_f<T>(to_f(xr[c]) * inv * to_f(w[c]));
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  rms_norm_kernel<T, W><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(const void* x, const void* w, void* out, int w_dtype, int rows,
             int d, float eps, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch<T, __nv_bfloat16>(x, w, out, rows, d, eps, stream);
  if (w_dtype == 1) return launch<T, float>(x, w, out, rows, d, eps, stream);
  if (w_dtype == 2) return launch<T, __half>(x, w, out, rows, d, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). Dtype codes for x (and out) and for
// w: 0 = bf16, 1 = fp32, 2 = fp16; x (rows, d) and w (d,) contiguous.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int kts_rms_norm(const void* x, const void* w, void* out,
                            int x_dtype, int w_dtype, int rows, int d,
                            float eps, void* stream) {
  if (rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_w<__nv_bfloat16>(x, w, out, w_dtype, rows, d, eps, st);
  if (x_dtype == 1)
    return launch_w<float>(x, w, out, w_dtype, rows, d, eps, st);
  if (x_dtype == 2)
    return launch_w<__half>(x, w, out, w_dtype, rows, d, eps, st);
  return (int)cudaErrorInvalidValue;
}
