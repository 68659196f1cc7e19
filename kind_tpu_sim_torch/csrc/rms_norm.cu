// Row-wise RMSNorm for NVIDIA Hopper (sm_90a), CUDA C++: two routes.
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
// The TPU kernel holds the whole array in VMEM as one block. Here:
//
// * kts_rms_norm_vec (the "vector" route): the row is read from device
//   memory once, in 16-byte loads, and kept in registers. A row is
//   owned by the fewest threads (a power of two, a warp at least) that
//   hold it at 8 chunks of 16 bytes each; at the flagship's d = 2048
//   bf16 that is one warp, 8 uint4 a lane, all 8 loads issued before
//   the first is used, so a warp has 4 KB in flight. The squares are
//   summed in fp32 from the registers and reduced with shuffles (and
//   through shared memory when a row spans warps); then each chunk is
//   scaled, multiplied by the weight (read in 16-byte chunks through
//   the read-only path: every warp of an SM reads the same 8 KB, which
//   stays in L1) and stored in 16-byte stores, without reading the row
//   again. 256 threads a block at least, so short rows share a block;
//   64 registers a thread at most, so 4 blocks (32 rows, 128 KB of
//   loads) are in flight an SM at the flagship shape. Rows up to 128 KB
//   (1024 threads x 8 chunks): bf16 d <= 65536, fp32 d <= 32768.
//   Tried on the H100 at the flagship shape and no faster (PERF.md):
//   128- or 512-thread blocks, streaming cache hints, and a persistent
//   grid whose warps load their next row before reducing the current
//   one (fewer warps an SM for the doubled registers). The kernel
//   moves its bytes about as fast as one x.clone() of them does.
// * kts_rms_norm (the "scalar" route, the first kernel): one warp a
//   row, scalar loads, and a second pass that reads the row again
//   (from L1/L2); kept for rows the vector route cannot read in 16-byte
//   chunks (d not a multiple of a chunk, a base off a 16-byte boundary)
//   or hold (longer rows).
//
// Both compute 1.f / sqrtf(mean + eps), each step correctly rounded,
// not the approximate rsqrtf, then (x * inv) * w, cast once.

#include "rows.cuh"

namespace {

using rowops::to_f;

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

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
  const float inv = 1.f / sqrtf(ss / (float)d + eps);

  for (int c = lane; c < d; c += 32)
    yr[c] = rowops::from_f<T>(to_f(xr[c]) * inv * to_f(w[c]));
}

// the vector route: 16-byte chunks a thread holds, threads a block at
// least
constexpr int VEC_CHUNKS = 8;
constexpr int VEC_BLOCK = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(1024, 1)
rms_norm_vec_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    T* __restrict__ out, int rows, int d, int tpr,
                    float eps) {
  __shared__ float scratch[32];
  constexpr int V = rowops::kVec<T>;
  const int chunks = d / V;
  const int t = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + (live ? row : 0) * d);

  uint4 v[VEC_CHUNKS];
#pragma unroll
  for (int i = 0; i < VEC_CHUNKS; ++i) {
    const int c = t + i * tpr;
    v[i] = live && c < chunks ? __ldg(xr + c) : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VEC_CHUNKS; ++i) {
    float f[V];
    rowops::chunk_to_f<T>(v[i], f);
#pragma unroll
    for (int j = 0; j < V; ++j) ss = fmaf(f[j], f[j], ss);
  }
  ss = rowops::row_reduce(ss, scratch, tpr, rowops::Sum{}, 0.f);
  const float inv = 1.f / sqrtf(ss / (float)d + eps);
  if (!live) return;

  uint4* yr = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < VEC_CHUNKS; ++i) {
    const int c = t + i * tpr;
    if (c < chunks) {
      float f[V], g[V];
      rowops::chunk_to_f<T>(v[i], f);
      rowops::load_f<W, V>(w + (long long)c * V, g);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = f[j] * inv * g[j];
      yr[c] = rowops::f_to_chunk<T>(f);
    }
  }
}

template <typename T, typename W>
int launch(bool vec, const void* x, const void* w, void* out, int rows,
           int d, float eps, cudaStream_t stream) {
  if (!vec) {
    const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    rms_norm_kernel<T, W><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(out), rows, d, eps);
    return (int)cudaGetLastError();
  }
  constexpr int V = rowops::kVec<T>;
  if (d % V != 0 || d / V > 1024 * VEC_CHUNKS || !rowops::aligned16(x) ||
      !rowops::aligned16(w) || !rowops::aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int tpr = rowops::threads_per_row(d / V, VEC_CHUNKS);
  const int threads = tpr > VEC_BLOCK ? tpr : VEC_BLOCK;
  const int per_block = threads / tpr;
  const int blocks = (int)(((long long)rows + per_block - 1) / per_block);
  rms_norm_vec_kernel<T, W><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), rows, d, tpr, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(bool vec, const void* x, const void* w, void* out, int w_dtype,
             int rows, int d, float eps, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch<T, __nv_bfloat16>(vec, x, w, out, rows, d, eps, stream);
  if (w_dtype == 1)
    return launch<T, float>(vec, x, w, out, rows, d, eps, stream);
  if (w_dtype == 2)
    return launch<T, __half>(vec, x, w, out, rows, d, eps, stream);
  return (int)cudaErrorInvalidValue;
}

int dispatch(bool vec, const void* x, const void* w, void* out, int x_dtype,
             int w_dtype, int rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_w<__nv_bfloat16>(vec, x, w, out, w_dtype, rows, d, eps,
                                   st);
  if (x_dtype == 1)
    return launch_w<float>(vec, x, w, out, w_dtype, rows, d, eps, st);
  if (x_dtype == 2)
    return launch_w<__half>(vec, x, w, out, w_dtype, rows, d, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). Dtype codes for x (and out) and for
// w: 0 = bf16, 1 = fp32, 2 = fp16; x (rows, d) and w (d,) contiguous.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int kts_rms_norm(const void* x, const void* w, void* out,
                            int x_dtype, int w_dtype, int rows, int d,
                            float eps, void* stream) {
  return dispatch(false, x, w, out, x_dtype, w_dtype, rows, d, eps, stream);
}

// The vector route: as kts_rms_norm, and further x, w and out on
// 16-byte boundaries, d a multiple of a 16-byte chunk of x's dtype and
// a row at most 128 KB; cudaErrorInvalidValue otherwise.
extern "C" int kts_rms_norm_vec(const void* x, const void* w, void* out,
                                int x_dtype, int w_dtype, int rows, int d,
                                float eps, void* stream) {
  return dispatch(true, x, w, out, x_dtype, w_dtype, rows, d, eps, stream);
}
