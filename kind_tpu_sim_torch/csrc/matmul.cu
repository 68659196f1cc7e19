// Tiled matrix product C = A @ B for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: kind_tpu_sim/ops/pallas_kernels.py:matmul (the Pallas TPU
// kernel launched by pl.pallas_call at :65). Same function: A (m, k)
// times B (k, n), both fp32 or both bf16, into an fp32 C (m, n) with
// every product accumulated in fp32.
//
// What bounds it on this card: operations. At the shape chip_smoke.py
// times (8192 x 2048 @ 2048 x 8192, bf16 in, fp32 out) the product is
// 275 GFLOP against 336 MB of operands and output: ~820 flops a byte,
// far above the ~295 at which Hopper turns compute-bound, so the least
// time is the tensor cores' 0.28 ms. This first version multiplies on
// the fp32 CUDA cores (67 TFLOP/s peak), so it cannot come near that.
//
// Design: the TPU kernel walks a sequential (m, n, k) grid and keeps
// the output block resident across the k steps. Here one thread block
// owns a 128 x 128 output tile and loops over k itself in steps of 8;
// the tile's sum never leaves registers. Each step stages A's 128 x 8
// and B's 8 x 128 slices in shared memory as fp32 (bf16 widened on
// load; A stored k-major with a padded row so neither the stores nor
// the reads conflict on banks), and each of the 256 threads accumulates
// an 8 x 8 patch of C with fp32 FMAs: 64 multiply-adds for every 16
// shared-memory reads. The patch is strided by 16 rows and 16 columns,
// so a warp's reads of B and its stores of C touch consecutive
// addresses. Edges are masked in the kernel (out-of-range loads are 0,
// out-of-range stores skipped), so any m, n, k is taken. mma.sync,
// then wgmma fed by TMA, are the levers for the PR that makes it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 8;          // k per shared-memory stage
constexpr int TM = 8;          // rows of C per thread
constexpr int TN = 8;          // columns of C per thread
constexpr int THREADS = 256;   // 16 x 16 threads, each TM x TN
constexpr int LDA = BM + 4;    // padded k-major row of the A stage

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              float* __restrict__ c, int m, int n, int k) {
  __shared__ float a_s[BK][LDA];  // a_s[kk][row]
  __shared__ float b_s[BK][BN];   // b_s[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % 16;        // column group
  const int ty = tid / 16;        // row group
  const long long row0 = (long long)blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const long long gr = row0 + r;
      const int gk = k0 + kk;
      a_s[kk][r] = (gr < m && gk < k) ? to_f(a[gr * k + gk]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int kk = idx / BN, cc = idx % BN;
      const int gk = k0 + kk;
      const long long gc = col0 + cc;
      b_s[kk][cc] = (gk < k && gc < n) ? to_f(b[(long long)gk * n + gc])
                                        : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float af[TM], bf[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) af[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bf[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the next stage overwrites a_s and b_s
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gr = row0 + ty + 16 * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long gc = col0 + tx + 16 * j;
      if (gc < n) c[gr * n + gc] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(c), m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). dtype of A and B: 0 = bf16, 1 = fp32;
// C is fp32; all three contiguous row-major. Returns the CUDA error code
// of the launch (0 = success).
extern "C" int kts_matmul(const void* a, const void* b, void* c, int dtype,
                          int m, int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(a, b, c, m, n, k, st);
  if (dtype == 1) return launch<float>(a, b, c, m, n, k, st);
  return (int)cudaErrorInvalidValue;
}
