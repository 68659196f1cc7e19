// Matrix product C = A @ B for NVIDIA Hopper (sm_90a), CUDA C++.
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
// time is the tensor cores' 0.28 ms.
//
// Two routes; ops/toolchain.py picks one from dtype, shape and
// alignment before the launch (never after a failure):
//
// * Tensor cores (kts_matmul_tc): bf16 A and B whose row strides and
//   base addresses are multiples of 16 bytes, which TMA needs. One
//   block owns a 128 x 256 tile of C and walks k in steps of 64 over a
//   4-stage ring of tiles in shared memory (48 KB a stage). One
//   producer warp keeps TMA loads in flight, each stage completing on
//   its own mbarrier (A's 128 x 64 tile, K-major; B's 64 x 256 tile as
//   four 64 x 64 boxes, N contiguous); two consumer warpgroups of 64
//   rows each run wgmma m64n256k16 on the stages that have arrived,
//   reading B MN-major through the descriptor's transpose bit, keep one
//   k step's products in flight and hand each stage back through an
//   "empty" mbarrier. The fp32 sums (128 registers a thread) never
//   leave registers; the epilogue writes them straight to C, masked at
//   the ragged edge (TMA reads zeros past it). ptxas gives a block of 9
//   warps 168 registers a thread (as it would 12); the consumers fit, so
//   they need no setmaxnreg.
// * CUDA cores (kts_matmul): fp32, and bf16 that TMA cannot describe.
//   The first version, kept as it was: one block owns a 128 x 128
//   output tile and loops over k in steps of 8; A's 128 x 8 and B's
//   8 x 128 slices are staged in shared memory as fp32 (bf16 widened on
//   load; A stored k-major with a padded row so neither the stores nor
//   the reads conflict on banks), and each of the 256 threads
//   accumulates an 8 x 8 patch of C with fp32 FMAs, strided by 16 rows
//   and 16 columns so a warp's reads of B and its stores of C touch
//   consecutive addresses. Edges are masked, so any m, n, k is taken.
//   fp32 stays here on purpose: TF32 keeps about three digits, and the
//   gate holds the fp32 product to 2e-4 against numpy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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


// ---------------------------------------------------------------------
// the tensor-core route

namespace tc {

constexpr int BM = 128;                     // rows of C per block
constexpr int BN = 256;                     // columns of C per block
constexpr int BK = 64;                      // k per stage: one 128-byte row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                // warpgroups, 64 rows each
constexpr int THREADS = 128 * CONSUMERS + 32;  // + the producer warp
constexpr int A_BYTES = BM * BK * 2;        // 16 KB, K-major
constexpr int B_BYTES = BK * BN * 2;        // 32 KB: BN / 64 boxes
constexpr int B_BOX_BYTES = BK * 64 * 2;    // one 64 x 64 box of B
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment

__global__ void __launch_bounds__(THREADS, 1)
matmul_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 float* __restrict__ c, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  // swizzled tiles start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023))
                              & 1023);

  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_tiles = (k + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {
    // producer: one thread keeps the ring full
    if (threadIdx.x % 32 == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) hopper::mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* a_s = smem + s * STAGE_BYTES;
        uint8_t* b_s = a_s + A_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        hopper::tma_load_2d(a_s, &map_a, &full[s], kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(b_s + j * B_BOX_BYTES, &map_b, &full[s],
                              n0 + 64 * j, kt * BK);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t a_addr =
        hopper::smem_addr(smem + s * STAGE_BYTES) + wg * 64 * 128;
    const uint32_t b_addr = hopper::smem_addr(smem + s * STAGE_BYTES + A_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_m64n256k16_ss<1>(
          acc, hopper::desc_sw128(a_addr + 32 * kk, 16, 1024),
          hopper::desc_sw128(b_addr + 16 * 128 * kk, B_BOX_BYTES, 1024), 1);
    hopper::wgmma_commit();
    // the previous stage's products are done: hand it back
    hopper::wgmma_wait<1>();
    if (kt > 0 && tid == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  const int lane = tid % 32;
  const int row0 = m0 + wg * 64 + (tid / 32) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;  // n is a multiple of 8: col + 1 < n too
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row < m && col < n)
        *reinterpret_cast<float2*>(c + (long long)row * n + col) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
  if (k % 8 || n % 8 || (reinterpret_cast<uintptr_t>(a) % 16) ||
      (reinterpret_cast<uintptr_t>(b) % 16))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides_a[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box_a[2] = {BK, BM};
  int err = hopper::encode_bf16_sw128(&map_a, a, 2, dims_a, strides_a, box_a);
  if (err) return err;
  const cuuint64_t dims_b[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t strides_b[1] = {(cuuint64_t)n * 2};
  const cuuint32_t box_b[2] = {64, BK};
  err = hopper::encode_bf16_sw128(&map_b, b, 2, dims_b, strides_b, box_b);
  if (err) return err;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  err = hopper::allow_smem((const void*)matmul_tc_kernel, SMEM_BYTES,
                           smem_set);
  if (err) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_tc_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      map_a, map_b, static_cast<float*>(c), m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C interface (bound with ctypes), the CUDA-core route. dtype of A and
// B: 0 = bf16, 1 = fp32; C is fp32; all three contiguous row-major.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int kts_matmul(const void* a, const void* b, void* c, int dtype,
                          int m, int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(a, b, c, m, n, k, st);
  if (dtype == 1) return launch<float>(a, b, c, m, n, k, st);
  return (int)cudaErrorInvalidValue;
}

// C interface, the tensor-core route: bf16 A (m, k) and B (k, n), fp32 C
// (m, n), all contiguous row-major; k and n multiples of 8 and A, B on
// 16-byte boundaries. Returns 0, a CUDA error code, or -CUresult when a
// tensor map cannot be encoded.
extern "C" int kts_matmul_tc(const void* a, const void* b, void* c, int m,
                             int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + tc::BM - 1) / tc::BM > 65535)
    return (int)cudaErrorInvalidValue;
  return tc::launch(a, b, c, m, n, k, static_cast<cudaStream_t>(stream));
}
