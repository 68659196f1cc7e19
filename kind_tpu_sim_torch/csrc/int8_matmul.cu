// Exact int8 x int8 -> int32 batched matrix product for NVIDIA Hopper
// (sm_90a), CUDA C++: the "dp4a" route of ops/int8_matmul.py, the first
// kernel, kept for the products the "wgmma" (csrc/int8_matmul_tc.cu)
// and "gemv" (csrc/int8_gemv.cu) routes do not take: K not a multiple of
// 16, bases or strides off 16-byte boundaries, an N-contiguous B with
// more than 40 rows of A.
//
// Replaces no Pallas kernel: the JAX package runs its W8A8 contractions
// as XLA dot_generals with preferred_element_type=int32
// (kind_tpu_sim/models/quant.py:118 in linear, :153 in readout;
// kind_tpu_sim/models/decode.py:143 and :176, the int8 cache's scores
// and values). PyTorch has no batched int8 product on CUDA (torch.bmm and
// einsum refuse int8 there; torch._int_mm is 2-D only), and a float
// GEMM of int8 values is exact only while partial sums stay under
// 2^24, which the flagship's K of 2048-8192 passes. So this kernel.
//
// C[b1, b2, i, j] = sum_k A[b1, b2, i, k] * B[b1, b2, k, j], every sum in
// int32 (|C| <= 127^2 K, exact for K < 133,000). A's rows are read with
// K contiguous; B comes in either layout, read in place: "nk" (B[j][k]
// at j*ldb + k: the embedding for the readout, the key cache for the
// scores) or "kn" (B[k][j] at k*ldb + j: the weights, the value
// cache), so neither the 64 MiB embedding nor a cache is copied or
// transposed per call. Batch strides are given per operand (a cache
// read as (b, kv, s, hd) from its (b, s, kv, hd) storage).
//
// What bounds it on this card: at decode (M = 8 rows) the bytes of B,
// each read once (16 MiB for w_up, 64 MiB for the readout: 5-20 us at
// 3.35 TB/s); at prefill (M = 8192) the operations (275 G int8 ops for
// w_up: 0.14 ms at 1979 TOPS on the tensor cores).
//
// The design is the simple one that is right: a block computes a
// 64 x 64 tile of C over K in steps of 64. Each step stages a 64 x 64
// byte tile of A and of B in shared memory, both as rows along K (the
// "kn" layout is transposed while it is staged), bytes loaded with
// neighbouring threads on neighbouring addresses and zero-filled past
// the edges (so any K, stride or alignment is taken; the zeros add
// nothing); then each of 256 threads accumulates a 4 x 4 sub-tile with
// __dp4a over 4-byte groups of K (16-row sub-tiles wholly past M are
// neither staged nor computed). When the tiles alone give too few
// blocks to fill the card (decode's M = 8), K is split across blocks
// (``splits``) and each adds its partial sums into C with atomicAdd on
// int32, which is exact and gives the same bits in any order; C must
// then hold zeros before the launch. The tensor cores (wgmma) and a
// GEMV that reads B once in 16-byte loads are the other two routes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int THREADS = 256;   // 16 x 16, each a 4 x 4 sub-tile
constexpr int LDS = BK + 4;    // shared row stride in bytes: 17 words,
                               // odd, so 16 rows fall on 16 banks

struct Params {
  const int8_t* a;
  const int8_t* b;
  int32_t* c;
  int batch2, m, n, k, splits, k_per_split;
  long long a_s1, a_s2, lda;
  long long b_s1, b_s2, ldb;
};

template <bool B_KN, bool ATOMIC>
__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(Params p) {
  __shared__ __align__(16) int8_t as[BM * LDS];
  __shared__ __align__(16) int8_t bs[BN * LDS];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int batch = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int b1 = batch / p.batch2, b2 = batch % p.batch2;
  const int8_t* a = p.a + b1 * p.a_s1 + b2 * p.a_s2;
  const int8_t* b = p.b + b1 * p.b_s1 + b2 * p.b_s2;
  const int k_begin = split * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);
  // sub-tile rows (of 16) that hold a row of A: at decode's M = 8 only
  // the first, so the block computes 16 rows, not 64 (uniform branch)
  const int m_subtiles = min(4, (p.m - m0 + 15) / 16);

  int acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int idx = tid; idx < 16 * m_subtiles * BK; idx += THREADS) {
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      as[r * LDS + c] =
          (gm < p.m && gk < k_end) ? a[gm * p.lda + gk] : int8_t(0);
    }
    for (int idx = tid; idx < BN * BK; idx += THREADS) {
      if (B_KN) {
        // n contiguous in memory: walk along n, store transposed
        const int r = idx / BN, c = idx % BN;
        const int gk = k0 + r, gn = n0 + c;
        bs[c * LDS + r] =
            (gk < k_end && gn < p.n) ? b[gk * p.ldb + gn] : int8_t(0);
      } else {
        const int r = idx / BK, c = idx % BK;
        const int gn = n0 + r, gk = k0 + c;
        bs[r * LDS + c] =
            (gn < p.n && gk < k_end) ? b[gn * p.ldb + gk] : int8_t(0);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      int av[4], bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const int*>(&bs[(tx + 16 * j) * LDS + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= m_subtiles) break;
        av[i] = *reinterpret_cast<const int*>(&as[(ty + 16 * i) * LDS + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  int32_t* c = p.c + (long long)batch * p.m * p.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= p.n) continue;
      int32_t* dst = c + (long long)gm * p.n + gn;
      if (ATOMIC)
        atomicAdd(dst, acc[i][j]);
      else
        *dst = acc[i][j];
    }
  }
}

}  // namespace

// C (batch1, batch2, m, n) int32, contiguous, = A @ B. A's element
// (b1, b2, i, k) is at a + b1*a_s1 + b2*a_s2 + i*lda + k; B's (b1, b2,
// k, j) at b + b1*b_s1 + b2*b_s2 + j*ldb + k when b_kn is 0, or
// + k*ldb + j when b_kn is 1. With splits > 1 the K range is cut into
// that many runs (k_per_split each, a multiple of 64) whose partial
// sums are added into C atomically: C must hold zeros. Returns the
// CUDA error of the launch (cudaErrorInvalidValue for bad sizes).
extern "C" int kts_int8_matmul(const void* a, const void* b, void* c,
                               int batch1, int batch2, int m, int n, int k,
                               long long a_s1, long long a_s2, long long lda,
                               long long b_s1, long long b_s2,
                               long long ldb, int b_kn, int splits,
                               int k_per_split, void* stream) {
  if (batch1 < 1 || batch2 < 1 || m < 1 || n < 1 || k < 1 || splits < 1 ||
      k_per_split < 1 || k_per_split % BK != 0 ||
      (long long)splits * k_per_split < k ||
      (long long)batch1 * batch2 * splits > 65535 ||
      (m + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  Params p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
           static_cast<int32_t*>(c), batch2, m, n, k, splits, k_per_split,
           a_s1, a_s2, lda, b_s1, b_s2, ldb};
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch1 * batch2 * splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_kn) {
    if (splits > 1)
      int8_matmul_kernel<true, true><<<grid, THREADS, 0, s>>>(p);
    else
      int8_matmul_kernel<true, false><<<grid, THREADS, 0, s>>>(p);
  } else {
    if (splits > 1)
      int8_matmul_kernel<false, true><<<grid, THREADS, 0, s>>>(p);
    else
      int8_matmul_kernel<false, false><<<grid, THREADS, 0, s>>>(p);
  }
  return cudaGetLastError();
}
