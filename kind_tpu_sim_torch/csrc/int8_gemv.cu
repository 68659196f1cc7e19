// Exact int8 x int8 -> int32 products with few rows of A, for Hopper
// (sm_90a), CUDA C++: the "gemv" route of ops/int8_matmul.py.
//
// Replaces no Pallas kernel: the JAX package runs its W8A8 contractions
// as XLA dot_generals with preferred_element_type=int32
// (kind_tpu_sim/models/quant.py:118 in linear, :153 in readout;
// kind_tpu_sim/models/decode.py:143 and :176, the int8 cache's scores
// and values). This route takes them at decode: M = 8 rows a step at
// the flagship (4 for a cache product's query group), up to 40 for a
// verify window's 8 slots x (k + 1) rows.
//
// What bounds it on this card: bytes. A decode step reads each weight
// byte once for 8 rows: w_up is 16 MiB (5 us at 3.35 TB/s) against
// 0.27 G operations, the readout's embedding 64 MiB (20 us). The design
// reads every byte of B from device memory once, in 16-byte loads with
// neighbouring lanes on neighbouring addresses, keeps A's few rows on
// chip (staged in shared memory, K in slabs of at most 64 KB) and sums
// with __dp4a in int32. K is reduced on chip and C written once: no
// atomics in device memory, no zeroed C, one launch a call. Integer sums
// are exact, so the order of the adds changes no bit.
//
// Two layouts of B, both read in place:
// * "nk" (B[j][k] at j*ldb + k: the K-major weights, the readout's
//   embedding rows, the key cache as (b, kv, hd, s)). A warp's lanes
//   walk contiguous 16-byte runs of K (lanes of them: 32, 16 for K under
//   512, and for K under 256 (the key cache's 128) one, a lane holding
//   its columns' whole run; the rest of the warp on other columns), each
//   lane for CW columns at once so that one shared-memory load of A
//   feeds 4 x CW dp4a. warps_k warps of the block split K among them
//   where the columns alone would not give the card a block per SM. At
//   the end the lanes of a K run add their sums by xor shuffles and the
//   warps theirs in shared memory. Two blocks an SM (at most 128
//   registers a thread) walk the column tiles, so the grid is one wave
//   and A is staged once a block; the next tile's loads of B are issued
//   before a tile's sums are reduced.
// * "kn" (B[k][j] at k*ldb + j with N contiguous: the value cache read
//   as (b, kv, s, hd)). A thread loads 16 bytes along N for four
//   consecutive k, turns the 4 x 16 bytes into 16 words of four k each
//   with __byte_perm, and sums them against four rows of A at a time;
//   more rows take another pass over B (from L2: a cache's (b, kv)
//   slice is 192 KB at the flagship).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KN_ROWS = 4;     // rows of A a kn pass computes
constexpr int KN_COLS = 16;    // columns a kn thread holds: one 16-byte load
constexpr int KN_UNROLL = 4;   // kn steps whose loads are in flight at once
constexpr int MAX_SMEM = 96 * 1024;

struct Gemv {
  const int8_t* a;
  const int8_t* b;
  int32_t* c;
  int batch2, m, n, k;
  long long a_s1, a_s2, lda, b_s1, b_s2, ldb;
  int lanes;    // nk: lanes of a warp along K; kn: threads of a block along N
  int warps_k;  // nk: warps of a block along K
  int slab;     // K values of A held in shared memory at once
};

__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 ld_cached(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ int dot16(const uint4& a, const uint4& b,
                                     int acc) {
  acc = __dp4a((int)a.x, (int)b.x, acc);
  acc = __dp4a((int)a.y, (int)b.y, acc);
  acc = __dp4a((int)a.z, (int)b.z, acc);
  return __dp4a((int)a.w, (int)b.w, acc);
}

// rows [0, rows) of A's K range [0, len) (len a multiple of 16) into
// a_s[row * slab + k], in 16-byte loads
__device__ __forceinline__ void stage_a(int8_t* a_s, const int8_t* a,
                                        long long lda, int rows, int len,
                                        int slab) {
  const int chunks = len / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, ch = i % chunks;
    *reinterpret_cast<uint4*>(a_s + r * slab + 16 * ch) =
        ld_cached(a + r * lda + 16 * ch);
  }
}

__device__ __forceinline__ const int8_t* batch_base(const int8_t* p,
                                                    int batch, int batch2,
                                                    long long s1,
                                                    long long s2) {
  return p + (batch / batch2) * s1 + (batch % batch2) * s2;
}

// the U steps of B from step k0 on (K offset base + k0 + u * round) of
// the lane's CW columns, zeros past len or past N
template <int U, int CW>
__device__ __forceinline__ void load_b(uint4 (&bv)[U][CW],
                                       const int8_t* const (&bcol)[CW],
                                       const bool (&ok)[CW], int base, int k0,
                                       int len, int round) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int kk = k0 + u * round;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      bv[u][c] = (kk < len && ok[c]) ? ld_stream(bcol[c] + base + kk)
                                     : make_uint4(0, 0, 0, 0);
  }
}

// the lane's CW columns of tile `tile`: their K runs and which lie
// inside N
template <int CW>
__device__ __forceinline__ void tile_columns(const int8_t* (&bcol)[CW],
                                             bool (&ok)[CW], const int8_t* b,
                                             int first, int n,
                                             long long ldb) {
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const int col = first + c;
    ok[c] = col < n;
    bcol[c] = b + (long long)(ok[c] ? col : 0) * ldb;
  }
}

// MT: rows of A held (M <= MT); CW: columns a lane holds; U: steps whose
// loads of B are in flight at once. A block walks column tiles
// blockIdx.x, + gridDim.x, ... of one batch entry. When one slab holds
// all of K, A is staged once, after the first tile's loads are issued,
// and each next tile's first loads are issued before this tile's sums
// are reduced, so B streams while a tile ends.
template <int MT, int CW, int U>
__global__ void __launch_bounds__(THREADS, 2) gemv_nk_kernel(Gemv p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lk = p.lanes, groups = 32 / lk;
  const int cols = WARPS / p.warps_k * groups * CW;  // a tile's columns
  int* red = reinterpret_cast<int*>(smem);           // [MT][cols]
  int8_t* a_s = smem + ((MT * cols * 4 + 15) & ~15);  // [m][slab]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp % p.warps_k, wn = warp / p.warps_k;
  const int kl = lane % lk, g = lane / lk;
  const int lcol = (wn * groups + g) * CW;     // the lane's first column
  const int batch = blockIdx.y;
  const int8_t* a = batch_base(p.a, batch, p.batch2, p.a_s1, p.a_s2);
  const int8_t* b = batch_base(p.b, batch, p.batch2, p.b_s1, p.b_s2);
  int32_t* cb = p.c + (long long)batch * p.m * p.n;
  const int tiles = (p.n + cols - 1) / cols;
  const int round = p.warps_k * lk * 16;  // K one step of every warp covers
  const int k_first = (wk * lk + kl) * 16;
  const bool one_slab = p.slab >= p.k;
  const int len0 = min(p.slab, p.k);      // the first slab
  bool staged = false;
  for (int i = threadIdx.x; i < MT * cols; i += THREADS) red[i] = 0;

  const int8_t* bcol[CW];
  bool ok[CW];
  uint4 bv[U][CW];
  tile_columns(bcol, ok, b, blockIdx.x * cols + lcol, p.n, p.ldb);
  load_b(bv, bcol, ok, 0, k_first, len0, round);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile * cols;
    int acc[MT][CW];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] = 0;

    for (int s0 = 0; s0 < p.k; s0 += p.slab) {
      const int len = min(p.slab, p.k - s0);
      if (s0 > 0) load_b(bv, bcol, ok, s0, k_first, len, round);
      if (!(one_slab && staged)) {
        if (!one_slab) __syncthreads();  // the previous slab is consumed
        stage_a(a_s, a + s0, p.lda, p.m, len, p.slab);
        staged = true;
      }
      // A is staged; the previous tile's sums are read and zeroed
      __syncthreads();
      for (int k0 = k_first;;) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = k0 + u * round;
          if (kk >= len) break;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            if (i >= p.m) break;
            const uint4 av = *reinterpret_cast<const uint4*>(
                a_s + i * p.slab + kk);
#pragma unroll
            for (int c = 0; c < CW; ++c)
              acc[i][c] = dot16(av, bv[u][c], acc[i][c]);
          }
        }
        k0 += U * round;
        if (k0 >= len) break;
        load_b(bv, bcol, ok, s0, k0, len, round);
      }
    }
    if (tile + gridDim.x < tiles) {
      tile_columns(bcol, ok, b, (tile + gridDim.x) * cols + lcol, p.n,
                   p.ldb);
      load_b(bv, bcol, ok, 0, k_first, len0, round);
    }

    // the lanes of a K run, by xor shuffles; then the warps along K
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off >= lk) continue;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= p.m) break;
#pragma unroll
        for (int c = 0; c < CW; ++c)
          acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
      }
    }
    if (kl == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= p.m) break;
#pragma unroll
        for (int c = 0; c < CW; ++c)
          atomicAdd(&red[i * cols + lcol + c], acc[i][c]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < p.m * cols; i += THREADS) {
      const int r = i / cols, col = n0 + i % cols;
      if (col < p.n) cb[(long long)r * p.n + col] = red[i];
      red[i] = 0;
    }
  }
}

// word q (0..3) of a 16-byte load
__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// A block sums all of K for its 16 x lanes columns of one batch entry,
// rows 4 at a time, and writes C once.
template <int U>
__global__ void __launch_bounds__(THREADS) gemv_kn_kernel(Gemv p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tn_count = p.lanes, tk_count = THREADS / tn_count;
  const int cols = KN_COLS * tn_count;          // the block's columns
  int* red = reinterpret_cast<int*>(smem);      // [KN_ROWS][cols]
  int8_t* a_s = smem + KN_ROWS * cols * 4;      // [KN_ROWS][slab]

  const int lane = threadIdx.x % 32;
  const int tn = threadIdx.x % tn_count, tk = threadIdx.x / tn_count;
  const int n0 = blockIdx.x * cols;
  const int col = n0 + tn * KN_COLS;
  const bool ok = col < p.n;  // n is a multiple of 16: all 16 or none
  const int batch = blockIdx.y;
  const int8_t* a = batch_base(p.a, batch, p.batch2, p.a_s1, p.a_s2);
  const int8_t* bc = batch_base(p.b, batch, p.batch2, p.b_s1, p.b_s2)
                     + (ok ? col : 0);
  int32_t* cb = p.c + (long long)batch * p.m * p.n;
  const int step = tk_count * 4;                // K rows a block step covers

  for (int m0 = 0; m0 < p.m; m0 += KN_ROWS) {
    const int rows = min(KN_ROWS, p.m - m0);
    for (int i = threadIdx.x; i < KN_ROWS * cols; i += THREADS) red[i] = 0;
    int acc[KN_ROWS][KN_COLS];
#pragma unroll
    for (int i = 0; i < KN_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KN_COLS; ++j) acc[i][j] = 0;

    for (int s0 = 0; s0 < p.k; s0 += p.slab) {
      const int len = min(p.slab, p.k - s0);
      __syncthreads();  // the previous slab is consumed; red is zeroed
      stage_a(a_s, a + m0 * p.lda + s0, p.lda, rows, len, p.slab);
      __syncthreads();
      for (int k0 = tk * 4; k0 < len; k0 += U * step) {
        uint4 bv[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = k0 + u * step;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            bv[u][r] = (kk < len && ok)
                           ? ld_cached(bc + (long long)(s0 + kk + r) * p.ldb)
                           : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int kk = k0 + u * step;
          if (kk >= len) break;
          int aw[KN_ROWS];
#pragma unroll
          for (int i = 0; i < KN_ROWS; ++i)
            aw[i] = i < rows ? *reinterpret_cast<const int*>(
                                   a_s + i * p.slab + kk)
                             : 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // rows kk..kk+3, columns 4q..4q+3 -> one word a column
            const uint32_t r0 = word(bv[u][0], q), r1 = word(bv[u][1], q);
            const uint32_t r2 = word(bv[u][2], q), r3 = word(bv[u][3], q);
            const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
            const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
            const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
            const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
            const int w[4] = {(int)__byte_perm(t0, t1, 0x5410),
                              (int)__byte_perm(t0, t1, 0x7632),
                              (int)__byte_perm(t2, t3, 0x5410),
                              (int)__byte_perm(t2, t3, 0x7632)};
#pragma unroll
            for (int i = 0; i < KN_ROWS; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][4 * q + j] = __dp4a(w[j], aw[i], acc[i][4 * q + j]);
          }
        }
      }
    }

    // the threads of a column chunk: lanes tn_count apart, then the warps
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < tn_count) continue;
#pragma unroll
      for (int i = 0; i < KN_ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KN_COLS; ++j)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
    }
    if (lane < tn_count) {
#pragma unroll
      for (int i = 0; i < KN_ROWS; ++i) {
        if (i >= rows) break;
#pragma unroll
        for (int j = 0; j < KN_COLS; ++j)
          atomicAdd(&red[i * cols + tn * KN_COLS + j], acc[i][j]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
      const int r = i / cols, cc = n0 + i % cols;
      if (cc < p.n) cb[(long long)(m0 + r) * p.n + cc] = red[i];
    }
    __syncthreads();  // red is read before the next pass zeroes it
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Gemv& p, dim3 grid, int smem,
           std::atomic<bool>* smem_set, cudaStream_t stream) {
  const int err = hopper::allow_smem((const void*)kernel, MAX_SMEM, smem_set);
  if (err) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// nk: two blocks an SM walk the column tiles of each batch entry
#define KTS_GEMV_NK(MT, CW, U)                                             \
  do {                                                                     \
    static std::atomic<bool> set[hopper::MAX_DEVICES];                     \
    const int per_batch = (2 * sms + batch - 1) / batch;                   \
    return launch(gemv_nk_kernel<MT, CW, U>, p,                            \
                  dim3(tiles < per_batch ? tiles : per_batch, batch), smem, \
                  set, st);                                                \
  } while (0)

bool aligned16(long long x) { return x % 16 == 0; }

}  // namespace

// C (batch1, batch2, m, n) int32, contiguous, = A @ B for m <= 40. A's
// element (b1, b2, i, k) is at a + b1*a_s1 + b2*a_s2 + i*lda + k; B's
// (b1, b2, k, j) at b + b1*b_s1 + b2*b_s2 + j*ldb + k when b_kn is 0, or
// + k*ldb + j when b_kn is 1. The plan comes from ops/int8_matmul.py
// (gemv_plan): mt, the rows held (8, 16, 24 or 40; 4 for kn), lanes
// (nk: lanes along K, 1, 16 or 32; kn: threads along N, a power of 2 up
// to 16), warps_k (nk: 1, 2, 4 or 8), slab (K values of A staged at
// once, a multiple of 16), tiles (column tiles) and smem (bytes). Bases
// on 16-byte boundaries, k a multiple of 16, lda, ldb and the strides of
// batch axes longer than 1 multiples of 16; for kn n a multiple of 16.
// Returns 0 or a CUDA error code (cudaErrorInvalidValue for what it
// does not take).
extern "C" int kts_int8_gemv(const void* a, const void* b, void* c,
                             int batch1, int batch2, int m, int n, int k,
                             long long a_s1, long long a_s2, long long lda,
                             long long b_s1, long long b_s2, long long ldb,
                             int b_kn, int mt, int lanes, int warps_k,
                             int slab, int tiles, int smem, void* stream) {
  const int batch = batch1 * batch2;
  if (batch1 < 1 || batch2 < 1 || m < 1 || n < 1 || k < 1 || k % 16 ||
      batch > 65535 || tiles < 1 || slab < 16 || slab % 16 ||
      smem > MAX_SMEM || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || !aligned16(lda) ||
      !aligned16(ldb) || (batch1 > 1 && !(aligned16(a_s1) && aligned16(b_s1))) ||
      (batch2 > 1 && !(aligned16(a_s2) && aligned16(b_s2))))
    return (int)cudaErrorInvalidValue;
  const Gemv p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
               static_cast<int32_t*>(c), batch2, m, n, k, a_s1, a_s2, lda,
               b_s1, b_s2, ldb, lanes, warps_k, slab};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_kn) {
    if (n % 16 || lanes > 16 || mt != KN_ROWS ||
        (long long)tiles * KN_COLS * lanes < n)
      return (int)cudaErrorInvalidValue;
    static std::atomic<bool> set[hopper::MAX_DEVICES];
    return launch(gemv_kn_kernel<KN_UNROLL>, p, dim3(tiles, batch), smem,
                  set, st);
  }
  if (m > mt || warps_k < 1 || warps_k > WARPS || (warps_k & (warps_k - 1)))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = hopper::sm_count(&sms);
  if (err) return err;
  switch (mt) {
    case 8: KTS_GEMV_NK(8, 2, 4);
    case 16: KTS_GEMV_NK(16, 2, 2);
    case 24: KTS_GEMV_NK(24, 2, 2);
    case 40: KTS_GEMV_NK(40, 2, 1);
    default: return (int)cudaErrorInvalidValue;
  }
}
