// Exact int8 x int8 -> int32 batched matrix product on Hopper's tensor
// cores (sm_90a), CUDA C++: the "wgmma" route of ops/int8_matmul.py.
//
// Replaces no Pallas kernel: the JAX package runs its W8A8 contractions
// as XLA dot_generals with preferred_element_type=int32
// (kind_tpu_sim/models/quant.py:118 in linear, :153 in readout;
// kind_tpu_sim/models/decode.py:143 and :176, the int8 cache's scores
// and values). This route takes the products with many rows of A: the
// prefill linears over a prompt wave (M = 8 x 1024 at the flagship),
// the admission waves, chunked prefill.
//
// What bounds it on this card: operations. Prefill's w_up (8192 x 2048
// @ 2048 x 8192) is 275 G int8 operations against 100 MB of operands
// and output: 0.139 ms at the tensor cores' 1979 TOPS, 0.030 ms of
// bytes. PR 10's kernel (csrc/int8_matmul.cu, __dp4a on the CUDA cores)
// ran it at about 38 TOPS.
//
// The design follows kts_matmul_tc (csrc/matmul.cu) byte for byte: one
// block owns a 128 x 256 tile of C and walks K in steps of 128 bytes
// (one 128-byte swizzled row: 128 int8 K values) over a 4-stage ring in
// shared memory (48 KB a stage). One producer warp keeps TMA loads in
// flight, each stage completing on its mbarrier: A's 128 x 128 tile and
// B's 256 x 128 tile, both K-major. Two consumer warpgroups of 64 rows
// each run wgmma m64n256k32 s32.s8.s8 four times a stage, keep one
// stage's products in flight and hand each stage back through an
// "empty" mbarrier. The int32 sums (128 registers a thread) never leave
// registers; the epilogue writes them straight to C, masked at the
// ragged edge (TMA reads zeros past M, N and K, which add nothing).
//
// The 8-bit wgmma forms take both operands K-major from shared memory:
// there is no transpose bit for them, and TMA copies bytes as they lie.
// So B must come with K contiguous ("nk": B[j][k] at j*ldb + k): the
// port keeps its W8A8 weights K-major (models/quant.py:quantize_params),
// the readout reads the embedding's rows in place and the key cache is
// read as (b, kv, hd, s) with hd contiguous. A "kn" B (the value cache)
// takes another route. TMA needs 16-byte-aligned bases and row and
// batch strides that are multiples of 16 bytes; ops/int8_matmul.py
// checks them before it picks this route. No .satfinite: |C| <= 127^2 K
// is exact in int32 for K < 133,000, and -128 inputs give the exact
// product too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                        // rows of C per block
constexpr int BN = 256;                        // columns of C per block
constexpr int BK = 128;                        // K per stage (bytes)
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                   // warpgroups, 64 rows each
constexpr int THREADS = 128 * CONSUMERS + 32;  // + the producer warp
constexpr int A_BYTES = BM * BK;               // 16 KB
constexpr int B_BYTES = BN * BK;               // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment

__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      int32_t* __restrict__ c, int batch2, int m, int n,
                      int k) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  // swizzled tiles start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023))
                              & 1023);

  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int batch = blockIdx.z;
  const int b1 = batch / batch2, b2 = batch % batch2;
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
        hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        hopper::tma_load_4d(a_s, &map_a, &full[s], kt * BK, m0, b2, b1);
        hopper::tma_load_4d(a_s + A_BYTES, &map_b, &full[s], kt * BK, n0, b2,
                            b1);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t a_addr =
        hopper::smem_addr(smem + s * STAGE_BYTES) + wg * 64 * 128;
    const uint32_t b_addr = hopper::smem_addr(smem + s * STAGE_BYTES + A_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      hopper::wgmma_m64n256k32_s8_ss(
          acc, hopper::desc_sw128(a_addr + 32 * kk, 16, 1024),
          hopper::desc_sw128(b_addr + 32 * kk, 16, 1024), 1);
    hopper::wgmma_commit();
    // the previous stage's products are done: hand it back
    hopper::wgmma_wait<1>();
    if (kt > 0 && tid == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  int32_t* cb = c + (long long)batch * m * n;
  const int lane = tid % 32;
  const int row0 = m0 + wg * 64 + (tid / 32) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  const bool pairs = n % 2 == 0;  // then (row, col even) is 8-byte aligned
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= m) continue;
      int32_t* dst = cb + (long long)row * n + col;
      const int lo = acc[4 * j + 2 * half], hi = acc[4 * j + 2 * half + 1];
      if (pairs && col + 1 < n) {
        *reinterpret_cast<int2*>(dst) = make_int2(lo, hi);
      } else {
        if (col < n) dst[0] = lo;
        if (col + 1 < n) dst[1] = hi;
      }
    }
  }
}

// a byte stride TMA can follow: a size-1 axis gets one past the axis
// inside it (never followed, but it must be a valid stride)
cuuint64_t batch_stride(long long stride, int size, cuuint64_t inner) {
  return size == 1 ? inner : (cuuint64_t)stride;
}

// the 4D map of an int8 operand (b1, b2, rows, k) with K contiguous, box
// 128 K values by `box_rows` rows of one batch entry
int encode_operand(CUtensorMap* map, const void* base, int k, int rows,
                   int batch2, int batch1, long long ld, long long s2,
                   long long s1, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)k, (cuuint64_t)rows,
                              (cuuint64_t)batch2, (cuuint64_t)batch1};
  const cuuint64_t st2 = batch_stride(s2, batch2, (cuuint64_t)ld * rows);
  const cuuint64_t strides[3] = {(cuuint64_t)ld, st2,
                                 batch_stride(s1, batch1, st2 * batch2)};
  const cuuint32_t box[4] = {BK, (cuuint32_t)box_rows, 1, 1};
  return hopper::encode_u8_sw128(map, base, 4, dims, strides, box);
}

bool aligned16(long long x) { return x % 16 == 0; }

}  // namespace

// C (batch1, batch2, m, n) int32, contiguous, = A @ B on the tensor
// cores. A's element (b1, b2, i, k) is at a + b1*a_s1 + b2*a_s2 + i*lda
// + k; B's (b1, b2, k, j) at b + b1*b_s1 + b2*b_s2 + j*ldb + k (K
// contiguous: the only layout an int8 wgmma reads). Bases on 16-byte
// boundaries; lda, ldb and the strides of batch axes longer than 1
// multiples of 16. Returns 0, a CUDA error code (cudaErrorInvalidValue
// for sizes or alignments it does not take), or -CUresult when a tensor
// map cannot be encoded.
extern "C" int kts_int8_matmul_tc(const void* a, const void* b, void* c,
                                  int batch1, int batch2, int m, int n, int k,
                                  long long a_s1, long long a_s2,
                                  long long lda, long long b_s1,
                                  long long b_s2, long long ldb,
                                  void* stream) {
  if (batch1 < 1 || batch2 < 1 || m < 1 || n < 1 || k < 1 ||
      (long long)batch1 * batch2 > 65535 || (m + BM - 1) / BM > 65535 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || !aligned16(lda) ||
      !aligned16(ldb) || (batch1 > 1 && !(aligned16(a_s1) && aligned16(b_s1))) ||
      (batch2 > 1 && !(aligned16(a_s2) && aligned16(b_s2))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int err = encode_operand(&map_a, a, k, m, batch2, batch1, lda, a_s2, a_s1,
                           BM);
  if (err) return err;
  err = encode_operand(&map_b, b, k, n, batch2, batch1, ldb, b_s2, b_s1, BN);
  if (err) return err;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  err = hopper::allow_smem((const void*)int8_matmul_tc_kernel, SMEM_BYTES,
                           smem_set);
  if (err) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch1 * batch2);
  int8_matmul_tc_kernel<<<grid, THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<int32_t*>(c), batch2, m, n, k);
  return (int)cudaGetLastError();
}
