// Flash-attention backward on Hopper's tensor cores (sm_90a), CUDA C++:
// the dq and dk/dv kernels of the bf16 route.
//
// Replaces: kind_tpu_sim/ops/pallas_kernels.py:_flash_bwd, its dq_kernel
// (:380, pl.pallas_call at :416) and its dkv_kernel (:440, pl.pallas_call
// at :485) together with the GQA group-sum after it (:519-525). Same
// function as csrc/flash_attention_bwd.cu, the CUDA-core route kept for
// fp32 and for layouts TMA cannot read: S = (Q K^T) scale with the causal
// mask column <= row, P = exp(S - lse), dP = dO V^T, dS = P (dP - D)
// with D = rowsum(dO O) computed outside the kernels (:373-375);
// dQ = dS K scale, dV = P^T dO, dK = dS^T Q scale, dK and dV summed over
// each GQA group in fp32 before the one cast.
//
// What bounds them on this card: at the training shape (q (8, 1024, 16,
// 128) over k/v (8, 1024, 4, 128), bf16, causal) dq does three products
// and dk/dv four over the 67.2M live (row, col) pairs: 51.6 and 68.8
// GFLOP against ~0.12 GB of inputs and outputs each, so the operations
// bound both (0.052 and 0.070 ms at 989 TFLOP/s bf16). The first
// kernels multiplied on the CUDA cores at ~12 TFLOP/s; here every
// product is a wgmma, every operand tile comes by TMA, and only the
// elementwise work (P, dS, masks) runs on the CUDA cores, in registers.
//
// * dq: one block per (q tile of 64 rows, q head, batch): one consumer
//   warpgroup and one producer warp. TMA brings the Q and dO tiles in
//   once, then the K and V tiles of 64 kv rows through a 2-stage ring up
//   to the causal limit, K and V each on its own mbarrier. S = Q K^T and
//   dP = dO V^T run on wgmma with both operands in shared memory (K and
//   V are K-major: d contiguous), issued back to back; P =
//   exp2(S scale log2(e) - lse log2(e)) is computed in the S registers
//   while dP is in flight; dS = P (dP - D) is then rounded to bf16 in
//   place: the fp32 accumulator's layout is the register A fragment's,
//   as in the forward, so dQ += dS K takes dS from registers and reads
//   K MN-major through the transpose bit. dQ is scaled and cast once at
//   the end. The longest causal q tiles are scheduled first.
// * dk/dv: one block per (kv tile of 64 rows, kv head, batch), in the
//   FlashAttention-3 form: one consumer warpgroup and one producer warp.
//   TMA brings the K and V tiles in once, then, for each q head of the
//   GQA group and each q tile of 64 rows from the causal start, the Q
//   and dO tiles and their lse and D rows (1D maps over the flat
//   (b, h, t) fp32 arrays) through a 2-stage ring. S^T = K Q^T and
//   dP^T = V dO^T put the kv rows on wgmma's M dimension, so P^T and
//   dS^T come out of the accumulators as register A fragments for
//   dV += P^T dO and dK += dS^T Q, which read dO and Q MN-major. The
//   group is summed in the fp32 accumulators and dK and dV are written
//   once. Under causal, kv tile 0 meets every q tile and the last kv
//   tile one: the grid runs from the first kv tiles to the last, so the
//   heavy blocks start first and the light ones fill in behind them.
//
// Masking is explicit, as in the CUDA-core kernels: a row or column that
// TMA zero-filled gives S = 0, not -1e30, and P = exp(-lse) != 0, so
// columns at or past s get P = 0 in dq, q rows at or past t get P = 0 in
// dk/dv, and the causal diagonal tile is masked. Tiles wholly on the
// masked side of the diagonal are never loaded.
//
// Numerics: the reference keeps P and dS in fp32 (:398-410, :459-475);
// here, as in FlashAttention-2 and -3, the products take P and dS rounded
// to bf16 (about 2^-9 relative), while S, dP, D and every sum stay fp32.
// No atomics: each output element is summed by one thread in a fixed
// order, so both kernels are deterministic.
//
// Registers and tiles: a dk/dv consumer holds dK and dV (64 x 128 fp32
// each: 128 registers a thread) plus S^T and dP^T (64 more) at its peak.
// Two consumer warpgroups a block (288 threads) get only 168 registers
// a thread from ptxas, as a 384-thread block would: in trial builds
// dk/dv spilled there and ran far slower, and setmaxnreg from a
// producer warpgroup left ptxas's allocation as it was. One consumer
// warpgroup may hold 255: dk/dv fits with no spills, one block an SM.
// dq needs ~160, so two of its blocks share an SM, which in trials ran
// faster than one block of two warpgroups. So both kernels have one
// consumer warpgroup of 64 rows a block. ptxas's counts are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int TILE = 64;    // rows of every q, kv, dO tile
constexpr int STAGES = 2;   // ring depth
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, t, h;  // element strides; the head dim is contiguous
};

// one consumer warpgroup (its 64 rows resident) and one producer warp
constexpr int THREADS = 128 + 32;

template <int DPAD>
struct Shape {
  static constexpr int CHUNKS = DPAD / 64;                // 128-byte boxes
  static constexpr int TILE_BYTES = CHUNKS * TILE * 128;  // one tile
  // dq: Q and dO resident, K and V streamed
  static constexpr int DQ_SMEM = (2 + STAGES * 2) * TILE_BYTES + 1024;
  // dk/dv: K and V resident; Q, dO, lse and D streamed
  static constexpr int DKV_SMEM =
      2 * TILE_BYTES + STAGES * 2 * (TILE_BYTES + TILE * 4) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the k16 step kk's A fragment is the accumulator's columns
// 16 kk .. 16 kk + 15: x[8 kk .. 8 kk + 7], as bf16 pairs
__device__ __forceinline__ void pack_fragment(uint32_t (&a)[4],
                                              const float* x) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
}

// pin the A fragments before the wgmma.fence that orders them
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// acc (64 x 64) = A B^T for A (64 x DPAD) at `a` and B (64 x DPAD) at
// `b`, both K-major tiles of DPAD / 64 column boxes of 64 rows
template <int DPAD>
__device__ __forceinline__ void mma_abt(float (&acc)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DPAD / 16; ++kk) {
    const int c = kk / 4, off = 32 * (kk % 4);
    hopper::wgmma_m64n64k16_ss<0>(
        acc, hopper::desc_sw128(a + c * TILE * 128 + off, 16, 1024),
        hopper::desc_sw128(b + c * TILE * 128 + off, 16, 1024), 1);
  }
}

// acc (64 x DPAD) += A B for A (64 x 64) in register fragments and B
// (64 x DPAD) at `b`, a streamed tile read MN-major (its rows are the
// k dimension)
template <int DPAD>
__device__ __forceinline__ void mma_rs(float (&acc)[DPAD / 2],
                                       const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc =
        hopper::desc_sw128(b + 16 * 128 * kk, TILE * 128, 1024);
    if constexpr (DPAD == 128)
      hopper::wgmma_m64n128k16_rs<1>(acc, a[kk], desc, 1);
    else
      hopper::wgmma_m64n64k16_rs<1>(acc, a[kk], desc, 1);
  }
}

template <int DPAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_g,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       __nv_bfloat16* __restrict__ dq, int b, int t, int s,
                       int h, int group, int d, Strides os, float scale,
                       int causal) {
  using S = Shape<DPAD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t qg_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023))
                              & 1023);
  uint8_t* q_s = smem;                            // Q
  uint8_t* g_s = q_s + S::TILE_BYTES;             // dO
  uint8_t* k_s = g_s + S::TILE_BYTES;             // STAGES K tiles
  uint8_t* v_s = k_s + STAGES * S::TILE_BYTES;    // STAGES V tiles

  // longest causal q tiles first: the tile index runs backwards over
  // the grid, heads and batches fastest
  const int n_qt = (t + TILE - 1) / TILE;
  const int qt = n_qt - 1 - (int)blockIdx.x / (h * b);
  const int hi = (int)blockIdx.x % h;
  const int bi = (int)blockIdx.x / h % b;
  const int q0 = qt * TILE;
  // causal: column <= row, so nothing past this tile's last row is live
  const int kv_end = causal ? min(s, min(t, q0 + TILE)) : s;
  const int n_kv = (kv_end + TILE - 1) / TILE;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&qg_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&empty[i], 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // producer: Q and dO once, then K and V tiles through the ring
    if (threadIdx.x % 32 == 0) {
      const int kvh = hi / group;
      hopper::mbar_arrive_expect_tx(&qg_full, 2 * S::TILE_BYTES);
#pragma unroll
      for (int c = 0; c < S::CHUNKS; ++c) {
        hopper::tma_load_4d(q_s + c * TILE * 128, &map_q, &qg_full, 64 * c,
                            hi, q0, bi);
        hopper::tma_load_4d(g_s + c * TILE * 128, &map_g, &qg_full, 64 * c,
                            hi, q0, bi);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) hopper::mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        uint8_t* kt = k_s + st * S::TILE_BYTES;
        uint8_t* vt = v_s + st * S::TILE_BYTES;
        hopper::mbar_arrive_expect_tx(&k_full[st], S::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < S::CHUNKS; ++c)
          hopper::tma_load_4d(kt + c * TILE * 128, &map_k, &k_full[st],
                              64 * c, kvh, it * TILE, bi);
        hopper::mbar_arrive_expect_tx(&v_full[st], S::TILE_BYTES);
#pragma unroll
        for (int c = 0; c < S::CHUNKS; ++c)
          hopper::tma_load_4d(vt + c * TILE * 128, &map_v, &v_full[st],
                              64 * c, kvh, it * TILE, bi);
      }
    }
    return;
  }

  // the consumer warpgroup owns q rows q0 .. q0 + 63
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row_a = q0 + (tid / 32) * 16 + lane / 4;  // and row_a + 8
  const int col_lane = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;  // scores in base-2 units
  const uint32_t q_addr = hopper::smem_addr(q_s);
  const uint32_t g_addr = hopper::smem_addr(g_s);

  // lse (base 2) and D of this thread's two rows
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const long long at = ((long long)bi * h + hi) * t + row;
    lse2[r] = row < t ? lse[at] * LOG2E : 0.f;
    dd[r] = row < t ? dsum[at] : 0.f;
  }

  float acc[DPAD / 2];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(&qg_full, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int st = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int k0 = it * TILE;
    const uint32_t k_addr = hopper::smem_addr(k_s + st * S::TILE_BYTES);
    const uint32_t v_addr = hopper::smem_addr(v_s + st * S::TILE_BYTES);

    // S = Q K^T and dP = dO V^T, 64 x TILE each in fp32
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::mbar_wait(&k_full[st], phase);
    hopper::wgmma_fence();
    mma_abt<DPAD>(sc, q_addr, k_addr);
    hopper::wgmma_commit();
    hopper::mbar_wait(&v_full[st], phase);
    mma_abt<DPAD>(dp, g_addr, v_addr);
    hopper::wgmma_commit();

    // P = exp(S scale - lse) while dP is in flight; 0 where masked
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
    // only the diagonal tile and the ragged s edge hold masked columns
    const bool need_mask = k0 + TILE > s || (causal && k0 == q0);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float p = exp2f(sc[4 * j + e] * scale2 - lse2[r]);
        if (need_mask) {
          const int col = k0 + 8 * j + col_lane + (e & 1);
          if (col >= s || (causal && col > row_a + 8 * r)) p = 0.f;
        }
        sc[4 * j + e] = p;
      }
    }

    // dS = P (dP - D), rounded to bf16 as the A fragments of dQ += dS K
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = sc[8 * kk + e] * (dp[8 * kk + e] - dd[(e / 2) % 2]);
      pack_fragment(da[kk], x);
    }
    fence_frags(da);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    mma_rs<DPAD>(acc, da, k_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (tid == 0) hopper::mbar_arrive(&empty[st]);
  }

  // dq = acc scale in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= t) continue;
    __nv_bfloat16* orow = dq + bi * os.b + row * os.t + hi * os.h;
#pragma unroll
    for (int j = 0; j < DPAD / 8; ++j) {
      const int col = 8 * j + col_lane;  // d is a multiple of 16
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                  acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

template <int DPAD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_g,
                        const __grid_constant__ CUtensorMap map_lse,
                        const __grid_constant__ CUtensorMap map_dsum,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int b, int t, int s,
                        int h, int kv, int d, Strides dks, Strides dvs,
                        float scale, int causal) {
  using S = Shape<DPAD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t kv_full, q_full[STAGES], g_full[STAGES], empty[STAGES];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023))
                              & 1023);
  uint8_t* k_s = smem;                            // K
  uint8_t* v_s = k_s + S::TILE_BYTES;             // V
  uint8_t* q_s = v_s + S::TILE_BYTES;             // STAGES Q tiles
  uint8_t* g_s = q_s + STAGES * S::TILE_BYTES;    // STAGES dO tiles
  float* lse_s = reinterpret_cast<float*>(g_s + STAGES * S::TILE_BYTES);
  float* d_s = lse_s + STAGES * TILE;             // STAGES x TILE each

  // the first kv tiles, which see the most q tiles under causal, first:
  // the tile index runs forwards over the grid, heads and batches fastest
  const int group = h / kv;
  const int kt = (int)blockIdx.x / (kv * b);
  const int kvh = (int)blockIdx.x % kv;
  const int bi = (int)blockIdx.x / kv % b;
  const int k0 = kt * TILE;
  // causal: q tiles wholly before row k0 see none of this block's rows
  const int q_first = causal ? kt : 0;
  const int n_live = max(0, (t + TILE - 1) / TILE - q_first);
  const int n_it = group * n_live;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&g_full[i], 1);
      // each consumer warp hands the stage back after its lse / D reads
      hopper::mbar_init(&empty[i], 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // producer: K and V once, then per (q head, q tile) Q with its lse
    // rows and dO with its D rows through the ring
    if (threadIdx.x % 32 == 0) {
      hopper::mbar_arrive_expect_tx(&kv_full, 2 * S::TILE_BYTES);
#pragma unroll
      for (int c = 0; c < S::CHUNKS; ++c) {
        hopper::tma_load_4d(k_s + c * TILE * 128, &map_k, &kv_full, 64 * c,
                            kvh, k0, bi);
        hopper::tma_load_4d(v_s + c * TILE * 128, &map_v, &kv_full, 64 * c,
                            kvh, k0, bi);
      }
      for (int it = 0; it < n_it; ++it) {
        const int hq = kvh * group + it / n_live;
        const int q0 = (q_first + it % n_live) * TILE;
        const int row0 = (bi * h + hq) * t + q0;  // into the (b, h, t) rows
        const int st = it % STAGES;
        if (it >= STAGES) hopper::mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        uint8_t* qt = q_s + st * S::TILE_BYTES;
        uint8_t* gt = g_s + st * S::TILE_BYTES;
        hopper::mbar_arrive_expect_tx(&q_full[st], S::TILE_BYTES + TILE * 4);
#pragma unroll
        for (int c = 0; c < S::CHUNKS; ++c)
          hopper::tma_load_4d(qt + c * TILE * 128, &map_q, &q_full[st],
                              64 * c, hq, q0, bi);
        hopper::tma_load_1d(lse_s + st * TILE, &map_lse, &q_full[st], row0);
        hopper::mbar_arrive_expect_tx(&g_full[st], S::TILE_BYTES + TILE * 4);
#pragma unroll
        for (int c = 0; c < S::CHUNKS; ++c)
          hopper::tma_load_4d(gt + c * TILE * 128, &map_g, &g_full[st],
                              64 * c, hq, q0, bi);
        hopper::tma_load_1d(d_s + st * TILE, &map_dsum, &g_full[st], row0);
      }
    }
    return;
  }

  // the consumer warpgroup owns kv rows k0 .. k0 + 63
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int kv_a = k0 + (tid / 32) * 16 + lane / 4;  // and kv_a + 8
  const int col_lane = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  const uint32_t k_addr = hopper::smem_addr(k_s);
  const uint32_t v_addr = hopper::smem_addr(v_s);

  float dk_acc[DPAD / 2], dv_acc[DPAD / 2];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(&kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int q0 = (q_first + it % n_live) * TILE;
    const uint32_t q_addr = hopper::smem_addr(q_s + st * S::TILE_BYTES);
    const uint32_t g_addr = hopper::smem_addr(g_s + st * S::TILE_BYTES);
    const float* lse_t = lse_s + st * TILE;
    const float* d_t = d_s + st * TILE;

    // S^T = K Q^T and dP^T = V dO^T: TILE kv rows x TILE q columns in fp32
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::mbar_wait(&q_full[st], phase);
    hopper::wgmma_fence();
    mma_abt<DPAD>(sc, k_addr, q_addr);
    hopper::wgmma_commit();
    hopper::mbar_wait(&g_full[st], phase);
    mma_abt<DPAD>(dp, v_addr, g_addr);
    hopper::wgmma_commit();

    // P^T = exp(S^T scale - lse of each q column) while dP^T is in
    // flight; 0 for q rows at or past t and above the causal diagonal
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
    const bool need_mask = q0 + TILE > t || (causal && q0 == k0);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j +
                                                        col_lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(sc[4 * j + e] * scale2 - (e & 1 ? l.y : l.x) * LOG2E);
        if (need_mask) {
          const int col = q0 + 8 * j + col_lane + (e & 1);
          if (col >= t || (causal && kv_a + 8 * (e / 2) > col)) p = 0.f;
        }
        sc[4 * j + e] = p;
      }
    }

    // dS^T = P^T (dP^T - D of each q column); P^T and dS^T rounded to
    // bf16 as the A fragments of dV += P^T dO and dK += dS^T Q
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // this step's columns: 16 kk + col_lane + {0, 1} (x[0..3]) and
      // 16 kk + 8 + col_lane + {0, 1} (x[4..7])
      const float2 d0 = *reinterpret_cast<const float2*>(d_t + 16 * kk +
                                                         col_lane);
      const float2 d1 = *reinterpret_cast<const float2*>(d_t + 16 * kk + 8 +
                                                         col_lane);
      const float dcol[4] = {d0.x, d0.y, d1.x, d1.y};
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = sc[8 * kk + e] *
               (dp[8 * kk + e] - dcol[2 * (e / 4) + (e & 1)]);
      pack_fragment(pa[kk], sc + 8 * kk);
      pack_fragment(da[kk], x);
    }
    fence_frags(pa);
    fence_frags(da);
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
    mma_rs<DPAD>(dv_acc, pa, g_addr);
    mma_rs<DPAD>(dk_acc, da, q_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // dk = dk_acc scale and dv = dv_acc in bf16, once, group summed
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv_a + 8 * r;
    if (row >= s) continue;
    __nv_bfloat16* krow = dk + bi * dks.b + row * dks.t + kvh * dks.h;
    __nv_bfloat16* vrow = dv + bi * dvs.b + row * dvs.t + kvh * dvs.h;
#pragma unroll
    for (int j = 0; j < DPAD / 8; ++j) {
      const int col = 8 * j + col_lane;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(krow + col) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * r] * scale,
                                  dk_acc[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r],
                                  dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// host

struct Args {
  const void *q, *k, *v, *g, *lse, *dsum;
  void *out0, *out1;  // dq; or dk and dv
  int b, t, s, h, kv, d;
  Strides qs, ks, vs, gs, os0, os1;
  float scale;
  int causal;
  cudaStream_t stream;
};

// a (b, rows, heads, d) input in boxes of TILE rows
inline int encode(CUtensorMap* map, const void* base, const Args& a,
                  int heads, int rows, Strides st) {
  return hopper::encode_heads(map, base, a.d, heads, rows, a.b, st.b, st.t,
                              st.h, TILE);
}

inline int grid_size(long long blocks, unsigned* out) {
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  *out = (unsigned)blocks;
  return 0;
}

template <int DPAD>
int launch_dq(const Args& a) {
  using S = Shape<DPAD>;
  CUtensorMap map_q, map_k, map_v, map_g;
  int err = encode(&map_q, a.q, a, a.h, a.t, a.qs);
  if (!err) err = encode(&map_g, a.g, a, a.h, a.t, a.gs);
  if (!err) err = encode(&map_k, a.k, a, a.kv, a.s, a.ks);
  if (!err) err = encode(&map_v, a.v, a, a.kv, a.s, a.vs);
  if (err) return err;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  err = hopper::allow_smem((const void*)flash_bwd_dq_tc_kernel<DPAD>,
                           S::DQ_SMEM, smem_set);
  unsigned blocks = 0;
  if (!err)
    err = grid_size((long long)((a.t + TILE - 1) / TILE) * a.h * a.b, &blocks);
  if (err) return err;
  flash_bwd_dq_tc_kernel<DPAD><<<blocks, THREADS, S::DQ_SMEM, a.stream>>>(
      map_q, map_k, map_v, map_g, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dsum), static_cast<__nv_bfloat16*>(a.out0),
      a.b, a.t, a.s, a.h, a.h / a.kv, a.d, a.os0, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int DPAD>
int launch_dkv(const Args& a) {
  using S = Shape<DPAD>;
  CUtensorMap map_q, map_k, map_v, map_g, map_lse, map_dsum;
  const cuuint64_t rows = (cuuint64_t)a.b * a.h * a.t;
  int err = encode(&map_q, a.q, a, a.h, a.t, a.qs);
  if (!err) err = encode(&map_g, a.g, a, a.h, a.t, a.gs);
  if (!err) err = encode(&map_k, a.k, a, a.kv, a.s, a.ks);
  if (!err) err = encode(&map_v, a.v, a, a.kv, a.s, a.vs);
  if (!err) err = hopper::encode_f32_1d(&map_lse, a.lse, rows, TILE);
  if (!err) err = hopper::encode_f32_1d(&map_dsum, a.dsum, rows, TILE);
  if (err) return err;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  err = hopper::allow_smem((const void*)flash_bwd_dkv_tc_kernel<DPAD>,
                           S::DKV_SMEM, smem_set);
  unsigned blocks = 0;
  if (!err)
    err = grid_size((long long)((a.s + TILE - 1) / TILE) * a.kv * a.b,
                    &blocks);
  if (err) return err;
  flash_bwd_dkv_tc_kernel<DPAD><<<blocks, THREADS, S::DKV_SMEM, a.stream>>>(
      map_q, map_k, map_v, map_g, map_lse, map_dsum,
      static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1),
      a.b, a.t, a.s, a.h, a.kv, a.d, a.os0, a.os1, a.scale, a.causal);
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int t, int s, int h, int kv, int d) {
  return b < 1 || t < 1 || s < 1 || kv < 1 || h % kv != 0 || d < 16 ||
         d > 128 || d % 16 != 0 || (long long)b * h * t > 0x7fffffff;
}

}  // namespace

// C interface (bound with ctypes), the tensor-core route: bf16 only (q,
// k, v, g and the outputs), d a multiple of 16 up to 128, the bases of
// q, k, v and g and the strides of their axes longer than one on 16-byte
// boundaries; lse and dsum (b, h, t) fp32, contiguous, 16-byte aligned.
// Strides in elements for the batch, sequence and head axes. Each
// returns 0, a CUDA error code, or -CUresult when a tensor map cannot be
// encoded.
extern "C" int kts_flash_attention_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* dsum, void* dq, int b, int t, int s, int h,
    int kv, int d, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long g_sb, long long g_st,
    long long g_sh, long long o_sb, long long o_st, long long o_sh,
    float scale, int causal, void* stream) {
  if (bad_shape(b, t, s, h, kv, d)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, g, lse, dsum, dq, nullptr, b, t, s, h, kv, d,
               {q_sb, q_st, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {g_sb, g_st, g_sh}, {o_sb, o_st, o_sh}, {0, 0, 0}, scale,
               causal, static_cast<cudaStream_t>(stream)};
  return d <= 64 ? launch_dq<64>(a) : launch_dq<128>(a);
}

extern "C" int kts_flash_attention_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* dsum, void* dk, void* dv, int b, int t,
    int s, int h, int kv, int d, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long g_sb,
    long long g_st, long long g_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, void* stream) {
  if (bad_shape(b, t, s, h, kv, d)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, g, lse, dsum, dk, dv, b, t, s, h, kv, d,
               {q_sb, q_st, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {g_sb, g_st, g_sh}, {dk_sb, dk_ss, dk_sh},
               {dv_sb, dv_ss, dv_sh}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return d <= 64 ? launch_dkv<64>(a) : launch_dkv<128>(a);
}
