// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: kind_tpu_sim/ops/pallas_kernels.py:_flash_impl (the Pallas
// TPU kernel launched by pl.pallas_call at :313; entry flash_attention
// :182). Same function: causal or full GQA attention
// softmax(Q K^T / sqrt(d)) V with an online softmax whose running max,
// denominator and accumulator stay in fp32, the denominator summing P
// before P is rounded to the value dtype for the PV product (:284-291),
// masked scores -1e30, and an optional logsumexp in natural-log units.
//
// What bounds it on this card: at the training shape (q (8, 1024, 16,
// 128) over k/v (8, 1024, 4, 128), bf16, causal) the live causal pairs
// cost 34.4 GFLOP against 84 MB of q/k/v/out: operations, 0.035 ms on
// the tensor cores. At the serving prefill (b = 1, t = 256) the 2.6 MB
// of bytes bound it (about 0.8 us), and launch latency dominates.
//
// Two routes; ops/flash_attention.py picks one from dtype, head dim,
// strides and alignment before the launch (never after a failure):
//
// * Tensor cores (kts_flash_attention_fwd_tc): bf16 with d a multiple
//   of 16 up to 128 and 16-byte aligned bases and strides. One block per
//   (q tile, head, batch): one or two consumer warpgroups of 64 q rows
//   (one where two-warpgroup tiles would leave SMs idle) and one
//   producer warp. TMA brings the Q tile in once, then the K and V
//   tiles of 64 kv rows through a 2-stage ring, each on its own mbarrier
//   so that Q K^T starts before V lands. The loads go through 4D tensor
//   maps over (d, heads, t, b) built from the element strides, so q, k
//   and v are read in place as views of the fused qkv projection; d is
//   zero-padded to 64 or 128 by TMA's out-of-bounds fill. S = Q K^T runs
//   on wgmma with both operands in shared memory (K is K-major); the
//   fp32 S accumulator, after the softmax, is rounded to bf16 and read
//   as the register A operand of O += P V (the accumulator's layout is
//   the A fragment's, as in FlashAttention-3), with V MN-major through
//   the transpose bit. The softmax works in base 2 with log2(e) / sqrt(d)
//   folded into one multiply; lse converts back to natural log. Causal:
//   kv tiles past the diagonal are never loaded, a warpgroup skips a
//   tile that lies wholly above its rows, only the diagonal tile and
//   the ragged s edge are masked, and the longest q tiles are scheduled
//   first. ptxas gives a block of 9 warps 168 registers a thread (as it
//   would 12); the consumers need at most 128, so no setmaxnreg.
// * CUDA cores (kts_flash_attention_fwd): fp32, and bf16 head dims or
//   layouts TMA cannot describe. The first version, kept as it was: a
//   loop inside the block walks the KV tiles up to the causal limit,
//   which replaces the TPU's sequential kv grid axis; Q, K and V tiles
//   are staged in shared memory as fp32 with padded rows (no bank
//   conflicts); each thread owns a 4x4 patch of the score tile and a
//   4x8 patch of the output accumulator in registers, with fp32 FMAs.
//   Inputs are read through element strides and the ragged edges (any
//   t, s; d <= 128, a multiple of 8) are masked here: no divisor search
//   as the TPU's _fit_block does. The tiny fp32 models stay exact here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 32;            // query rows per block
constexpr int BK = 64;            // kv rows per tile
constexpr int D_MAX = 128;        // largest head dim
constexpr int THREADS = 128;      // 16 (cols) x 8 (rows) thread grid
constexpr int LDQ = D_MAX + 1;    // padded fp32 row strides
constexpr int LDK = D_MAX + 1;
constexpr int LDS = BK + 1;
constexpr float NEG = -1e30f;     // the reference's mask value, not -inf

constexpr size_t SMEM_BYTES =
    sizeof(float) * (BQ * LDQ + BK * LDK + BK * D_MAX + BQ * LDS + 3 * BQ);

struct Strides {
  long long b, t, h;  // element strides; the head dim is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int t, int s, int h, int group,
                 int d, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;         // BK x LDK
  float* Vs = Ks + BK * LDK;         // BK x D_MAX
  float* Ss = Vs + BK * D_MAX;       // BQ x LDS: scores, then P
  float* m_s = Ss + BQ * LDS;        // running max per row
  float* l_s = m_s + BQ;             // running denominator per row
  float* a_s = l_s + BQ;             // this tile's rescale per row

  const int q0 = blockIdx.x * BQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + (hi / group) * ks.h;
  const T* vb = v + bi * vs.b + (hi / group) * vs.h;

  for (int idx = tid; idx < BQ * d; idx += THREADS) {
    const int r = idx / d, c = idx % d;
    const int row = q0 + r;
    Qs[r * LDQ + c] = row < t ? to_f(qb[row * qs.t + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  float acc[4][8];  // rows ty + 8 i, cols tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // causal: column <= row, so nothing past this tile's last row is live
  const int kv_end = causal ? min(s, min(t, q0 + BQ)) : s;
  __syncthreads();

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    for (int idx = tid; idx < BK * d; idx += THREADS) {
      const int r = idx / d, c = idx % d;
      const int col = k0 + r;
      const bool ok = col < s;
      Ks[r * LDK + c] = ok ? to_f(kb[col * ks.t + c]) : 0.f;
      Vs[r * D_MAX + c] = ok ? to_f(vb[col * vs.t + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 8 * i) * LDQ + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDK + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const int col = k0 + cl;
        const bool live = col < s && (!causal || col <= q0 + r);
        Ss[r * LDS + cl] = live ? sc[i][j] * scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: each warp owns BQ / 4 rows, a lane two columns
    for (int rr = 0; rr < BQ / 4; ++rr) {
      const int r = warp * (BQ / 4) + rr;
      const float x0 = Ss[r * LDS + lane];
      const float x1 = Ss[r * LDS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // the denominator sums P in fp32; the PV product takes P rounded
      // to the value dtype, as the reference kernel does
      Ss[r * LDS + lane] = to_f(from_f<T>(p0));
      Ss[r * LDS + lane + 32] = to_f(from_f<T>(p1));
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 8 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = Vs[c * D_MAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ss
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    const int row = q0 + r;
    if (row >= t) continue;
    const float l = l_s[r];
    T* orow = out + bi * os.b + row * os.t + hi * os.h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[c] = from_f<T>(acc[i][j] / l);
    }
  }
  if (lse != nullptr && tid < BQ && q0 + tid < t)
    lse[((long long)bi * h + hi) * t + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int b, int t, int s, int h, int kv, int d,
           Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t, s, h, h / kv, d, qs, ks, vs, os, scale,
      causal);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------
// the tensor-core route

namespace tc {

constexpr int BKV = 64;          // kv rows per tile
constexpr int STAGES = 2;        // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int NWG, int DPAD>
struct Shape {
  static constexpr int BQ = 64 * NWG;                // q rows per block
  static constexpr int THREADS = 128 * NWG + 32;     // + the producer warp
  static constexpr int CHUNKS = DPAD / 64;           // 128-byte column boxes
  static constexpr int Q_BYTES = CHUNKS * BQ * 128;
  static constexpr int KV_BYTES = CHUNKS * BKV * 128;  // one K or V tile
  static constexpr int SMEM_BYTES = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int NWG, int DPAD>
__global__ void __launch_bounds__(Shape<NWG, DPAD>::THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int b, int t, int s, int h, int group, int d, Strides os,
                    float scale, int causal) {
  using S = Shape<NWG, DPAD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023))
                              & 1023);
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + S::Q_BYTES;                // STAGES K tiles
  uint8_t* v_s = k_s + STAGES * S::KV_BYTES;      // STAGES V tiles

  // longest causal q tiles first: the tile index runs backwards over
  // the grid, heads and batches fastest
  const int n_qt = (t + S::BQ - 1) / S::BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x / (h * b);
  const int hi = (int)blockIdx.x % h;
  const int bi = (int)blockIdx.x / h % b;
  const int q0 = qt * S::BQ;
  const int kv_end = causal ? min(s, min(t, q0 + S::BQ)) : s;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&empty[i], NWG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // producer: Q once, then K and V tiles through the ring
    if (threadIdx.x % 32 == 0) {
      const int kvh = hi / group;
      hopper::mbar_arrive_expect_tx(&q_full, S::Q_BYTES);
#pragma unroll
      for (int c = 0; c < S::CHUNKS; ++c)
        hopper::tma_load_4d(q_s + c * S::BQ * 128, &map_q, &q_full, 64 * c,
                            hi, q0, bi);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) hopper::mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        uint8_t* kt = k_s + st * S::KV_BYTES;
        uint8_t* vt = v_s + st * S::KV_BYTES;
        hopper::mbar_arrive_expect_tx(&k_full[st], S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < S::CHUNKS; ++c)
          hopper::tma_load_4d(kt + c * BKV * 128, &map_k, &k_full[st], 64 * c,
                              kvh, it * BKV, bi);
        hopper::mbar_arrive_expect_tx(&v_full[st], S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < S::CHUNKS; ++c)
          hopper::tma_load_4d(vt + c * BKV * 128, &map_v, &v_full[st], 64 * c,
                              kvh, it * BKV, bi);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows q0 + 64 wg .. q0 + 64 wg + 63
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int wg_row0 = q0 + 64 * wg;
  const int row_a = wg_row0 + (tid / 32) * 16 + lane / 4;  // and row_a + 8
  const int col_lane = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;  // scores in base-2 units
  const uint32_t q_addr = hopper::smem_addr(q_s) + wg * 64 * 128;

  float o[DPAD / 2];
#pragma unroll
  for (int i = 0; i < DPAD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG, NEG};
  float l_run[2] = {0.f, 0.f};

  hopper::mbar_wait(&q_full, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int st = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int k0 = it * BKV;
    if (causal && k0 > wg_row0 + 63) {
      // the tile lies above every row of this warpgroup: nothing to do
      // but hand the stage back once both loads have landed
      hopper::mbar_wait(&k_full[st], phase);
      hopper::mbar_wait(&v_full[st], phase);
      if (tid == 0) hopper::mbar_arrive(&empty[st]);
      continue;
    }

    // S = Q K^T, 64 x BKV in fp32
    float sc[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
    const uint32_t k_addr = hopper::smem_addr(k_s + st * S::KV_BYTES);
    hopper::mbar_wait(&k_full[st], phase);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DPAD / 16; ++kk) {
      const int c = kk / 4, off = 32 * (kk % 4);
      hopper::wgmma_m64n64k16_ss<0>(
          sc, hopper::desc_sw128(q_addr + c * S::BQ * 128 + off, 16, 1024),
          hopper::desc_sw128(k_addr + c * BKV * 128 + off, 16, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // mask, then the online softmax over this tile; each row's values
    // lie on the four lanes of a quad
    const bool need_mask =
        k0 + BKV > s || (causal && k0 + BKV - 1 > wg_row0);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float x = sc[4 * j + e] * scale2;
        if (need_mask) {
          const int col = k0 + 8 * j + col_lane + (e & 1);
          const int row = row_a + 8 * r;
          if (col >= s || (causal && col > row)) x = NEG;
        }
        sc[4 * j + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    // P in fp32 for the denominator, rounded to bf16 for the PV product:
    // the k16 step kk's A fragment is S's columns 16 kk .. 16 kk + 15
    float sum[2] = {0.f, 0.f};
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[e] = exp2f(sc[8 * kk + e] - m_run[(e / 2) % 2]);
        sum[(e / 2) % 2] += p[e];
      }
      pa[kk][0] = pack_bf16(p[0], p[1]);
      pa[kk][1] = pack_bf16(p[2], p[3]);
      pa[kk][2] = pack_bf16(p[4], p[5]);
      pa[kk][3] = pack_bf16(p[6], p[7]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = alpha[r] * l_run[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < DPAD / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P V: V's tile is the B operand, MN-major (d contiguous)
    const uint32_t v_addr = hopper::smem_addr(v_s + st * S::KV_BYTES);
    hopper::mbar_wait(&v_full[st], phase);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t desc =
          hopper::desc_sw128(v_addr + 16 * 128 * kk, BKV * 128, 1024);
      if constexpr (DPAD == 128)
        hopper::wgmma_m64n128k16_rs<1>(o, pa[kk], desc, 1);
      else
        hopper::wgmma_m64n64k16_rs<1>(o, pa[kk], desc, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (tid == 0) hopper::mbar_arrive(&empty[st]);
  }

  // out = acc / l in bf16; lse = m + log(l) in natural-log units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= t) continue;
    const float l = l_run[r];
    __nv_bfloat16* orow = out + bi * os.b + row * os.t + hi * os.h;
#pragma unroll
    for (int j = 0; j < DPAD / 8; ++j) {
      const int col = 8 * j + col_lane;  // d is a multiple of 16
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / l,
                                  o[4 * j + 2 * r + 1] / l);
    }
    if (lse != nullptr && lane % 4 == 0)
      lse[((long long)bi * h + hi) * t + row] = m_run[r] * LN2 + logf(l);
  }
}

inline int encode_qkv(CUtensorMap* map, const void* base, int d, int heads,
                      int rows, int b, Strides st, int box_rows) {
  return hopper::encode_heads(map, base, d, heads, rows, b, st.b, st.t, st.h,
                              box_rows);
}

template <int NWG, int DPAD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int t, int s, int h, int kv, int d, Strides qs,
           Strides ks, Strides vs, Strides os, float scale, int causal,
           cudaStream_t stream) {
  using S = Shape<NWG, DPAD>;
  CUtensorMap map_q, map_k, map_v;
  int err = encode_qkv(&map_q, q, d, h, t, b, qs, S::BQ);
  if (!err) err = encode_qkv(&map_k, k, d, kv, s, b, ks, BKV);
  if (!err) err = encode_qkv(&map_v, v, d, kv, s, b, vs, BKV);
  if (err) return err;
  static std::atomic<bool> smem_set[hopper::MAX_DEVICES];
  err = hopper::allow_smem((const void*)flash_fwd_tc_kernel<NWG, DPAD>,
                           S::SMEM_BYTES, smem_set);
  if (err) return err;
  const long long blocks = (long long)((t + S::BQ - 1) / S::BQ) * h * b;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_fwd_tc_kernel<NWG, DPAD>
      <<<(unsigned)blocks, S::THREADS, S::SMEM_BYTES, stream>>>(
          map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out),
          static_cast<float*>(lse), b, t, s, h, h / kv, d, os, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// C interface (bound with ctypes), the CUDA-core route. dtype: 0 = bf16,
// 1 = fp32. Strides are in elements for the batch, sequence and head
// axes. Returns the CUDA error code of the launch (0 = success).
extern "C" int kts_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int dtype, int b, int t, int s, int h, int kv, int d, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, float scale, int causal,
    void* stream) {
  if (d > D_MAX || d % 8 != 0 || h % kv != 0 || t < 1 || s < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, out, lse, b, t, s, h, kv, d, qs,
                                 ks, vs, os, scale, causal, st);
  if (dtype == 1)
    return launch<float>(q, k, v, out, lse, b, t, s, h, kv, d, qs, ks, vs,
                         os, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

// C interface, the tensor-core route: bf16 only, d a multiple of 16 up
// to 128, the bases of q, k and v and the strides of their axes longer
// than one on 16-byte boundaries; out (b, t, h, d) bf16. Strides in
// elements. Returns 0, a CUDA error code, or -CUresult when a tensor
// map cannot be encoded.
extern "C" int kts_flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int b, int t, int s, int h, int kv, int d, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, float scale, int causal,
    void* stream) {
  if (d > 128 || d % 16 != 0 || h % kv != 0 || t < 1 || s < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one consumer warpgroup a block where two would leave SMs idle
  int sms = 0;
  const int err = hopper::sm_count(&sms);
  if (err) return err;
  const bool one = (long long)((t + 127) / 128) * h * b < sms;
  if (d <= 64)
    return one ? tc::launch<1, 64>(q, k, v, out, lse, b, t, s, h, kv, d, qs,
                                   ks, vs, os, scale, causal, st)
               : tc::launch<2, 64>(q, k, v, out, lse, b, t, s, h, kv, d, qs,
                                   ks, vs, os, scale, causal, st);
  return one ? tc::launch<1, 128>(q, k, v, out, lse, b, t, s, h, kv, d, qs,
                                  ks, vs, os, scale, causal, st)
             : tc::launch<2, 128>(q, k, v, out, lse, b, t, s, h, kv, d, qs,
                                  ks, vs, os, scale, causal, st);
}
