// Paged attention (decode), split across the KV sequence, for NVIDIA
// Hopper (sm_90a), CUDA C++: the "split_kv" route.
//
// Replaces: kind_tpu_sim/ops/pallas_kernels.py:paged_attention (the
// Pallas TPU kernel launched by pl.pallas_call at :651), as
// csrc/paged_attention.cu (the "one_pass" route, kept for fp32 and for
// what 16-byte copies cannot read) does. Same function: one query
// token per slot attends over that slot's paged KV prefix, read
// through its block table with no gathered view in device memory,
// returning the unnormalised fp32 softmax partials (acc, m, l) that
// models/paged.py merges with the chunk-buffer and in-flight groups.
// The mask multiplies p, so a zero-length slot gives exactly l = 0,
// acc = 0, m = -1e30; table entries past a slot's live blocks are never
// read, so padding may point at any block. All sums are fp32.
//
// What bounds it on this card: device-memory bytes. Each live KV
// position is read once (k and v, head_dim bf16 values for each kv
// head) and meets g <= 8 query rows: ~4 flops per pair of bytes, some
// 70x below the ~295 flops a byte at which Hopper turns compute-bound.
// The tensor cores are not the lever: a product of 4 query rows
// against a 64-row tile fills 4 of wgmma's 64 rows, and the CUDA cores
// already do the arithmetic faster than the bytes arrive. The lever is
// keeping enough bytes in flight on enough SMs.
//
// Design (flash-decoding over the block table):
// - Grid (split, kv head, slot). A split covers a fixed run of
//   `blocks_per_split` table entries; the wrapper picks the run from
//   the table width and the block size alone (never from `lengths`,
//   which lives on the card): one 64-row tile at least, at most 512
//   splits. At the serving shape (8 slots x 4 kv heads, width 8) that
//   is one pool block a split, 256 blocks for 132 SMs; longer splits
//   were no faster at any measured shape.
//   A split that starts past its slot's length writes the empty
//   partial (m = -1e30, l = 0, acc = 0), takes its ticket (below) and
//   exits.
// - Copies: a split's live positions go through shared memory in tiles
//   of 64 rows. Every thread issues 16-byte cp.async.cg copies (rows
//   strided by kv * head_dim in the pool; each row's pool block from
//   the split's table entries, loaded once into shared memory), K and V
//   as two commit groups, so V lands while QK and the softmax run. A
//   split of several tiles double-buffers: tile t + 1's copies are
//   issued before tile t is computed. No thread walks positions with
//   one dependent global load a step. Rows are padded to an odd number
//   of 16-byte chunks, so a warp reading one chunk of 32 rows, or 8
//   chunks of one row, meets no bank conflict.
// - Scores: one thread per (row, half of the query group) holds a dot
//   product for each of its queries, q broadcast from shared memory;
//   every K byte is read once for the whole GQA group. Softmax: one
//   warp per query row, an online softmax across the split's tiles.
//   PV: each thread owns one 8-column chunk and a fixed subset of
//   rows; the subsets are summed in a fixed order at the end.
// - Combine: with more than one split, the per-split (acc, m, l) go
//   to an fp32 scratch the wrapper allocates. Each block then takes a
//   ticket for its (slot, kv head) (an integer atomic); the last of
//   the slot's splits to finish reduces all of them in split order
//   0, 1, 2, ... into the output partials and resets the ticket:
//   m = max m_s, l = sum l_s exp(m_s - m), acc = sum acc_s exp(m_s - m).
//   Which block combines varies; the order of the sums does not, and
//   there are no float atomics: two calls give the same bits. One
//   kernel, one launch. An empty split has l_s = 0 and acc_s = 0, so it
//   adds exactly 0; an all-empty slot comes out as m = -1e30, l = 0,
//   acc = 0.
//
// Measured result: PERF.md section 6 (chip_smoke.py on the H100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;      // positions a tile
constexpr int G_MAX = 8;      // query heads per kv head
constexpr int HD_MAX = 256;   // head dim, a multiple of 8
constexpr int P_STRIDE = G_MAX;  // floats a row of p_s
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block
constexpr int MAX_SPLITS = 512;  // the combine's m and l fit in 32 KB
constexpr float NEG = -1e30f;  // the reference's mask value, not -inf

// Dynamic shared memory: the K/V tile ring (reused for the row-group
// sums after the last tile, then for the combine's m and l), q in
// fp32, the scores / p of one tile, and the split's live table
// entries, each part on a 16-byte boundary. The wrapper mirrors this
// (split_layout).
struct Layout {
  size_t q_off, p_off, tbl_off, total;
};

__host__ __device__ inline Layout layout(int g, int hd, int stages,
                                         int bps, int n_splits) {
  const size_t chunks = hd / 8, stride = chunks | 1;
  const size_t ring = (size_t)stages * 2 * TILE * stride * 16;
  const size_t sums = (size_t)(THREADS / chunks) * g * hd * 4;
  // m and l, rounded up so that q stays on a 16-byte boundary
  const size_t combine = ((size_t)n_splits * g * 2 * 4 + 15) / 16 * 16;
  Layout L;
  L.q_off = ring > sums ? ring : sums;
  L.q_off = L.q_off > combine ? L.q_off : combine;
  L.p_off = L.q_off + (size_t)g * hd * 4;
  L.tbl_off = L.p_off + (size_t)TILE * P_STRIDE * 4;
  L.total = L.tbl_off + ((size_t)bps * 4 + 15) / 16 * 16;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 bf16 (one 16-byte chunk) to fp32, exactly
__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Called by the whole block once its split's partial is written (to
// the scratch rows of acc_p / m_p / l_p). The last of the n_splits
// blocks of (slot, kv head) `sh` to call it reduces every split's
// partial in split order into acc / m / l and sets the ticket back to
// 0 for the next call on this stream.
__device__ __forceinline__ void combine_if_last(
    const float* acc_p, const float* m_p, const float* l_p, float* acc,
    float* m, float* l, unsigned* tickets, long long sh, int g, int hd,
    int n_splits, float* ml_s) {
  __shared__ unsigned last_s;
  __threadfence();  // this block's partial is visible on the whole card
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(tickets + sh, 1u) == (unsigned)n_splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();  // and so are the other splits' partials, here

  float* w_s = ml_s;  // the splits' m, then exp(m_s - m), in place
  float* lp_s = ml_s + n_splits * g;
  const long long row0 = sh * g, prow0 = sh * n_splits * g;
  const int tid = threadIdx.x;
  for (int i = tid; i < n_splits * g; i += THREADS) {
    w_s[i] = __ldcg(m_p + prow0 + i);
    lp_s[i] = __ldcg(l_p + prow0 + i);
  }
  __syncthreads();
  if (tid < g) {
    float mx = NEG;
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, w_s[s * g + tid]);
    float lsum = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = expf(w_s[s * g + tid] - mx);
      w_s[s * g + tid] = w;
      lsum = fmaf(lp_s[s * g + tid], w, lsum);
    }
    m[row0 + tid] = mx;
    l[row0 + tid] = lsum;
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += THREADS) {
    const int gi = i / hd;
    const float* src = acc_p + prow0 * hd + i;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s)
      a = fmaf(__ldcg(src + (long long)s * g * hd), w_s[s * g + gi], a);
    acc[row0 * hd + i] = a;
  }
  if (tid == 0) tickets[sh] = 0;
}

// One block per (split, kv head, slot): the partial (acc, m, l) of the
// split's live positions, written at row ((slot*kv + h)*n_splits +
// split)*G of acc_p / m_p / l_p (the outputs themselves when there is
// one split, the scratch otherwise), then the combine of the slot's
// splits by the last of its blocks.
template <int G>
__global__ void __launch_bounds__(THREADS)
paged_attention_split_kernel(const __nv_bfloat16* __restrict__ qg,
                             const __nv_bfloat16* __restrict__ k_pool,
                             const __nv_bfloat16* __restrict__ v_pool,
                             const int* __restrict__ tables,
                             const int* __restrict__ lengths,
                             float* acc_p, float* m_p, float* l_p,
                             float* acc, float* m, float* l,
                             unsigned* __restrict__ tickets, int kv,
                             int hd, int bsz, int width, int bps,
                             int n_splits, int stages, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(G, hd, stages, bps, n_splits);
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float* sums_s = reinterpret_cast<float*>(smem);  // after the last tile
  float* q_s = reinterpret_cast<float*>(smem + L.q_off);
  float* p_s = reinterpret_cast<float*>(smem + L.p_off);
  int* tbl_s = reinterpret_cast<int*>(smem + L.tbl_off);
  __shared__ float m_s[G], l_s[G], corr_s[G];

  const int split = blockIdx.x, h = blockIdx.y, slot = blockIdx.z;
  const int tid = threadIdx.x;
  const int chunks = hd / 8, stride = chunks | 1;
  const long long sh = (long long)slot * kv + h;
  const long long row0 = sh * G;  // first q row
  const long long prow = (sh * n_splits + split) * G;
  const int len = lengths[slot];
  const long long start = (long long)split * bps * bsz;

  if (start >= len) {  // wholly past the slot's length: the empty partial
    for (int i = tid; i < G * hd; i += THREADS) acc_p[prow * hd + i] = 0.f;
    if (tid < G) {
      m_p[prow + tid] = NEG;
      l_p[prow + tid] = 0.f;
    }
    if (n_splits > 1)
      combine_if_last(acc_p, m_p, l_p, acc, m, l, tickets, sh, G, hd,
                      n_splits, reinterpret_cast<float*>(smem));
    return;
  }
  // the last split may hold fewer than bps entries (width % bps)
  const int n_own = min(bps, width - split * bps);
  const int n_pos = (int)min((long long)n_own * bsz, len - start);
  const int n_tiles = (n_pos + TILE - 1) / TILE;
  const int n_ent = (n_pos + bsz - 1) / bsz;  // live entries only

  for (int i = tid; i < n_ent; i += THREADS)
    tbl_s[i] = tables[(long long)slot * width + (long long)split * bps + i];
  for (int i = tid; i < G * hd; i += THREADS)
    q_s[i] = __bfloat162float(qg[row0 * hd + i]);
  if (tid < G) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // Copy and PV ownership: an 8-column chunk and the rows rg, rg + nrg,
  // ... of each tile (every (row, chunk) pair has one owner).
  const int nrg = THREADS / chunks;
  const int rg = tid / chunks, cpv = tid - rg * chunks;
  const bool pv_on = rg < nrg;
  // pool block and row of position p, without a division where bsz is
  // a power of two
  const int bsz_shift = (bsz & (bsz - 1)) ? -1 : __ffs(bsz) - 1;
  auto row_offset = [&](int p) {
    const int e = bsz_shift >= 0 ? p >> bsz_shift : p / bsz;
    const long long pb = tbl_s[e];
    return ((pb * bsz + (p - e * bsz)) * kv + h) * hd + cpv * 8;
  };

  // tile t's live K rows, then its V rows, into stage t % stages: two
  // commit groups
  auto issue = [&](int t) {
    uint4* k_s = ring + (size_t)(t % stages) * 2 * TILE * stride;
    const int base = t * TILE;
    const int rows = min(TILE, n_pos - base);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __nv_bfloat16* pool = half ? v_pool : k_pool;
      uint4* dst = k_s + half * TILE * stride + cpv;
      if (pv_on)
        for (int r = rg; r < rows; r += nrg)
          cp_async16(dst + r * stride, pool + row_offset(base + r));
      cp_async_commit();
    }
  };

  float pv[G][8];  // this thread's PV columns
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < 8; ++j) pv[gi][j] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    const bool next = t + 1 < n_tiles;
    if (next) issue(t + 1);  // its stage was freed by tile t - 1
    const uint4* k_s = ring + (size_t)(t % stages) * 2 * TILE * stride;
    const uint4* v_s = k_s + TILE * stride;
    const int rows = min(TILE, n_pos - t * TILE);

    // K of tile t has landed (V of t and tile t + 1 may be in flight)
    if (next)
      cp_async_wait<3>();
    else
      cp_async_wait<1>();
    __syncthreads();

    // scores: thread (row r, query parity qh)
    {
      const int r = tid % TILE, qh = tid / TILE;
      constexpr int GH = (G + 1) / 2;
      if (r < rows) {
        float dot[GH];
#pragma unroll
        for (int j = 0; j < GH; ++j) dot[j] = 0.f;
        const uint4* krow = k_s + r * stride;
        for (int c = 0; c < chunks; ++c) {
          float kf[8];
          unpack8(krow[c], kf);
#pragma unroll
          for (int j = 0; j < GH; ++j) {
            const int gi = 2 * j + qh;
            if (gi < G) {
              const float4 qa =
                  *reinterpret_cast<const float4*>(q_s + gi * hd + c * 8);
              const float4 qb = *reinterpret_cast<const float4*>(
                  q_s + gi * hd + c * 8 + 4);
              float d = dot[j];
              d = fmaf(qa.x, kf[0], d);
              d = fmaf(qa.y, kf[1], d);
              d = fmaf(qa.z, kf[2], d);
              d = fmaf(qa.w, kf[3], d);
              d = fmaf(qb.x, kf[4], d);
              d = fmaf(qb.y, kf[5], d);
              d = fmaf(qb.z, kf[6], d);
              d = fmaf(qb.w, kf[7], d);
              dot[j] = d;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < GH; ++j) {
          const int gi = 2 * j + qh;
          if (gi < G) p_s[r * P_STRIDE + gi] = dot[j] * scale;
        }
      }
    }
    __syncthreads();

    // online softmax over the split's tiles, one warp per query row;
    // only live rows take part (the mask multiplies p: dead rows add 0)
    for (int gi = warp; gi < G; gi += WARPS) {
      float mx = NEG;
      for (int r = lane; r < rows; r += 32)
        mx = fmaxf(mx, p_s[r * P_STRIDE + gi]);
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(p_s[r * P_STRIDE + gi] - m_new);
        p_s[r * P_STRIDE + gi] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
        corr_s[gi] = corr;
      }
    }

    // V of tile t has landed
    if (next)
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    __syncthreads();

    if (pv_on) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float corr = corr_s[gi];
#pragma unroll
        for (int j = 0; j < 8; ++j) pv[gi][j] *= corr;
      }
      for (int r = rg; r < rows; r += nrg) {
        float vf[8];
        unpack8(v_s[r * stride + cpv], vf);
        const float* pr = p_s + r * P_STRIDE;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float p = pr[gi];
#pragma unroll
          for (int j = 0; j < 8; ++j) pv[gi][j] = fmaf(p, vf[j], pv[gi][j]);
        }
      }
    }
    __syncthreads();  // tile t + 2's copies, scores and p overwrite
  }

  // every copy has landed and been read: the ring holds the row-group
  // sums, added in row-group order
  if (pv_on) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float4* dst = reinterpret_cast<float4*>(
          sums_s + ((size_t)rg * G + gi) * hd + cpv * 8);
      dst[0] = make_float4(pv[gi][0], pv[gi][1], pv[gi][2], pv[gi][3]);
      dst[1] = make_float4(pv[gi][4], pv[gi][5], pv[gi][6], pv[gi][7]);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += THREADS) {
    const int gi = i / hd, c = i - gi * hd;
    float s = 0.f;
    for (int q = 0; q < nrg; ++q) s += sums_s[((size_t)q * G + gi) * hd + c];
    acc_p[prow * hd + i] = s;
  }
  if (tid < G) {
    m_p[prow + tid] = m_s[tid];
    l_p[prow + tid] = l_s[tid];
  }
  if (n_splits > 1)
    combine_if_last(acc_p, m_p, l_p, acc, m, l, tickets, sh, G, hd, n_splits,
                    sums_s);
}

template <int G>
int launch_split(const void* qg, const void* k_pool, const void* v_pool,
                 const void* tables, const void* lengths, float* acc_p,
                 float* m_p, float* l_p, float* acc, float* m, float* l,
                 unsigned* tickets, int slots, int kv, int hd, int bsz,
                 int width, int bps, int n_splits, int stages, size_t smem,
                 float scale, cudaStream_t stream) {
  auto kernel = paged_attention_split_kernel<G>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_splits, kv, slots);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qg),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      acc_p, m_p, l_p, acc, m, l, tickets, kv, hd, bsz, width, bps,
      n_splits, stages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). bf16 qg (slots, kv, g, hd) and pools
// (num_blocks, bsz, kv, hd) on 16-byte boundaries, int32 tables
// (slots, width) and lengths (slots,), fp32 outputs, all contiguous.
// With n_splits = ceil(width / blocks_per_split) > 1, `scratch` holds
// slots*kv*n_splits*g*(hd + 2) floats and `tickets` slots*kv unsigned
// ints that are 0 (and are left 0); neither is read otherwise. Launches
// one kernel on `stream` and returns its CUDA error code (0 = success).
extern "C" int kts_paged_attention_split(
    const void* qg, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* acc, void* m, void* l,
    void* scratch, void* tickets, int slots, int kv, int g, int hd, int bsz,
    int width, int blocks_per_split, float scale, void* stream) {
  const int bps = blocks_per_split;
  if (slots < 1 || slots > 65535 || kv < 1 || kv > 65535 || g < 1 ||
      g > G_MAX || hd < 8 || hd > HD_MAX || hd % 8 || bsz < 1 ||
      width < 1 || bps < 1 || bps > width ||
      (long long)bps * bsz > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int n_splits = (width + bps - 1) / bps;
  if (n_splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  const int stages = (long long)bps * bsz > TILE ? 2 : 1;
  const size_t smem = layout(g, hd, stages, bps, n_splits).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc_f = static_cast<float*>(acc);
  float* m_f = static_cast<float*>(m);
  float* l_f = static_cast<float*>(l);
  const long long rows = (long long)slots * kv * n_splits * g;
  float* acc_p = n_splits == 1 ? acc_f : static_cast<float*>(scratch);
  float* m_p = n_splits == 1 ? m_f : acc_p + rows * hd;
  float* l_p = n_splits == 1 ? l_f : m_p + rows;
  unsigned* tk = static_cast<unsigned*>(tickets);
  switch (g) {
#define KTS_SPLIT_CASE(G)                                                 \
  case G:                                                                 \
    return launch_split<G>(qg, k_pool, v_pool, tables, lengths, acc_p,    \
                           m_p, l_p, acc_f, m_f, l_f, tk, slots, kv, hd,  \
                           bsz, width, bps, n_splits, stages, smem,       \
                           scale, st);
    KTS_SPLIT_CASE(1)
    KTS_SPLIT_CASE(2)
    KTS_SPLIT_CASE(3)
    KTS_SPLIT_CASE(4)
    KTS_SPLIT_CASE(5)
    KTS_SPLIT_CASE(6)
    KTS_SPLIT_CASE(7)
    KTS_SPLIT_CASE(8)
#undef KTS_SPLIT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
